"""Inputs and checks shared by the port's kernel tests.  Imports no JAX, so
the tests of the CUDA kernels run on a machine that has only PyTorch."""

import numpy as np


def frame_batch(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)) \
        .astype(np.uint8)


def random_boxes(n, k, h, w, seed=0):
    """Boxes as the engine makes them (clipped to the frame, some thinner
    than a pixel, some on an edge) plus some reaching outside it."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-40, w, (n, k))
    y0 = rng.uniform(-40, h, (n, k))
    b = np.stack([x0, y0, x0 + rng.uniform(0.2, w / 2, (n, k)),
                  y0 + rng.uniform(0.2, h / 2, (n, k))], -1)
    b[:, : k // 2] = np.clip(b[:, : k // 2], 0, [w, h, w, h])
    b[:, 0] = [0.0, 0.0, 0.5, 0.3]                         # sub-pixel box
    b[:, 1] = [w - 30.0, h - 20.0, w, h]                   # on the far edge
    return b.astype(np.float32)


def det_inputs(n=2, seed=0, ties=False):
    """Detector logits [n,2044,10] and deltas [n,2044,4]."""
    rng = np.random.RandomState(seed)
    logits = (rng.standard_normal((n, 2044, 10)) * 2.0).astype(np.float32)
    deltas = (rng.standard_normal((n, 2044, 4)) * 0.5).astype(np.float32)
    if ties:
        # exact score ties between anchors: broken by the lower index
        logits[:, 100:140] = logits[:, 99:100]
        logits[:, 1500:1510] = logits[:, 99:100]
    return logits, deltas


def assert_dets_match(out, ref, box_atol=1e-4, score_atol=1e-6):
    """Rows with score > 0 agree: same rows, scores, boxes and labels
    (padded rows carry arbitrary boxes)."""
    for o, r in zip(out, ref):
        keep = r[:, 4] > 0
        assert keep.sum() > 0
        np.testing.assert_array_equal(o[:, 4] > 0, keep)
        np.testing.assert_allclose(o[keep, 4], r[keep, 4], rtol=0,
                                   atol=score_atol)
        np.testing.assert_allclose(o[keep, :4], r[keep, :4], rtol=0,
                                   atol=box_atol)
        np.testing.assert_array_equal(o[keep, 5], r[keep, 5])
