"""Parity of the port's kernel plain versions (K1 resize, K2 crop, K3
decode+NMS) and their helpers with the JAX package, on the CPU.  The CUDA
kernels against these plain versions: tests/test_torch_port_kernels.py.

Tolerances (gray levels of 0..255 images):
  K1/K2 plain vs the JAX f32 functions       ≤ 1e-3 (f32 reordering)
  K1/K2 plain vs the JAX bf16 serving calls  ≤ 2    (JAX rounds weights and
                                                     intermediates to bf16)
  K3 plain vs decode_detections (A=2044, C=9) scores 1e-6, boxes 1e-4 px,
  kept rows and labels exact
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from tpudet3d.detect import decode_detections as jax_decode
from tpudet3d.detect import generate_anchors as jax_anchors
from tpudet3d.detect.assigner import iou_xyxy as jax_iou
from tpudet3d.detect.coder import CASCADE_STDS as JAX_CASCADE_STDS
from tpudet3d.detect.coder import decode_boxes as jax_decode_boxes
from tpudet3d.detect.coder import encode_boxes as jax_encode_boxes
from tpudet3d.detect.nms import greedy_nms as jax_greedy
from tpudet3d.detect.nms import soft_nms as jax_soft
from tpudet3d.infer.engine import REG_MEAN as JAX_REG_MEAN
from tpudet3d.infer.engine import REG_STD as JAX_REG_STD
from tpudet3d.ops.image import crop_and_resize as jax_crop
from tpudet3d.ops.image import resize_bilinear as jax_resize

from tpudet3d_torch.detect import nms as nms_mod
from tpudet3d_torch.detect.nms import SMEM_LIMIT as SMEM_LIMIT_K3
from tpudet3d_torch.detect.nms import (_up16, decode_nms_check,
                                       decode_nms_plan)
from tpudet3d_torch.detect import (CASCADE_STDS, decode_boxes,
                                   decode_detections,
                                   decode_detections_plain, encode_boxes,
                                   generate_anchors, greedy_nms, iou_xyxy,
                                   soft_nms)
from tpudet3d_torch.infer.engine import (REG_OFFSET, REG_SCALE,
                                         EngineConfig, TwoStageEngine)
from tpudet3d_torch.kernels.build import CSRC, SIGNATURES
from tpudet3d_torch.ops import (crop_and_resize, crop_and_resize_plain,
                                resize_bilinear, resize_bilinear_plain,
                                resize_weights)
from tpudet3d_torch.ops.image import (K1_COL_ALIGN, K2_BANDS, K2_RUN,
                                      K2_STAGE_BYTES, SMEM_LIMIT,
                                      crop_footprint, crop_passes, crop_plan,
                                      crop_stage_rows, crop_taps,
                                      resize_footprint, resize_plan,
                                      resize_windows, staged_ranges)
from tpudet3d_torch.tools.k2_bench import phase_copies
from tpudet3d_torch.tools.cases import (K1_CASES, K2_CASES, K3_CASES,
                                        K3_SETTINGS, k2_case, k3_case)
from torch_port_common import one_cpu_thread, set_no_tf32
from torch_port_inputs import (assert_dets_match, det_inputs,
                               frame_batch, random_boxes)

@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


# --- anchors, coder, IoU -------------------------------------------------

def test_anchors_match():
    np.testing.assert_array_equal(generate_anchors(), jax_anchors())
    assert generate_anchors().shape == (2044, 4)


def test_coder_matches():
    rng = np.random.RandomState(0)
    anchors = jax_anchors()
    deltas = (rng.standard_normal((2, 2044, 4)) * 2).astype(np.float32)
    deltas[0, :8, 2:] = 5.0                        # past the wh-ratio clip
    for stds in [(0.1, 0.1, 0.2, 0.2), CASCADE_STDS]:
        assert JAX_CASCADE_STDS == CASCADE_STDS
        ref = jax_decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas),
                               stds=stds)
        out = decode_boxes(torch.from_numpy(anchors),
                           torch.from_numpy(deltas), stds=stds)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-4)
        enc = encode_boxes(torch.from_numpy(anchors), out, stds=stds)
        ref_enc = jax_encode_boxes(jnp.asarray(anchors), ref, stds=stds)
        np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc),
                                   rtol=1e-4, atol=1e-4)


def test_iou_matches():
    b = random_boxes(1, 64, 100, 120)[0]
    b[5] = [3, 3, 3, 9]                                    # zero area
    ref = jax_iou(jnp.asarray(b), jnp.asarray(b))
    out = iou_xyxy(torch.from_numpy(b), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)


# --- K1 resize -------------------------------------------------------------

@pytest.mark.parametrize('hw,out_hw', [((360, 640), (300, 300)),
                                       ((720, 1280), (300, 300)),
                                       ((48, 64), (100, 120))],
                         ids=['360p', '720p', 'upscale'])
def test_k1_plain_matches_jax_f32(hw, out_hw):
    frames = frame_batch(2, *hw)
    ref = np.stack([np.asarray(jax_resize(jnp.asarray(f[..., ::-1]), out_hw,
                                          dtype=jnp.float32))
                    for f in frames])
    out = resize_bilinear_plain(torch.from_numpy(frames), out_hw,
                                reverse_channels=True)
    assert out.shape == (2, *out_hw, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)


def test_k1_plain_within_bf16_serving_call():
    frames = frame_batch(2, 360, 640, seed=1)
    ref = np.stack([np.asarray(jax_resize(jnp.asarray(f[..., ::-1]),
                                          (300, 300), dtype=jnp.bfloat16)
                               .astype(jnp.float32)) for f in frames])
    out = resize_bilinear_plain(torch.from_numpy(frames), (300, 300),
                                reverse_channels=True)
    assert np.abs(out.numpy() - ref).max() <= 2.0


def test_k1_scale_and_dtype():
    frames = torch.from_numpy(frame_batch(1, 60, 80))
    a = resize_bilinear_plain(frames, (30, 40), scale=1 / 255.0,
                              dtype=torch.bfloat16)
    b = resize_bilinear_plain(frames, (30, 40)) / 255.0
    assert a.dtype == torch.bfloat16
    np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=2 ** -8)


# --- K1's shared-memory footprint -----------------------------------------
# The kernel stages each tile's input rows and columns in shared memory and
# reads its taps from there; no CPU test could see a tap outside them.

def _assert_tiles_cover(h, w, oh, ow):
    """The plan fits in SMEM_LIMIT (or raises, when a 1-row tile does not),
    and every tile's staged rows and columns hold every input at which
    resize_weights is non-zero for the tile's outputs, each output's window
    within its tile's taps."""
    try:
        plan = resize_plan(h, w, oh, ow)
    except ValueError:
        assert resize_footprint(h, w, oh, ow, 1).smem_bytes > SMEM_LIMIT
        return
    assert plan.smem_bytes <= SMEM_LIMIT
    for n_in, n_out, tile, align, staged, taps in (
            (h, oh, plan.tile_y, 1, plan.rows, plan.taps_y),
            (w, ow, plan.tile_x, K1_COL_ALIGN, plan.cols, plan.taps_x)):
        weights = resize_weights(n_in, n_out).numpy()
        lo, hi = resize_windows(n_in, n_out)
        first, last = staged_ranges(n_in, n_out, tile, align)
        assert (last - first + 1 <= staged).all()
        assert (hi - lo + 1 <= taps).all() and (lo <= hi).all()
        idx = np.arange(n_in)
        outside = (idx < lo[:, None]) | (idx > hi[:, None])
        assert not (outside & (weights != 0)).any()
        t = np.arange(n_out) // tile
        assert (lo >= first[t]).all() and (hi <= last[t]).all()


@pytest.mark.parametrize('case', K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_tiles_cover_path_shapes(case):
    h, w = case[1]
    _assert_tiles_cover(h, w, 300, 300)
    # the path's shapes keep the 16-row tile
    assert resize_plan(h, w, 300, 300).tile_y == 16


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 4096), w=st.integers(1, 4096),
       fy=st.floats(1 / 8, 40.0), fx=st.floats(1 / 8, 40.0))
@example(h=1, w=1, fy=1.0, fx=1.0)
@example(h=1, w=4096, fy=1 / 300, fx=4096 / 300)
@example(h=2160, w=3840, fy=7.2, fx=12.8)
@example(h=4096, w=4096, fy=4096.0, fx=4096.0)
def test_k1_tiles_cover_random_shapes(h, w, fy, fx):
    oh = int(min(2048, max(1, round(h / fy))))
    ow = int(min(2048, max(1, round(w / fx))))
    _assert_tiles_cover(h, w, oh, ow)


def test_k1_plan_shrinks_then_raises():
    """4K → 300² needs 246 KB at 16 rows and runs at 8; a 4096² frame
    to one pixel fits no tile, and the wrapper's plan raises."""
    assert resize_footprint(2160, 3840, 300, 300, 16).smem_bytes > SMEM_LIMIT
    assert resize_plan(2160, 3840, 300, 300).tile_y == 8
    with pytest.raises(ValueError, match='shared memory'):
        resize_plan(4096, 4096, 1, 1)


# --- K2 crop ---------------------------------------------------------------

def _jax_crops(frames, boxes, out_hw, dtype):
    return np.concatenate([
        np.asarray(jax_crop(jnp.asarray(f[..., ::-1]), jnp.asarray(b),
                            out_hw, compute_dtype=dtype).astype(jnp.float32))
        for f, b in zip(frames, boxes)])


def test_k2_plain_matches_jax_f32():
    frames = frame_batch(2, 360, 640, seed=2)
    boxes = random_boxes(2, 12, 360, 640)
    ref = _jax_crops(frames, boxes, (64, 48), jnp.float32)
    out = crop_and_resize_plain(torch.from_numpy(frames),
                                torch.from_numpy(boxes), (64, 48),
                                reverse_channels=True)
    assert out.shape == (24, 64, 48, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)


def test_k2_plain_within_bf16_path():
    frames = frame_batch(2, 360, 640, seed=3)
    boxes = random_boxes(2, 12, 360, 640, 1)
    ref = _jax_crops(frames, boxes, (64, 64), jnp.bfloat16)
    out = crop_and_resize_plain(torch.from_numpy(frames),
                                torch.from_numpy(boxes), (64, 64),
                                reverse_channels=True)
    assert np.abs(out.numpy() - ref).max() <= 2.0


def test_k2_mirror_and_normalize():
    """The TTA mirror half and the serving normalisation (bf16 constants
    of the JAX program) against the JAX f32 crops."""
    frames = frame_batch(2, 360, 640, seed=4)
    boxes = random_boxes(2, 4, 360, 640, 2)
    crops = _jax_crops(frames, boxes, (64, 64), jnp.float32)
    inv_std = (1.0 / (np.asarray(JAX_REG_STD) * 255)).astype(np.float32)
    scale = jnp.asarray(inv_std, jnp.bfloat16)
    offset = jnp.asarray(np.asarray(JAX_REG_MEAN) * 255 * inv_std,
                         jnp.bfloat16)
    norm = np.asarray(jnp.asarray(crops) * scale - offset)
    ref = np.concatenate([norm, norm[:, :, ::-1, :]])
    out = crop_and_resize_plain(torch.from_numpy(frames),
                                torch.from_numpy(boxes), (64, 64),
                                reverse_channels=True, scale=REG_SCALE,
                                offset=REG_OFFSET, mirror=True)
    assert out.shape == (16, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3 / 50)


# --- K2's shared-memory footprint -----------------------------------------
# The kernel stages a band's source rows over the box's column span in
# shared memory, in passes of as many rows as its stage holds, and reads its
# taps from there; no CPU test could see a tap outside them.

def _align16(v):
    return (v + 15) // 16 * 16


def _assert_k2_covers(boxes, h, w, oh, ow):
    """For every box and band height: the box's column span, from the
    first column's left tap to the last column's right tap, holds every
    tapped column; a staged row at the span's stride holds the span at any
    shift in a 16-byte chunk and the kernel's three-word reads at each left
    tap (which also read the pixel right of it), and is no wider than the
    footprint's stride; the stage holds two such rows or more; each pass
    (crop_passes, the kernel's rule) stages the rows that
    crop_and_resize_plain taps for its output rows, at most two per output
    row and no more than the stage holds, and the passes take every output
    row once, in order, none across a band's end."""
    b = torch.as_tensor(boxes, dtype=torch.float32).reshape(-1, 4)
    x0, y0, x1, y1 = b.unbind(-1)
    iy0, iy1, _ = crop_taps(oh, (y1 - y0).clamp(min=1.0), y0, h)
    ix0, ix1, _ = crop_taps(ow, (x1 - x0).clamp(min=1.0), x0, w)
    for band in K2_BANDS:
        fp = crop_footprint(w, ow, band)
        assert fp.runs * K2_RUN >= ow
        for r0, r1, c0, c1 in zip(iy0.numpy(), iy1.numpy(), ix0.numpy(),
                                  ix1.numpy()):
            lo, hi = c0[0], min(c0[-1] + 1, w - 1)
            assert lo <= c0.min() and c1.max() <= hi
            assert ((c1 == c0 + 1) | (c0 == w - 1)).all()
            stride = _align16(3 * (hi - lo + 1) + 24)
            assert stride <= fp.stride
            assert 15 + 3 * (hi - lo + 1) <= stride
            assert 15 + 3 * (c0.max() - lo) + 12 <= stride
            cap = crop_stage_rows(fp, lo, hi)
            assert cap >= 2
            done = 0
            for first, rows, top, bot in crop_passes(r0, r1, band, cap):
                m = len(top)
                assert first == done and first % band + m <= band
                assert len(rows) <= min(2 * m, cap)
                np.testing.assert_array_equal(rows[top], r0[first:first + m])
                np.testing.assert_array_equal(rows[bot], r1[first:first + m])
                done += m
            assert done == oh


@pytest.mark.parametrize('case', [c[0] for c in K2_CASES])
def test_k2_footprint_covers_plain_taps(case):
    frames, boxes, (oh, ow) = k2_case(case, 'cpu')
    _assert_k2_covers(boxes, *frames.shape[1:3], oh, ow)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 2000), w=st.integers(1, 4000),
       oh=st.integers(1, 300), ow=st.integers(1, 300),
       box=st.lists(st.floats(-100.0, 4100.0, width=32), min_size=4,
                    max_size=4))
@example(h=1, w=1, oh=1, ow=1, box=[0.0, 0.0, 1.0, 1.0])
@example(h=720, w=1280, oh=224, ow=224, box=[-5.0, 0.0, 1290.0, 720.0])
@example(h=720, w=1280, oh=224, ow=224, box=[640.0, 360.0, 640.3, 360.2])
def test_k2_footprint_covers_random_boxes(h, w, oh, ow, box):
    _assert_k2_covers(np.asarray([box], np.float32), h, w, oh, ow)


def test_k2_phase_copies(tmp_path):
    """k2_bench's copies of K2 that return after a phase find their marks
    in crop.cu and each changes it."""
    src = (CSRC / 'crop.cu').read_text()
    dirs = phase_copies(str(CSRC.parents[2]), str(tmp_path))
    assert dirs == [str(tmp_path / name) for name in
                    ('p1_stage', 'p2_nostore', 'p3_storeonly')]
    for d in dirs:
        text = (tmp_path / d / 'tpudet3d_torch/kernels/csrc/crop.cu') \
            .read_text()
        assert text != src and 'crop_band_kernel' in text


def test_k2_plan_288():
    """The r288 config's serving pass (128 crops of 720p to 288²): bands of
    16 rows, 18 a crop, within the shared-memory limit."""
    fp = crop_plan(1280, 288, 288, 128, 132)
    assert fp.band == 16 and -(-288 // fp.band) == 18
    assert fp.runs == 36
    assert fp.smem_bytes == _align16(8 * 288 + 16 * 16) + K2_STAGE_BYTES


def test_k2_plan_band_and_limit():
    """The tallest band that gives each of 132 SMs two CTAs: 16 rows for
    the serving path's 128 crops, 4 for one frame's 8, 1 for one crop.  The
    stage holds K2_STAGE_BYTES, 8 whole 720p rows, until two frame rows need
    more; frames whose two rows do not fit raise, naming the limit."""
    fp = crop_plan(1280, 224, 224, 128, 132)
    assert fp.band == 16 and crop_stage_rows(fp, 0, 1279) == 8
    assert fp.smem_bytes == _align16(8 * 224 + 16 * 16) + K2_STAGE_BYTES
    assert crop_plan(1280, 224, 224, 8, 132).band == 4
    assert crop_plan(720, 224, 224, 1, 132).band == 1
    assert crop_stage_rows(crop_plan(20000, 224, 224, 128, 132), 0,
                           19999) == 2
    with pytest.raises(ValueError, match='SMEM_LIMIT'):
        crop_plan(40000, 224, 224, 128, 132)


# --- K3 decode + NMS -------------------------------------------------------

def _jax_dets(logits, deltas, **kw):
    anchors = jnp.asarray(jax_anchors())
    return np.stack([np.asarray(jax_decode(jnp.asarray(l), jnp.asarray(d),
                                           anchors, **kw))
                     for l, d in zip(logits, deltas)])


@pytest.mark.parametrize('setting', list(K3_SETTINGS))
@pytest.mark.parametrize('ties', [False, True], ids=['random', 'ties'])
def test_k3_plain_matches_jax(setting, ties):
    kw = dict(score_thr=0.02, iou_thr=0.45, max_per_img=8, pre_nms_k=32,
              **K3_SETTINGS[setting])
    logits, deltas = det_inputs(seed=5, ties=ties)
    ref = _jax_dets(logits, deltas, **kw)
    out = decode_detections_plain(torch.from_numpy(logits),
                                  torch.from_numpy(deltas),
                                  torch.from_numpy(generate_anchors()), **kw)
    assert out.shape == (2, 8, 6)
    assert_dets_match(out.numpy(), ref)


@pytest.mark.parametrize('case', ['floor0', 'recall', 'sparse', 'ties',
                                  'k256', 'jax_defaults', 'k512', 'k2044'])
def test_k3_plain_matches_jax_cases(case):
    """The K3_CASES settings the card checks, at N=2: score floor 0,
    --preset recall, background-dominant logits (zero rows padded), a tie
    run across the K-th place, K=256, the JAX defaults K=200/200, and the
    large K of max_detections 128 and 511 (K=512 and K=A=2044)."""
    logits, deltas, kw = k3_case(case, 'cpu', n=2)
    ref = _jax_dets(logits.numpy(), deltas.numpy(), **kw)
    out = decode_detections_plain(logits, deltas,
                                  torch.from_numpy(generate_anchors()), **kw)
    assert out.shape == (2, kw['max_per_img'], 6)
    assert_dets_match(out.numpy(), ref)
    if case == 'sparse':               # fewer than K candidates per class
        probs = torch.softmax(logits, -1)[..., :-1]
        assert ((probs > kw['score_thr']).sum(1) < kw['pre_nms_k']).all()


def _k3_shape(kw):
    return kw.get('pre_nms_k', 32), kw.get('max_per_img', 8)


@pytest.mark.parametrize('case', ['formula'] + [c[0] for c in K3_CASES])
def test_k3_smem_layout(case):
    """The kernel's shared memory and scratch (decode_nms_plan, which the
    C entry checks against its own layout).  'formula': the regions at
    the serving shape and where the logits no longer set region 0 (the
    decays up to K=128, then the rows, then the lists), the large-K rows
    in shared memory and in the scratch.  Each K3_CASES shape up to K=256:
    two CTAs fit an SM (228 KB, 1 KB reserved per CTA), so the 144 CTAs of
    a batch of 16 are resident at once, and no scratch.  Above K=256: one
    CTA fits (SMEM_LIMIT), and the scratch holds the bit rows where they
    would not fit, K * ceil(K/32) words per CTA (75 MB at N=16, K=2044)."""
    if case == 'formula':
        assert decode_nms_plan(2044, 9, 32, 8) == (
            (2044 + 8) // 9 * 10 * 4 + 16 + 2044 * 4 + 2 * 256 * 4 + 64 * 4
            + 32 * 60, 0)
        tail = 64 * 4 + 2048 + 256
        assert decode_nms_plan(64, 1, 128, 8) \
            == (128 * 128 * 4 + 128 * 4 * 4 + tail + 128 * 60, 0)
        assert decode_nms_plan(64, 1, 129, 8) == (2592 + tail + 129 * 60, 0)
        assert decode_nms_plan(16, 16, 256, 256) \
            == (16 * 256 * 4 + 16 * 4 + 2048 + 256 + 256 * 60, 0)
        assert decode_nms_plan(40000, 9, 32, 8)[0] > SMEM_LIMIT_K3
        tail = 2044 * 4 + 2048 + 256
        assert decode_nms_plan(2044, 9, 512, 128) == (
            512 * 16 * 4 + tail + 512 * 60, 0)
        assert decode_nms_plan(2044, 9, 2044, 511) == (
            _up16(9 * 511 * 4) + tail + 2044 * 60, 2044 * 64)
        return
    k, m = _k3_shape(next(c for c in K3_CASES if c[0] == case)[3])
    smem, scratch = decode_nms_check(16, 2044, 9, k, m)
    if k <= 256:
        assert 2 * (smem + 1024) <= 228 * 1024 and scratch == 0
    else:
        assert smem <= SMEM_LIMIT_K3
        rows = k * ((k + 31) // 32)
        assert scratch == (rows if 4 * rows + smem > SMEM_LIMIT_K3 else 0)
    if case == 'k2044':
        assert 16 * 9 * scratch * 4 == 75350016


@pytest.mark.parametrize('max_detections', [8, 64, 128, 511])
def test_k3_takes_engine_max_detections(monkeypatch, max_detections):
    """An engine's K3 settings (K = max(4 * max_detections, 32), up to
    K = A = 2044 at max_detections 511) pass the launch's argument check,
    with the C library mocked: the call it receives carries the plan's
    shared memory and, at K=2044, a scratch of N * C * K * ceil(K/32)
    words.  512 detections (K=2048 > A) is refused, naming the limit."""
    cfg = EngineConfig(max_detections=max_detections)
    kw = TwoStageEngine.decode_kwargs(SimpleNamespace(cfg=cfg))
    calls = []

    class FakeLibrary:
        def tpd_decode_nms(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(nms_mod, 'library', FakeLibrary)
    monkeypatch.setattr(nms_mod, 'stream_args', lambda t: (0, None))
    logits, deltas = map(torch.from_numpy, det_inputs(n=2))
    anchors = torch.from_numpy(generate_anchors())
    out = nms_mod._launch(logits, deltas, anchors, **kw)
    assert out.shape == (2, max_detections, 6)
    k = kw['pre_nms_k']
    smem, scratch = decode_nms_plan(2044, 9, k, max_detections)
    args = calls[0]
    assert args[5:10] == (2, 2044, 9, k, max_detections)
    assert args[16:18] == (smem, scratch)
    assert (args[4] is None) == (scratch == 0)
    with pytest.raises(ValueError, match='MAX_K'):
        nms_mod._launch(logits, deltas, anchors,
                        **dict(kw, pre_nms_k=2048, max_per_img=512))


def test_nms_units_match_jax():
    rng = np.random.RandomState(6)
    b = random_boxes(1, 32, 200, 200, seed=6)[0]
    s = np.sort(rng.uniform(0, 1, 32).astype(np.float32))[::-1].copy()
    s[-5:] = 0.0
    keep = greedy_nms(torch.from_numpy(b), torch.from_numpy(s), 0.3)
    ref = jax_greedy(jnp.asarray(b), jnp.asarray(s), 0.3)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref))
    dec = soft_nms(torch.from_numpy(b), torch.from_numpy(s), 0.5, 0.75)
    ref = jax_soft(jnp.asarray(b), jnp.asarray(s), 0.5, 0.75)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref), atol=1e-6)


# --- wrappers and the C interface -----------------------------------------

def test_wrappers_use_plain_on_cpu_without_counting():
    frames = torch.from_numpy(frame_batch(1, 40, 60))
    boxes = torch.from_numpy(random_boxes(1, 3, 40, 60))
    logits, deltas = map(torch.from_numpy, det_inputs(n=1))
    anchors = torch.from_numpy(generate_anchors())
    counts = [f.launches for f in (resize_bilinear, crop_and_resize,
                                   decode_detections)]
    assert torch.equal(resize_bilinear(frames, (20, 30)),
                       resize_bilinear_plain(frames, (20, 30)))
    assert torch.equal(crop_and_resize(frames, boxes, (8, 8)),
                       crop_and_resize_plain(frames, boxes, (8, 8)))
    assert torch.equal(
        decode_detections(logits, deltas, anchors, max_per_img=8,
                          pre_nms_k=32),
        decode_detections_plain(logits, deltas, anchors, max_per_img=8,
                                pre_nms_k=32))
    assert counts == [f.launches for f in (resize_bilinear, crop_and_resize,
                                           decode_detections)]


def test_ctypes_signatures_match_sources():
    """Every C entry declared for ctypes exists in csrc with the same
    parameter kinds (a pointer cut to 32 bits would only fail on the card)."""
    src = ''.join(p.read_text() for p in sorted(CSRC.glob('*.cu')))
    kinds = {'c_void_p': 'ptr', 'c_int': 'int', 'c_float': 'float'}
    for name, argtypes in SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(',')]
        got = ['ptr' if '*' in p else p.split()[0] for p in params]
        assert got == [kinds[t.__name__] for t in argtypes], name
