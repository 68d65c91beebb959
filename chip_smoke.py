#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpudet3d_torch``) on one NVIDIA
GPU: ``python3 chip_smoke.py [--out FILE]``.

Phases, each fatal on failure:

1. Build the CUDA kernels from ``tpudet3d_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card at the
   paths' shapes (K1 resize at N=1 and 16 of 720p and on every shape of
   ``K1_CASES``, K2 crop on every case of ``K2_CASES`` with TTA off and
   on, K3 decode+NMS at A=2044, C=9 on every case of ``K3_CASES`` (K up
   to 2044), K4 head epilogue on 128 crops with TTA off and on in refine
   and pack mode with bf16 logits that carry exact ties, and at 1, 127,
   129 and 128 crops also on logits with NaNs and ties across its warp
   reduction, K5 oriented-box IoU at P=1, 8, 128 and 129 on random boxes
   and on exact cases, and against scipy on 32 pairs) and time kernel, plain version and, where one exists, the
   PyTorch library call (K1 and K2 also with a cold L2 and at N=1, K2 with
   the mirror, K3 in three settings, at N=1 and on the device), and the
   launch floor (the device time of an add on one float) beside K4 and
   K5.
3. Drive the serving path at full width (MNv2-SSD-300 w1.0 + MNv3-large-21k,
   bf16, 224² crops, max_detections 8, random weights from seed 0) through
   ``infer_batch`` (16 frames), ``__call__`` and ``run_async`` /
   ``wait_and_grab``; check the outputs and that K1–K4 were launched; hold
   the path's own intermediates against the plain versions.  Then an
   engine with max_detections 128 (K3 at K=512) through ``infer_batch``,
   checked the same way.
4. Time server frames/s at batches 16 and 32 (device-resident input,
   median of 3 loops) and the blocked single-frame latency.
5. Drive the evaluation path at full width: ``objectron_eval``'s
   ``evaluate_category`` over 2 categories × 24 synthetic portrait
   1280×720 examples at batch 8, with the CLI's defaults at ``det_tresh``
   0 and with ``--preset recall``; check the reports and that K1–K5 were
   launched; re-score the same lifted predictions with the plain K5 (same
   IoUs, same report text); hold the card's float32 EPnP lift against the
   float64 host lift; time examples/s and its split.
6. Serve the flagship configuration from converted snapshots at full
   width: write a cascade MNv2-SSD-300 w1.0 and an EfficientNet-lite0
   regressor whose EMA differs from its weights (seeded) as ``snap_3.pt``
   files; ``build_engine`` on ``configs/scene_regressor_el0_ema.py``
   (serves the EMA) through ``infer_batch`` (16 frames), checked as in
   phase 3, with rows equal bit for bit to an engine of the same modules
   in memory; ``configs/scene_regressor_el0_r288.py`` (288² crops)
   through ``infer_batch``; el0 serving frames/s and latency as in phase
   4; ``tools/demo.py``'s ``run`` with the tracker over 32 720p frames of
   moving boxes (tracks kept, each result equal to ``infer_batch`` of its
   frame, frames/s, the assignment route); the ``Detector`` wrapper over
   4 frames (K1 and K3 against their plain versions).  Each of these runs
   counts every kernel's launches (K5's too) and must give exactly the
   path's own: one K1 and K3 a batch or frame, one K2 and K4 a regress
   pass, no K5.

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is unavailable or any phase fails.
"""

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from tpudet3d_torch.tools.k1_bench import launch_floor_ms
from tpudet3d_torch.tools.k2_bench import engine_like_boxes
from tpudet3d_torch.tools.k3_bench import BASE as K3_BASE
from tpudet3d_torch.tools.k3_bench import SETTINGS as K3_SETTINGS
from tpudet3d_torch.tools.k3_bench import det_batch, k3_times

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS = 67e12             # H100 SXM, non-tensor float32, published
FRAME = (720, 1280, 3)
EVAL_FRAME = (1280, 720, 3)    # portrait frames of the evaluation phase
EVAL_EXAMPLES = 24             # per category
EVAL_CLASSES = ('bike', 'book')
K4_REFINE = (1280, 720, 10.0, 0.2)     # (w, h, margin_px, edge_grow)
# float32 EPnP lift of exact box projections against the float64 lift: the
# CPU parity tests find ~1e-4 (tests/test_torch_port_box3d.py)
LIFT_TOL = 1e-3


def expect(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def time_ms(fn, iters):
    """Mean device time of ``fn`` over back-to-back calls (CUDA events,
    after one warm-up call; the L2 cache is not flushed)."""
    from tpudet3d_torch.tools.k1_bench import cycle_ms
    return cycle_ms([fn], iters)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else \
        'operations'


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def gpu_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# K1's shapes on the port's paths, resized to 300²: (name, (H, W), batch,
# frames dropped from the front).  720p serving, 1280×720 portrait
# evaluation, host_downscale 2 and 3, a batch slice frames[1:] whose base
# and rows are not 16-byte aligned, and an upscale.
K1_CASES = (('720p', (720, 1280), 2, 0), ('portrait', (1280, 720), 2, 0),
            ('360p', (360, 640), 2, 0), ('240p', (240, 426), 2, 0),
            ('slice', (239, 425), 3, 1), ('upscale', (100, 150), 2, 0))
K1_TOLS = ((torch.bfloat16, 2 ** -8), (torch.float32, 1e-5))


def k1_frames(case, dev, seed=0):
    """The uint8 frames of a K1_CASES entry on ``dev``, sliced there."""
    _, hw, n, skip = next(c for c in K1_CASES if c[0] == case)
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    return torch.from_numpy(frames).to(dev)[skip:]


def check_k1(dev, frames, ops):
    """K1 against its plain version at N=1 and 16 of 720p and on every
    K1_CASES shape; times at batch 16 of 720p → 300² bf16, warm and with a
    cold L2 (k1_bench.k1_times), and F.interpolate's."""
    from tpudet3d_torch.tools.k1_bench import k1_times, library_times
    resize_bilinear, resize_bilinear_plain, resize_weights = ops
    err = 0.0
    cases = [(f'720p N={n}', frames[:n]) for n in (1, 16)] + [
        (c[0], k1_frames(c[0], dev)) for c in K1_CASES]
    for name, f in cases:
        ref = resize_bilinear_plain(f, (300, 300), True, 1 / 255.0)
        for dtype, tol in K1_TOLS:
            e = max_err(resize_bilinear(f, (300, 300), True, 1 / 255.0,
                                        dtype), ref)
            print(f'K1 {name} {tuple(f.shape)} {dtype}: max |kernel - '
                  f'plain| = {e:.3g} (tol {tol:.3g})')
            expect(e <= tol, f'K1 {name} {dtype} disagrees: {e}')
            err = max(err, e)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [frames] + [torch.randint(0, 256, frames.shape,
                                        dtype=torch.uint8, device=dev,
                                        generator=gen) for _ in range(2)]
    times = k1_times(resize_bilinear, batches)
    times.update(library_times(batches))
    taps_y = (resize_weights(FRAME[0], 300, dev) > 0).sum()
    taps_x = (resize_weights(FRAME[1], 300, dev) > 0).sum()
    n = frames.shape[0]
    n_bytes = frames.numel() + n * 300 * 300 * 3 * 2
    n_ops = 2 * 3 * n * int(taps_y) * int(taps_x)
    print('K1 batch 16 of 720p bf16: ' + ', '.join(
        f'{k} {v}' for k, v in times.items()))
    return dict(
        err=err, **times,
        plain_ms=time_ms(lambda: resize_bilinear_plain(
            frames, (300, 300), True, 1 / 255.0, torch.bfloat16), 5),
        bound=bound_ms(n_bytes, n_ops))


def touched_pixels(boxes, h, w, out_hw):
    """Distinct source pixels that the crops of ``boxes [N,K,4]`` read."""
    mask = torch.zeros((boxes.shape[0], h, w), dtype=torch.bool,
                       device=boxes.device)
    for n in range(boxes.shape[0]):
        for x0, y0, x1, y1 in boxes[n].tolist():
            idx = []
            for lo, hi, size, size_in in ((y0, y1, out_hw[0], h),
                                          (x0, x1, out_hw[1], w)):
                side = max(hi - lo, 1.0)
                s = ((torch.arange(size, device=boxes.device) + 0.5)
                     * side / size - 0.5 + lo).clamp(0, size_in - 1)
                i0 = s.floor().long()
                idx.append(torch.cat([i0, (i0 + 1).clamp(max=size_in - 1)]))
            mask[n, idx[0][:, None], idx[1][None, :]] = True
    return int(mask.sum())


# K2's cases: (name, frames (N, H, W), boxes, output (h, w)).  'serving':
# the serving path's 128 boxes of 720p frames; 'tiny': 1-px, sub-pixel,
# empty and inverted boxes (side floored at 1 px); 'border': boxes touching
# and crossing each frame border and one wholly outside (clamp); 'full_row':
# boxes spanning the whole 1280-px row and more; 'upscale': boxes of 22 px
# and 4 px upscaled 10x and 56x to 224; 'portrait': the evaluation path's
# 1280x720 frames; 'n1': one frame; 'out64x48' and 'out62x50': output sizes
# of the CPU tests, 50 columns not a multiple of the kernel's 8-pixel runs
# and 62 rows not a multiple of its band; 'r288': the serving path of
# configs/scene_regressor_el0_r288.py (288² crops, 18 bands of 16 rows).
K2_CASES = (('serving', (16, 720, 1280), 'engine', (224, 224)),
            ('tiny', (2, 720, 1280), 'tiny', (224, 224)),
            ('border', (2, 720, 1280), 'border', (224, 224)),
            ('full_row', (2, 720, 1280), 'full_row', (224, 224)),
            ('upscale', (2, 720, 1280), 'upscale', (224, 224)),
            ('portrait', (2, 1280, 720), 'engine', (224, 224)),
            ('n1', (1, 720, 1280), 'engine', (224, 224)),
            ('out64x48', (2, 720, 1280), 'engine', (64, 48)),
            ('out62x50', (2, 720, 1280), 'border', (62, 50)),
            ('r288', (16, 720, 1280), 'engine', (288, 288)))
K2_TOLS = ((torch.bfloat16, 2 ** -7 + 1e-4), (torch.float32, 1e-4))


def k2_boxes(kind, n, h, w, seed=1):
    """Boxes [n,8,4] of a K2_CASES kind as numpy."""
    if kind == 'engine':
        return engine_like_boxes(n, 8, h, w, seed)
    rng = np.random.RandomState(seed)
    x, y = rng.uniform(0, w - 30, 8), rng.uniform(0, h - 30, 8)
    if kind == 'tiny':
        b = [[x[0], y[0], x[0] + 1, y[0] + 1],
             [x[1], y[1], x[1] + .3, y[1] + .2],
             [x[2], y[2], x[2], y[2]],
             [x[3], y[3], x[3] - 5, y[3] - 3],
             [0, 0, 1, 1], [w - 1, h - 1, w, h],
             [x[6], y[6], x[6] + 1.5, y[6] + .7],
             [x[7] + .5, y[7] + .5, x[7] + 1.25, y[7] + 3]]
    elif kind == 'border':
        b = [[0, 0, 50, 40], [-30, -20, 40, 30], [w - 50, h - 40, w, h],
             [w - 40, h - 30, w + 30, h + 20], [-10, 100, w + 10, 200],
             [100, -5, 200, h + 5], [w - 1, h - 1, w + 5, h + 5],
             [-20, -20, -5, -5]]
    elif kind == 'full_row':
        b = [[0, y[0], w, y[0] + 100], [-50, y[1], w + 50, y[1] + 300],
             [0, 0, w, h], [0, y[3], w, y[3] + 1], [0.5, 0, w - 0.5, 20],
             [0, h - 224, w, h], [-1, y[6], w + 1, y[6] + 5],
             [0, y[7], w, y[7] + 10]]
    elif kind == 'upscale':
        b = [[x[i], y[i], x[i] + 22.4, y[i] + 22.4] for i in range(6)] + [
            [x[6], y[6], x[6] + 4, y[6] + 4], [0, 0, 22.4, 22.4]]
    else:
        raise ValueError(f'unknown kind {kind!r}')
    b = np.asarray(b, np.float32)
    return np.stack([b + 3 * i * (kind not in ('border', 'full_row'))
                     for i in range(n)])


def k2_case(case, dev, seed=0):
    """The frames, boxes and output size of a K2_CASES entry on ``dev``."""
    _, (n, h, w), kind, out_hw = next(c for c in K2_CASES if c[0] == case)
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    return (torch.from_numpy(frames).to(dev),
            torch.from_numpy(k2_boxes(kind, n, h, w)).to(dev), out_hw)


def check_k2(dev, ops, norm):
    """K2 against its plain version on every K2_CASES entry with and
    without the mirror, in bf16 and f32; times at the serving shape, warm,
    cold, mirrored and at N=1 (k2_bench.k2_times), and F.grid_sample's."""
    from tpudet3d_torch.tools.k2_bench import (k2_times, library_times,
                                               serving_inputs)
    crop_and_resize, crop_and_resize_plain = ops
    err = 0.0
    for case, *_ in K2_CASES:
        frames, boxes, out_hw = k2_case(case, dev)
        for mirror in (False, True):
            args = (out_hw, True, norm[0], norm[1], mirror)
            ref = crop_and_resize_plain(frames, boxes, *args)
            for dtype, tol in K2_TOLS:
                e = max_err(crop_and_resize(frames, boxes, *args, dtype), ref)
                print(f'K2 {case} {tuple(boxes.shape)} -> {out_hw} mirror='
                      f'{mirror} {dtype}: max |kernel - plain| = {e:.3g} '
                      f'(tol {tol:.3g})')
                expect(e <= tol, f'K2 {case} mirror={mirror} {dtype} '
                       f'disagrees: {e}')
                err = max(err, e)
    batches, boxes = serving_inputs(dev)
    times = k2_times(crop_and_resize, batches, boxes, norm)
    times.update(library_times(batches, boxes))
    print('K2 128 crops of 720p to 224² bf16: ' + ', '.join(
        f'{k} {v}' for k, v in times.items()))
    n_out = boxes.shape[0] * boxes.shape[1] * 224 * 224
    n_bytes = 3 * touched_pixels(boxes, *FRAME[:2], (224, 224)) \
        + boxes.numel() * 4 + n_out * 3 * 2
    n_ops = n_out * 3 * 8
    frames = batches[0]
    # the r288 config's pass: the same 128 boxes' shape of crop at 288²
    f288, b288, hw288 = k2_case('r288', dev)
    args288 = (hw288, True, norm[0], norm[1], False, torch.bfloat16)
    times.update(
        ms_288=time_ms(lambda: crop_and_resize(f288, b288, *args288), 50),
        device_ms_288=profile_call(lambda: crop_and_resize(
            f288, b288, *args288))[1],
        bound_ms_288=bound_ms(
            3 * touched_pixels(b288, *FRAME[:2], hw288) + b288.numel() * 4
            + b288.shape[0] * b288.shape[1] * 288 * 288 * 3 * 2,
            b288.shape[0] * b288.shape[1] * 288 * 288 * 3 * 8)[0])
    return dict(
        err=err, **times,
        plain_ms=time_ms(lambda: crop_and_resize_plain(
            frames, boxes, (224, 224), True, *norm, False, torch.bfloat16),
            5),
        bound=bound_ms(n_bytes, n_ops))


def compare_dets(out, ref, what):
    """Rows with score > 0 agree (padded rows carry arbitrary boxes)."""
    keep = ref[..., 4] > 0
    expect(bool(keep.any()), f'{what}: no detection')
    expect(torch.equal(out[..., 4] > 0, keep), f'{what}: kept rows differ')
    e_s = max_err(out[..., 4][keep], ref[..., 4][keep])
    e_b = max_err(out[..., :4][keep], ref[..., :4][keep])
    expect(torch.equal(out[..., 5][keep], ref[..., 5][keep]),
           f'{what}: labels differ')
    print(f'{what}: max |kernel - plain| score {e_s:.3g} (tol 1e-6), '
          f'box {e_b:.3g} px (tol 1e-3)')
    expect(e_s <= 1e-6 and e_b <= 1e-3, f'{what} disagrees')
    return max(e_s, e_b)


# K3's cases, each on top of K3_BASE: (name, N, logits of
# k3_bench.det_batch, settings).  The serving path's greedy, soft-NMS and
# box-vote settings at N=16 and N=1; objectron_eval's floor at det_tresh 0
# and its --preset recall; background-dominant logits that leave fewer
# than K candidates per class (zero rows padded); a run of equal scores
# across the K-th place; K=256 (max_detections 64) and the JAX defaults
# (K=200, max_per_img 200), above the K up to which the kernel keeps the
# soft-NMS decays in shared memory; the kernel's large-K instantiation at
# K=512 (max_detections 128: bit rows in shared memory) and K=2044
# (max_detections 511, the most the 2044 anchors allow: bit rows in the
# device scratch).
K3_SOFT = K3_SETTINGS['soft']
K3_CASES = (('greedy', 16, 'random', {}),
            ('soft', 16, 'random', K3_SOFT),
            ('vote', 16, 'random', K3_SETTINGS['vote']),
            ('n1', 1, 'random', {}),
            ('floor0', 16, 'random', dict(score_thr=0.0)),
            ('recall', 16, 'random', dict(score_thr=0.005, **K3_SOFT)),
            ('sparse', 16, 'sparse', {}),
            ('ties', 16, 'ties', {}),
            ('k256', 16, 'random', dict(pre_nms_k=256, max_per_img=64)),
            ('k256_soft', 16, 'random', dict(pre_nms_k=256, max_per_img=64,
                                            **K3_SOFT)),
            ('jax_defaults', 16, 'random', dict(pre_nms_k=200,
                                                max_per_img=200)),
            ('jax_defaults_vote', 16, 'random', dict(
                pre_nms_k=200, max_per_img=200, box_vote_iou=0.6)),
            ('k512', 16, 'random', dict(pre_nms_k=512, max_per_img=128)),
            ('k512_soft', 16, 'random', dict(
                pre_nms_k=512, max_per_img=128, soft_nms_sigma=0.5,
                soft_nms_dup_iou=0.8)),
            ('k2044', 16, 'random', dict(pre_nms_k=2044, max_per_img=511)),
            ('k2044_vote', 16, 'random', dict(
                pre_nms_k=2044, max_per_img=511, box_vote_iou=0.6)))


def k3_case(case, dev, n=None):
    """Logits and deltas of a K3_CASES entry on ``dev`` (its first ``n``
    images, all by default) and its decode settings."""
    _, n_case, kind, kw = next(c for c in K3_CASES if c[0] == case)
    logits, deltas = det_batch(n_case, kind)
    return (torch.from_numpy(logits[:n]).to(dev),
            torch.from_numpy(deltas[:n]).to(dev), dict(K3_BASE, **kw))


def check_k3(dev, ops, anchors):
    """K3 against its plain version on every K3_CASES entry; times at
    N=16, A=2044, C=9, K=32 (k3_bench.k3_times)."""
    decode_detections, decode_detections_plain = ops
    err = 0.0
    for case, *_ in K3_CASES:
        logits, deltas, kw = k3_case(case, dev)
        err = max(err, compare_dets(
            decode_detections(logits, deltas, anchors, **kw),
            decode_detections_plain(logits, deltas, anchors, **kw),
            f'K3 {case} N={logits.shape[0]}'))
    logits, deltas, _ = k3_case('greedy', dev)
    times = k3_times(decode_detections, logits, deltas, anchors)
    print('K3 N=16 K=32: ' + ', '.join(f'{k} {v}' for k, v in times.items()))
    n_bytes = (logits.numel() + deltas.numel() + anchors.numel()
               + 16 * 8 * 6) * 4
    # softmax (sub, exp, add, div per logit), decode, and the K^2 IoUs of
    # each (image, class)
    n_ops = logits.numel() * 4 + 16 * 9 * (32 * 32 * 12 + 32 * 16)
    return dict(
        err=err, ms=times.pop('ms_greedy'), **times,
        plain_ms=time_ms(lambda: decode_detections_plain(
            logits, deltas, anchors, **K3_BASE), 3),
        library_ms=None, bound=bound_ms(n_bytes, n_ops))


def k4_inputs(b, tta, seed=0, nan_ties=False):
    """Regressor outputs for K4 over b crops as numpy: pre-activations
    [B',9,18] (every 7th crop saturated, so keypoints press against the
    crop edge), logits [B',9] exactly representable in bfloat16 with exact
    ties at the maximum (the same in a crop and its mirror), crop boxes
    [b,4] in a 720p frame and detections [b,6] (every 5th a padded row
    with score 0).  With ``nan_ties`` the logits follow K4_SPECIAL_ROWS
    instead, a crop's mirror three patterns on from the crop's own.  The
    card tests (tests/test_torch_port_kernels.py) and the CPU parity tests
    use these inputs too."""
    rng = np.random.RandomState(seed)
    b2 = 2 * b if tta else b
    pre = rng.normal(0.0, 2.0, (b2, 9, 18)).astype(np.float32)
    pre[::7] *= 8.0
    logits = rng.normal(0.0, 2.0, (b2, 9)).astype(np.float32)
    logits = torch.from_numpy(logits).bfloat16().float().numpy()
    if nan_ties:
        logits = -np.abs(logits) - 1.0
        for r in range(b2):
            pattern = K4_SPECIAL_ROWS[(r % b + 3 * (r >= b))
                                      % len(K4_SPECIAL_ROWS)]
            for c, v in pattern.items():
                logits[r, c] = v
    else:
        group = np.arange(b2) % b % 3
        logits[group == 0, 4] = logits[group == 0, 6] = 8.0
        logits[group == 1, 2] = logits[group == 1, 7] = 9.0
    w, h = K4_REFINE[:2]
    x0 = rng.uniform(-20, w, b)
    y0 = rng.uniform(-20, h, b)
    boxes = np.stack([x0, y0, x0 + rng.uniform(0.5, 400, b),
                      y0 + rng.uniform(0.5, 300, b)], -1)
    boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
    dets = np.zeros((b, 6), np.float32)
    dets[:, :4] = boxes
    dets[:, 4] = rng.uniform(0, 1, b)
    dets[::5, 4] = 0.0
    dets[:, 5] = rng.randint(0, 9, b)
    return pre, logits, boxes, dets


# K4's logit rows with NaNs and ties ({class: value} over negative logits),
# cycled over the crops: torch.argmax takes the first NaN, else the first
# maximum.  Ties sit in lanes far apart in K4's warp reduction (1 and 8,
# 2 and 7), all nine tie, -0.0 ties +0.0, and with TTA a crop and its
# mirror give inf - inf = NaN or NaN + x.
K4_SPECIAL_ROWS = (
    {c: 1.5 for c in range(9)},                      # 0: all nine tie
    {1: 4.0, 8: 4.0},                                # 1
    {6: np.nan, 3: np.nan, 0: 7.0},                  # 3: first NaN
    {8: np.nan, 0: np.inf},                          # 8: NaN beats inf
    {c: -np.inf for c in range(9)},                  # 0: all -inf
    {2: np.inf, 7: np.inf},                          # 2
    {5: -0.0, 4: 0.0},                               # 4: -0.0 == +0.0
    {8: 3.0},                                        # 8: the last class
)


def k4_error(out, ref, refine):
    """K4's output ``out`` against its plain version's ``ref``: (max error,
    whether it is within tolerance).  Refine mode: boxes within 1e-4 px;
    pack mode: keypoints within 1e-6, and boxes, scores, labels and
    conf_mask exact (the error is inf where they differ)."""
    if refine:
        e = max_err(out, ref)
        return e, e <= 1e-4
    rest = [0, 1, 2, 3, 4, 5, 24, 25]
    if not torch.equal(out[:, rest], ref[:, rest]):
        return float('inf'), False
    e = max_err(out[:, 6:24], ref[:, 6:24])
    return e, e <= 1e-6


def compare_k4(out, ref, what, refine):
    """Expects K4 within :func:`k4_error`'s tolerance; returns the error."""
    e, ok = k4_error(out, ref, refine)
    print(f'{what}: max |kernel - plain| '
          + (f'box {e:.3g} px (tol 1e-4)' if refine
             else f'kp {e:.3g} (tol 1e-6; boxes, scores, labels exact)'))
    expect(ok, f'{what} disagrees')
    return e


def profile_call(fn, calls=20):
    """Device kernels (and copies) per call of ``fn`` and their summed
    device ms per call, from ``torch.profiler`` over ``calls`` calls.  A
    kernel far shorter than a launch shows its own time here, while
    ``time_ms`` of back-to-back calls measures the host's dispatch.  A
    profiler session now and then records no device activity; it is
    repeated, and after three empty sessions both numbers are None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return (len(events) / calls, sum(
                e.time_range.elapsed_us() for e in events) / 1e3 / calls)
    return None, None


# K4's crop counts beyond the serving pass's 128: one warp's crop alone,
# and a last CTA of 3 or 1 live warps
K4_CASES = ((128, False), (1, False), (127, False), (129, False),
            (128, True), (1, True), (127, True), (129, True))


def check_k4(dev, ops):
    """K4 against its plain version on every (B, NaNs and ties) of
    K4_CASES with TTA off and on, in refine and pack mode; times the
    serving path's pass (B=128, pack, no TTA) and the launch floor."""
    head_epilogue, head_epilogue_plain = ops
    err = 0.0
    for b, nan_ties in K4_CASES:
        for tta in (False, True):
            pre, logits, boxes, dets = (torch.from_numpy(a).to(dev) for a
                                        in k4_inputs(b, tta, 4, nan_ties))
            logits = logits.bfloat16()
            for refine in (True, False):
                kw = dict(tta_w=224 if tta else 0)
                kw.update(dict(refine=K4_REFINE) if refine
                          else dict(dets=dets, det_conf=0.5))
                err = max(err, compare_k4(
                    head_epilogue(pre, logits, boxes, **kw),
                    head_epilogue_plain(pre, logits, boxes, **kw),
                    f'K4 B={b} tta={tta} nan_ties={nan_ties} '
                    f'{"refine" if refine else "pack"}', refine))
    # the serving path's last pass: TTA off, pack mode
    pre, logits, boxes, dets = (torch.from_numpy(a).to(dev)
                                for a in k4_inputs(128, False, 5))
    logits = logits.bfloat16()
    (n_k, dev_ms), (n_p, plain_dev_ms) = (
        profile_call(lambda f=f: f(pre, logits, boxes, dets=dets))
        for f in ops)
    print(f'K4 per pass (torch.profiler): kernel {n_k} launch, '
          f'{dev_ms} ms on the device; plain version {n_p} launches, '
          f'{plain_dev_ms} ms')
    return dict(
        launches_per_pass=[n_k, n_p], device_ms=dev_ms,
        plain_device_ms=plain_dev_ms,
        err=err,
        ms=time_ms(lambda: head_epilogue(pre, logits, boxes, dets=dets),
                   200),
        plain_ms=time_ms(lambda: head_epilogue_plain(pre, logits, boxes,
                                                     dets=dets), 20),
        library_ms=None, floor_ms=launch_floor_ms(dev),
        bound=bound_ms(*k4_work(boxes.shape[0], logits.shape[1],
                                logits.element_size())))


def box_kps(center, half, rot=np.eye(3)):
    """Objectron 9-keypoint box: centre, then the 8 corners in binary
    ±e1±e2±e3 order."""
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], float)
    return np.concatenate([[center], corners * half @ rot.T + center])


def rotation(angles):
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    return (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))


def k5_fuzz_pairs(n, seed=0):
    """n pairs of random oriented boxes [n,9,3] x 2 (float32): random
    rotations, sides 0.05-2, centres within 0.3 of the origin so most
    pairs overlap."""
    rng = np.random.RandomState(seed)

    def one():
        return box_kps(rng.uniform(-0.3, 0.3, 3),
                       rng.uniform(0.05, 2.0, 3) / 2,
                       rotation(rng.uniform(-np.pi, np.pi, 3)))

    pairs = [(one(), one()) for _ in range(n)]
    return (np.stack([p[0] for p in pairs]).astype(np.float32),
            np.stack([p[1] for p in pairs]).astype(np.float32))


def k5_exact_cases():
    """(name, box, box, exact IoU) of the unit box against: itself, a half
    shift, a 45° turn, a nested box, a disjoint box, a touching box and a
    box with a NaN corner."""
    half = np.array([.5, .5, .5])
    unit = box_kps(np.zeros(3), half)
    th = np.pi / 4
    rot = np.array([[np.cos(th), -np.sin(th), 0],
                    [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    inter = 2 * (np.sqrt(2) - 1)
    bad = unit.copy()
    bad[3] = np.nan
    return [('self', unit, unit, 1.0),
            ('half_shift', unit, box_kps(np.array([.5, 0, 0]), half), 1 / 3),
            ('rot45', unit, box_kps(np.zeros(3), half, rot),
             inter / (2 - inter)),
            ('nested', unit, box_kps(np.zeros(3), half / 2), 0.125),
            ('disjoint', unit, box_kps(np.array([5., 0, 0]), half), 0.0),
            ('touching', unit, box_kps(np.array([1., 0, 0]), half), 0.0),
            ('nan', bad, unit, 0.0)]


def k4_work(b, n_classes, logit_bytes):
    """Bytes and operations that K4 needs for b crops in pack mode without
    TTA (the serving path's pass): the selected head's 18 pre-activations
    of each crop (the other 8 heads are never read), every logit, the
    boxes, the detections and the packed rows; a compare per logit and a
    sigmoid per read pre-activation (negate, exp, add, reciprocal)."""
    n_bytes = b * (18 * 4 + n_classes * logit_bytes + 16 + 24 + 26 * 4)
    return n_bytes, b * (n_classes + 18 * 4)


# K5's work besides the clip passes, per pair: box axes, determinants and
# halfspaces of both boxes (2 x 182), the volumes (2), 12 face normals
# (12 x 18), the 72 coincidence tolerances (36 x 9 with the normals' dot
# product, 36 x 3 without) and the fan sums and quotients (42)
K5_PAIR_OPS = 2 * 182 + 2 + 12 * 18 + 36 * 9 + 36 * 3 + 42


def k5_work(a, b, box3d):
    """Bytes and operations that K5 needs for these pairs, counted on this
    data by running the plain version: each clip pass visits the polygon's
    valid vertices (7 flops each: the plane distance and the test) and
    computes an intersection at each crossing (12 flops); each clipped face
    of n vertices has n - 2 fan triangles (15 flops each); plus
    K5_PAIR_OPS per pair."""
    seen = dict(visits=0, crossings=0, triangles=0)
    clip, fan = box3d._clip, box3d._fan_volume

    def counting_clip(poly, count, normal, offset, eps):
        out, n_out = clip(poly, count, normal, offset, eps)
        valid = torch.arange(poly.shape[1], device=poly.device) \
            < count[:, None]
        d = box3d._dot(poly, normal[:, None, :]) - offset[:, None]
        inside = int(((d <= eps[:, None]) & valid).sum())
        seen['visits'] += int(valid.sum())
        seen['crossings'] += int(n_out.sum()) - inside
        return out, n_out

    def counting_fan(poly, count):
        seen['triangles'] += int((count - 2).clamp(0, poly.shape[1] - 2)
                                 .sum())
        return fan(poly, count)

    box3d._clip, box3d._fan_volume = counting_clip, counting_fan
    try:
        box3d.iou_oriented_boxes_plain(a, b)
    finally:
        box3d._clip, box3d._fan_volume = clip, fan
    p = a.shape[0]
    n_ops = (seen['visits'] * 7 + seen['crossings'] * 12
             + seen['triangles'] * 15 + p * K5_PAIR_OPS)
    return (a.numel() + b.numel() + p) * 4, n_ops


def check_k5(dev, ops, box3d):
    iou, iou_plain, iou_host = ops
    err = 0.0
    for p in (1, 8, 128, 129):
        a, b = (torch.from_numpy(x).to(dev) for x in k5_fuzz_pairs(p, p))
        e = max_err(iou(a, b), iou_plain(a, b))
        print(f'K5 P={p}: max |kernel - plain| = {e:.3g} (tol 1e-5)')
        expect(e <= 1e-5, f'K5 P={p} disagrees: {e}')
        err = max(err, e)
    for name, x, y, want in k5_exact_cases():
        got = float(iou(torch.tensor(x, dtype=torch.float32, device=dev),
                        torch.tensor(y, dtype=torch.float32, device=dev)))
        print(f'K5 {name}: {got:.7f} (want {want})')
        expect(abs(got - want) <= 1e-5, f'K5 {name}: {got} != {want}')
    a, b = k5_fuzz_pairs(32, 2)
    got = iou(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    host = np.array([iou_host(x, y) for x, y in zip(a, b)])
    e_host = float(np.abs(got.cpu().numpy() - host).max())
    print(f'K5 32 pairs: max |kernel - scipy| = {e_host:.3g} (tol 1e-4)')
    expect(e_host <= 1e-4, f'K5 disagrees with scipy: {e_host}')
    out = {}
    for p, iters in ((128, 200), (8, 200)):
        a, b = (torch.from_numpy(x).to(dev) for x in k5_fuzz_pairs(p, p))
        out[p] = dict(
            ms=time_ms(lambda: iou(a, b), iters),
            device_ms=profile_call(lambda: iou(a, b))[1],
            plain_ms=time_ms(lambda: iou_plain(a, b), 10),
            bound=bound_ms(*k5_work(a, b, box3d)))
        print(f'K5 P={p}: {out[p]["ms"]} ms per call back to back, '
              f'{out[p]["device_ms"]} ms on the device')
    return dict(err=err, host_err=e_host, library_ms=None,
                floor_ms=launch_floor_ms(dev), **out[128], p8=out[8])


def check_results(results, h, w):
    for r in results:
        expect(r['kp'].shape[1:] == (9, 2) and r['boxes'].shape[1] == 4,
               'result shapes')
        for k in ('boxes', 'scores', 'kp'):
            expect(np.all(np.isfinite(r[k])), f'non-finite {k}')
        expect(np.all((r['kp'] >= 0) & (r['kp'] <= 1)), 'kp outside [0,1]')
        expect(np.all(r['boxes'] >= 0) and np.all(r['boxes'][:, [0, 2]] <= w)
               and np.all(r['boxes'][:, [1, 3]] <= h),
               'boxes outside the frame')


def main_path(engine, wrappers, frames_np):
    """Drive the serving path through its public calls; return the launch
    count of each kernel wrapper in that run."""
    for f in wrappers:
        f.launches = 0
    h, w = FRAME[:2]
    batch = engine.infer_batch(frames_np)
    single = engine(frames_np[0])
    engine.run_async(frames_np[1])
    engine.run_async(frames_np[2])
    first, second = engine.wait_and_grab(), engine.wait_and_grab()
    torch.cuda.synchronize()
    launches = [f.launches for f in wrappers]
    expect(len(batch) == 16, 'infer_batch result count')
    results = batch + [single, first, second]
    check_results(results, h, w)
    expect(sum(len(r['scores']) for r in results) > 0, 'no detection at all')
    print('main path: infer_batch(16) + __call__ + 2x run_async: '
          f'{sum(len(r["scores"]) for r in results)} detections, launches '
          f'K1/K2/K3/K4 = {launches}')
    for f, n in zip(wrappers, launches):
        expect(n > 0, f'{f.__name__} was never launched on the main path')
    return launches


def path_intermediates(engine, frames_np, plain, norm):
    """The path's own intermediates through the plain versions."""
    resize_plain, crop_plain, decode_plain, crop, epi, epi_plain = plain
    frames = engine._upload(frames_np)
    h, w = FRAME[:2]
    det_in, logits, deltas, dets, boxes = engine._detect(
        frames, h, w, engine.cfg.crop_margin_px)
    e1 = max_err(det_in, resize_plain(frames, (300, 300), True, 1 / 255.0))
    print(f'path K1: max |kernel - plain| = {e1:.3g} (tol {2 ** -8:.3g})')
    expect(e1 <= 2 ** -8, 'path K1 disagrees')
    e3 = compare_dets(dets, decode_plain(logits, deltas, engine.anchors,
                                         **engine.decode_kwargs()),
                      'path K3')
    args = (engine.cfg.crop_size, True, norm[0], norm[1], False)
    e2 = max_err(crop(frames, boxes, *args, torch.bfloat16),
                 crop_plain(frames, boxes, *args))
    print(f'path K2: max |kernel - plain| = {e2:.3g} (tol '
          f'{2 ** -7 + 1e-4:.3g})')
    expect(e2 <= 2 ** -7 + 1e-4, 'path K2 disagrees')
    pre, logits = engine._heads(frames, boxes)
    flat, flat_dets = boxes.reshape(-1, 4), dets.reshape(-1, 6)
    kw = dict(dets=flat_dets, det_conf=engine.cfg.det_conf)
    e4 = compare_k4(epi(pre, logits, flat, **kw),
                    epi_plain(pre, logits, flat, **kw), 'path K4', False)
    return e1, e2, e3, e4


def wide_path(dev, wrappers, frames_np, plain, norm):
    """Phase 3b: an engine with max_detections 128 (K3's K=512, as the JAX
    engine serves it) through ``infer_batch``, with the launch counts set
    to 0 just before and read just after; its intermediates against the
    plain versions as phase 3 checks the default engine's."""
    from tpudet3d_torch.infer import build_engine
    engine = build_engine(det_conf=0.0, max_detections=128, device=dev)
    expect(engine.decode_kwargs()['pre_nms_k'] == 512, 'K of max_det 128')
    for f in wrappers:
        f.launches = 0
    batch = engine.infer_batch(frames_np)
    torch.cuda.synchronize()
    launches = [f.launches for f in wrappers]
    expect(len(batch) == len(frames_np), 'infer_batch result count')
    check_results(batch, *FRAME[:2])
    n_det = sum(len(r['scores']) for r in batch)
    print(f'max_detections 128: infer_batch({len(frames_np)}) {n_det} '
          f'detections, launches K1/K2/K3/K4 = {launches}')
    expect(n_det > 8 * len(frames_np), 'max_detections 128 kept no more '
           'than 8 rows a frame')
    for f, n in zip(wrappers, launches):
        expect(n > 0, f'{f.__name__} was never launched with max_detections '
               '128')
    errs = path_intermediates(engine, frames_np, plain, norm)
    return dict(launches=launches, detections=n_det, errs=errs)


def serving_times(engine, dev, iters):
    h, w = FRAME[:2]
    out = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for b in (16, 32):
        frames = torch.randint(0, 256, (b, *FRAME), dtype=torch.uint8,
                               device=dev, generator=gen)
        engine._pipeline_batch(frames, h, w)
        torch.cuda.synchronize()
        vals = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                engine._pipeline_batch(frames, h, w)
            torch.cuda.synchronize()
            vals.append(b * iters / (time.perf_counter() - t0))
        vals.sort()
        out[f'server_fps_b{b}'] = vals[1]
        out[f'server_fps_b{b}_spread'] = [vals[0], vals[2]]
    frame = frames[0]
    lat = []
    for _ in range(5 * iters):
        t0 = time.perf_counter()
        engine._pipeline(frame, h, w)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    out['latency_ms_p50'], out['latency_ms_p99'] = (
        float(v) for v in np.percentile(lat, [50, 99]))
    return out


def eval_examples(n, seed, geometry):
    """n synthetic Objectron examples (image, gt2d, gt3d, visibility,
    plane): portrait uint8 frames of noise with a flat patch over each
    object, 1–3 GT boxes 1–3 m in front of the default camera projected
    through it, visibility 1, and a ground plane 1 m below the camera."""
    rng = np.random.RandomState(seed)
    h, w = EVAL_FRAME[:2]
    cam = geometry.convert_camera_matrix_2_ndc(
        geometry.get_default_camera_matrix())
    plane = (np.array([0., -1., -2.], np.float32),
             np.array([0., 1., 0.], np.float32))
    out = []
    for _ in range(n):
        img = np.frombuffer(rng.bytes(int(np.prod(EVAL_FRAME))),
                            np.uint8).reshape(EVAL_FRAME).copy()
        gt2d, gt3d = [], []
        for _ in range(rng.randint(1, 4)):
            box = box_kps(np.r_[rng.uniform(-0.3, 0.3, 2),
                                rng.uniform(-3, -1)],
                          rng.uniform(0.1, 0.4, 3),
                          rotation(rng.uniform(-np.pi, np.pi, 3)))
            uv = geometry.project_3d_points(box, cam)
            xy = np.stack([(uv[:, 1] + 1) / 2, (uv[:, 0] + 1) / 2], -1)
            x0, y0 = np.clip(xy.min(0) * [w, h], 0, [w, h]).astype(int)
            x1, y1 = np.clip(xy.max(0) * [w, h], 0, [w, h]).astype(int)
            img[y0:y1, x0:x1] = rng.randint(0, 256, 3)
            gt2d.append(xy)
            gt3d.append(box)
        out.append((img, np.asarray(gt2d, np.float32),
                    np.asarray(gt3d, np.float32),
                    np.ones(len(gt2d), np.float32), plane))
    return out


def check_report(text, evaluator, what):
    """Every number of the report finite, the mean IoU in [0, 1], and
    something matched."""
    for line in text.splitlines()[1:]:
        if ': ' not in line:
            continue
        vals = [float(v) for v in re.split(r'[,\s]+',
                                           line.split(': ', 1)[1]) if v]
        expect(all(np.isfinite(vals)), f'{what}: non-finite in {line!r}')
        if line.startswith('Mean 3D IoU'):
            expect(0.0 <= vals[0] <= 1.0, f'{what}: mean IoU {vals[0]}')
    expect(evaluator._matched > 0, f'{what}: nothing matched')


def eval_path(dev, wrappers):
    """Phase 5: the evaluation path at full width; returns its numbers."""
    from tpudet3d_torch.eval import protocol
    from tpudet3d_torch.ops import geometry
    from tpudet3d_torch.ops.box3d import iou_oriented_boxes_plain
    from tpudet3d_torch.tools.objectron_eval import (engine_from_args,
                                                     evaluate_category,
                                                     parse_args)

    class Recording(protocol.ObjectronProtocolEvaluator):
        """Keeps every example and every K5 call's pairs with its IoUs."""

        def __init__(self):
            super().__init__(dev)
            self.examples, self.calls = [], []

        def _ious(self, pairs):
            out = super()._ious(pairs)
            if pairs:
                self.calls.append((np.asarray(pairs, np.float32), out))
            return out

        def evaluate_example(self, *args, **kw):
            self.examples.append((args, kw))
            super().evaluate_example(*args, **kw)

    data = {cls: eval_examples(EVAL_EXAMPLES, seed, geometry)
            for seed, cls in enumerate(EVAL_CLASSES, 5)}
    engines = []
    for name, flags in (('default', ['--det_tresh', '0']),
                        ('recall', ['--preset', 'recall'])):
        args = parse_args(['--eval_data', '-', *flags])
        engine = engine_from_args(args)        # the card, full width
        engine.infer_batch(np.stack([e[0] for e in
                                     data[EVAL_CLASSES[0]][:args.batch]]))
        engines.append((name, args, engine))
    geometry.lift_2d_batched(torch.rand((8, 9, 2), device=dev),
                             portrait=True)                  # warm-up
    torch.cuda.synchronize()

    for f in wrappers:
        f.launches = 0
    runs = []
    for name, args, engine in engines:
        for cls in EVAL_CLASSES:
            ev, timings = Recording(), {}
            t0 = time.perf_counter()
            evaluate_category(engine, iter(data[cls]), args.batch,
                              args.vis_thresh, evaluator=ev, timings=timings)
            timings['wall'] = time.perf_counter() - t0
            runs.append((name, cls, ev, timings))
    torch.cuda.synchronize()
    launches = [f.launches for f in wrappers]
    print(f'evaluation path: 2 settings x {len(EVAL_CLASSES)} categories x '
          f'{EVAL_EXAMPLES} examples of {EVAL_FRAME[0]}x{EVAL_FRAME[1]}, '
          f'launches K1/K2/K3/K4/K5 = {launches}')
    for f, n in zip(wrappers, launches):
        expect(n > 0, f'{f.__name__} was never launched on the evaluation '
               'path')

    iou_err, n_pairs, pred_kp = 0.0, 0, []
    out = {'launches': launches}
    for name, cls, ev, t in runs:
        what = f'eval {name} {cls}'
        buf = io.StringIO()
        ev.write_report(cls, buf)
        text = buf.getvalue()
        check_report(text, ev, what)
        # the same lifted predictions re-scored with the plain K5 on the card
        for pairs, got in ev.calls:
            kp = torch.from_numpy(pairs).to(dev)
            iou_err = max(iou_err, max_err(
                torch.from_numpy(got),
                iou_oriented_boxes_plain(kp[:, 0], kp[:, 1]).cpu()))
            n_pairs += len(pairs)
        again = protocol.ObjectronProtocolEvaluator(dev)
        kernel, protocol.iou_oriented_boxes = (protocol.iou_oriented_boxes,
                                               iou_oriented_boxes_plain)
        try:
            for args, kw in ev.examples:
                again.evaluate_example(*args, **kw)
        finally:
            protocol.iou_oriented_boxes = kernel
        again.finalize()
        buf = io.StringIO()
        again.write_report(cls, buf)
        expect(buf.getvalue() == text, f'{what}: the report under the plain '
               'K5 differs')
        pred_kp += [np.asarray(a[0], np.float32).reshape(-1, 9, 2)
                    for a, _ in ev.examples if len(a[0])]
        print(f'{what}: {text.splitlines()[0]}, '
              + ', '.join(line for line in text.splitlines()[1:5]))
    print(f'evaluation path K5: {n_pairs} pairs, max |kernel - plain| '
          f'{iou_err:.3g} (tol 1e-5); reports identical under the plain K5')
    expect(iou_err <= 1e-5, f'K5 on the evaluation path disagrees: {iou_err}')
    # the card's float32 lift against the float64 host lift: on the GT
    # keypoints (exact box projections, a well-separated null vector) and
    # on the path's predictions (a random network's keypoints, where the
    # smallest eigenvalues can nearly coincide)
    lift = {}
    for name, kp in (('gt', np.concatenate([e[1] for d in data.values()
                                            for e in d])),
                     ('pred', np.concatenate(pred_kp))):
        card = geometry.lift_2d_batched(torch.from_numpy(kp).to(dev),
                                        portrait=True).cpu().numpy()
        host = geometry._lift_host(kp.astype(np.float64),
                                   geometry.get_default_camera_matrix(), True)
        expect(np.all(np.isfinite(card)), f'non-finite lift of {name}')
        err = np.abs(card - host).max(axis=(1, 2))
        lift[name] = dict(sets=len(kp), max=float(err.max()),
                          median=float(np.median(err)),
                          share_within_1e3=float((err <= 1e-3).mean()))
        print(f'evaluation path lift of {name} keypoints: {len(kp)} sets, '
              f'|card f32 - host f64| max {err.max():.3g}, median '
              f'{np.median(err):.3g}, {lift[name]["share_within_1e3"]:.3f} '
              'of the sets within 1e-3')
    expect(lift['gt']['max'] <= LIFT_TOL, 'the lift of exact projections '
           f'is {lift["gt"]["max"]} from the float64 lift (tol {LIFT_TOL})')
    out.update(k5_err=iou_err, lift=lift)
    for name in ('default', 'recall'):
        sel = [(ev, t) for n, _, ev, t in runs if n == name]
        wall = sum(t['wall'] for _, t in sel)
        k5 = sum(ev.iou_seconds for ev, _ in sel)
        split = dict(engine_s=sum(t['engine'] for _, t in sel),
                     lift_s=sum(t['lift'] for _, t in sel), k5_s=k5,
                     host_protocol_s=sum(t['protocol'] for _, t in sel) - k5)
        eps = len(EVAL_CLASSES) * EVAL_EXAMPLES / wall
        out[name] = dict(examples_per_s=eps, wall_s=wall, **split)
        print(f'evaluation {name}: {eps:.2f} examples/s, wall {wall:.3f} s: '
              + ', '.join(f'{k} {v:.3f}' for k, v in split.items()))
    return out


# Phase 6: the flagship regressor config, its 288² variant, the frames of
# the demo loop (moving_frames) and of the Detector
EL0_CONFIG = 'configs/scene_regressor_el0_ema.py'
R288_CONFIG = 'configs/scene_regressor_el0_r288.py'
DEMO_FRAMES = 32
DETECTOR_FRAMES = 4


def write_snapshots(root):
    """Phase 6a: a cascade MNv2-SSD-300 w1.0 and an EfficientNet-lite0
    regressor (seeded) as converted snapshots ``snap_3.pt`` under ``root``;
    the regressor's EMA differs from its raw weights.  Returns the paths,
    the in-memory modules and the state_dicts."""
    import os
    from tpudet3d_torch.core import read_py_config
    from tpudet3d_torch.infer.build import build_detector
    from tpudet3d_torch.models import build_model
    from tpudet3d_torch.utils.checkpoint import save_converted

    def weights(module):
        return {k: v.detach().clone() for k, v in module.state_dict().items()
                if not k.endswith('num_batches_tracked')}

    gen = torch.Generator().manual_seed(6)
    det = build_detector(cascade=True, generator=gen)
    reg = build_model(read_py_config(EL0_CONFIG), generator=gen)
    params = weights(reg)
    ema = {k: v if 'running_' in k else v + 0.01 * torch.randn(
        v.shape, generator=gen) for k, v in params.items()}
    paths = {}
    for kind, sd, extra in (('detector', weights(det), None),
                            ('regressor', params, ema)):
        os.makedirs(os.path.join(root, kind))
        paths[kind] = save_converted(os.path.join(root, kind, 'snap_3.pt'),
                                     kind, 3, sd, extra)
    return paths, det, reg, params, ema


def drive(wrappers, fn):
    """``fn()`` with the launch counts set to 0 just before it; returns its
    result and the counts read just after it."""
    for f in wrappers:
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, [f.launches for f in wrappers]


def moving_frames(n, shape=None, seed=7):
    """n BGR frames of ``shape`` (default FRAME): noise with 3 flat boxes
    moving 3 px right and 1 px down a frame."""
    h, w, _ = shape or FRAME
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    boxes = [(int(w * x0), int(h * y0), int(w * x1), int(h * y1)) for
             x0, y0, x1, y1 in ((0.15, 0.2, 0.33, 0.55), (0.47, 0.28, 0.64,
                                                         0.72),
                                (0.7, 0.42, 0.86, 0.83))]
    colors = rng.randint(0, 256, (3, 3))
    out = []
    for t in range(n):
        f = base.copy()
        for (x0, y0, x1, y1), c in zip(boxes, colors):
            f[y0 + t:y1 + t, x0 + 3 * t:x1 + 3 * t] = c
        out.append(f)
    return out


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, so that two runs of the same
    weights on the same inputs can be held bit for bit."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def same_results(a, b, what):
    for r, q in zip(a, b):
        for k in r:
            expect(np.array_equal(r[k], q[k]), f'{what}: {k} differs')


def flagship_path(dev, wrappers, frames_np, plain, norm, iters):
    """Phase 6: the flagship EfficientNet-lite0 regressor and the cascade
    detector served from converted snapshots at full width; returns its
    numbers.  Each drive of a path is counted by :func:`drive`, and every
    kernel's count (K5's too) must equal what the path fixes; the
    comparisons with the plain versions are not counted."""
    import tempfile
    from tpudet3d_torch import native
    from tpudet3d_torch.infer import (Detector, IOUTracker,
                                      IOUTrackerConfig, TwoStageEngine,
                                      build_engine)
    from tpudet3d_torch.tools import demo
    resize, crop, decode, epilogue, _ = wrappers
    h, w = FRAME[:2]
    out = {'launches': {}}

    def counted(name, fn, expected):
        res, n = drive(wrappers, fn)
        print(f'phase 6 {name}: launches K1/K2/K3/K4/K5 = {n}')
        want = [expected.get(f, 0) for f in wrappers]
        expect(n == want, f'{name}: launches {n}, expected {want}')
        out['launches'][name] = n
        return res

    def per_pass(engine, frames):
        """One K1 and K3 launch per frame or batch, one K2 and K4 a pass."""
        passes = 1 + int(engine.cfg.refine_passes)
        return {resize: frames, decode: frames, crop: frames * passes,
                epilogue: frames * passes}

    with tempfile.TemporaryDirectory() as root:
        # (a) the snapshots; (b) the el0 engine served from them
        paths, det, reg, params, ema = write_snapshots(root)
        engine = build_engine(EL0_CONFIG, det_checkpoint=paths['detector'],
                              reg_checkpoint=paths['regressor'],
                              det_conf=0.0, device=dev)
        r288 = build_engine(R288_CONFIG, det_checkpoint=paths['detector'],
                            reg_checkpoint=paths['regressor'], det_conf=0.0,
                            device=dev)
    expect(engine.det_model.cascade and engine.det_model.width_mult == 1.0,
           'the detector snapshot did not give a cascade w1.0')
    key = 'backbone.blocks_9.ConvBN_1.Conv_0.weight'      # a 5x5 depthwise
    served = engine.reg_model.state_dict()[key].cpu()
    expect(torch.equal(served, ema[key]) and not torch.equal(served,
                                                             params[key]),
           'the EMA config does not serve the EMA weights')
    expect(torch.equal(r288.reg_model.state_dict()[key].cpu(), params[key]),
           'the config without EMA does not serve the raw weights')
    batch = counted('el0 infer_batch(16)',
                    lambda: engine.infer_batch(frames_np),
                    per_pass(engine, 1))
    check_results(batch, h, w)
    n_det = sum(len(r['scores']) for r in batch)
    expect(n_det > 0, 'el0: no detection')
    out['errs'] = path_intermediates(engine, frames_np, plain, norm)
    # loading is lossless: the same modules in memory give the same rows
    reg.load_state_dict(ema, strict=False)
    memory = TwoStageEngine(det, reg, engine.cfg, device=dev)
    with cudnn_deterministic():
        same_results(engine.infer_batch(frames_np),
                     memory.infer_batch(frames_np),
                     'el0 from snapshots against the modules in memory')
    del memory
    print(f'el0 from snapshots: {n_det} detections over {len(batch)} '
          'frames, rows equal to the in-memory engine bit for bit')

    # (c) the r288 config: 288² crops
    expect(r288.cfg.crop_size == (288, 288), 'r288 crop size')
    res = counted('r288 infer_batch(16)', lambda: r288.infer_batch(
        frames_np), per_pass(r288, 1))
    check_results(res, h, w)
    expect(sum(len(r['scores']) for r in res) > 0, 'r288: no detection')
    del r288

    # (d) el0 serving times
    out['serving'] = serving_times(engine, dev, iters)

    # (e) the demo loop: pipelined engine and tracker over moving frames
    frames = moving_frames(DEMO_FRAMES)
    tracker = IOUTracker(**vars(IOUTrackerConfig()))
    stats = {}
    loop = counted('demo loop', lambda: list(demo.run(
        iter([f.copy() for f in frames]), engine, tracker, stats=stats)),
        per_pass(engine, DEMO_FRAMES))
    expect(len(loop) == DEMO_FRAMES, 'demo loop frame count')
    with cudnn_deterministic():
        for f, (_, result, _) in zip(frames, demo.run(
                iter([f.copy() for f in frames]), engine,
                IOUTracker(**vars(IOUTrackerConfig())))):
            same_results([result], engine.infer_batch(f[None]),
                         'demo loop against infer_batch of one frame')
    lengths = [len(t) for t in tracker.get_tracks()]
    labelled = sum(o.label != 'ID -1' for _, _, objs in loop for o in objs)
    expect(max(lengths, default=0) >= 5, 'no track lived 5 frames')
    route = 'native' if native.native_available() else 'scipy'
    out['demo'] = dict(frames=DEMO_FRAMES, fps=DEMO_FRAMES / stats['seconds'],
                       seconds=stats['seconds'], longest_track=max(lengths),
                       labelled_objects=labelled, assignment=route)
    print(f'demo loop: {DEMO_FRAMES} frames of 720p at '
          f'{out["demo"]["fps"]:.2f} frames/s, longest track '
          f'{max(lengths)} frames, {labelled} labelled objects, '
          f'assignment route {route}; results equal infer_batch of one frame')

    # (f) split inference: the Detector wrapper (K1, K3)
    detector = Detector(engine.det_model, conf=0.0, device=dev)
    split = counted('Detector', lambda: [detector.get_detections(f) for f in
                                         frames[:DETECTOR_FRAMES]],
                    {resize: DETECTOR_FRAMES, decode: DETECTOR_FRAMES})
    for f, got in zip(frames[:DETECTOR_FRAMES], split):
        with torch.no_grad():
            got_again = check_detector(detector, f, plain)
        expect(got_again == got, 'Detector output differs from its '
               "kernels' path")
    expect(sum(map(len, split)) > 0, 'Detector: no detection')
    return out


def check_detector(detector, f, plain):
    """The Detector wrapper's own intermediates on frame ``f``: K1 and K3
    against their plain versions on the path's inputs; returns the
    detections that the wrapper decodes from the kernels' outputs."""
    from tpudet3d_torch.infer.engine import upload
    resize_plain, _, decode_plain = plain[:3]
    t = upload(f, detector.device)
    det_in, logits, deltas, dets = detector._detect(t)
    e1 = max_err(det_in, resize_plain(t[None], (300, 300),
                                      detector.input_is_bgr, 1 / 255.0))
    print(f'Detector K1: max |kernel - plain| = {e1:.3g} (tol '
          f'{2 ** -8:.3g})')
    expect(e1 <= 2 ** -8, f'Detector K1 disagrees: {e1}')
    compare_dets(dets, decode_plain(logits, deltas, detector.anchors,
                                    **detector.decode_kwargs()),
                 'Detector K3')
    rows = detector._to_frame(dets[0], *f.shape[:2])
    return detector._decode(rows.cpu().numpy(), f.shape)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default='', help='also write the numbers here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    return run(torch.device('cuda'), args.out)


def run(dev, out_path, iters=20):
    """All phases on ``dev``; ``iters`` calls per serving timing loop."""
    from tpudet3d_torch.detect import (decode_detections,
                                       decode_detections_plain)
    from tpudet3d_torch.infer import build_engine
    from tpudet3d_torch.infer.engine import REG_OFFSET, REG_SCALE
    from tpudet3d_torch.infer.epilogue import (head_epilogue,
                                               head_epilogue_plain)
    from tpudet3d_torch.kernels.build import build, library
    from tpudet3d_torch.ops import box3d
    from tpudet3d_torch.ops import (crop_and_resize, crop_and_resize_plain,
                                    resize_bilinear, resize_bilinear_plain,
                                    resize_weights)
    iou = box3d.iou_oriented_boxes
    t0, phase_s = time.perf_counter(), {}

    def done(phase):
        phase_s[phase] = time.perf_counter() - t0 - sum(phase_s.values())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    norm = (REG_SCALE, REG_OFFSET)

    # 1. build
    path, build_s, log = build()
    library()
    print(f'kernels built in {build_s:.1f} s: {path}' if build_s else
          f'kernels: reusing {path}')
    print(log.strip())
    gpu = gpu_line()
    print(gpu)
    done('1 build')

    # 2. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (16, *FRAME), dtype=torch.uint8,
                           device=dev, generator=gen)
    k1 = check_k1(dev, frames, (resize_bilinear, resize_bilinear_plain,
                                resize_weights))
    k2 = check_k2(dev, (crop_and_resize, crop_and_resize_plain), norm)
    from tpudet3d_torch.detect import generate_anchors
    anchors = torch.from_numpy(generate_anchors()).to(dev)
    k3 = check_k3(dev, (decode_detections, decode_detections_plain),
                  anchors)
    k4 = check_k4(dev, (head_epilogue, head_epilogue_plain))
    k5 = check_k5(dev, (iou, box3d.iou_oriented_boxes_plain,
                        box3d.iou_single_host), box3d)
    del frames
    done('2 kernels')

    # 3. the serving path at full width
    engine = build_engine(det_conf=0.0, device=dev)
    frames_np = np.random.RandomState(1).randint(0, 256, (16, *FRAME)) \
        .astype(np.uint8)
    wrappers = (resize_bilinear, crop_and_resize, decode_detections,
                head_epilogue)
    launches = main_path(engine, wrappers, frames_np)
    e1, e2, e3, e4 = path_intermediates(
        engine, frames_np, (resize_bilinear_plain, crop_and_resize_plain,
                            decode_detections_plain, crop_and_resize,
                            head_epilogue, head_epilogue_plain), norm)

    # 3b. the serving path with max_detections 128 (K3 at K=512, its
    # large-K instantiation)
    wide = wide_path(dev, wrappers, frames_np, (
        resize_bilinear_plain, crop_and_resize_plain,
        decode_detections_plain, crop_and_resize, head_epilogue,
        head_epilogue_plain), norm)

    done('3 serving path')

    # 4. serving times
    times = serving_times(engine, dev, iters)
    print(f'serving on {gpu}: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in times.items() if not k.endswith('spread')))
    del engine
    done('4 serving times')

    # 5. the evaluation path at full width
    evaluation = eval_path(dev, wrappers + (iou,))
    done('5 evaluation path')

    # 6. the flagship EfficientNet-lite0 regressor and the cascade detector
    # from converted snapshots: serving, 288² crops, times, the demo loop
    # with the tracker, and the Detector wrapper
    flagship = flagship_path(dev, wrappers + (iou,), frames_np, (
        resize_bilinear_plain, crop_and_resize_plain,
        decode_detections_plain, crop_and_resize, head_epilogue,
        head_epilogue_plain), norm, max(iters // 2, 1))
    el0 = flagship['serving']
    print(f'el0 serving on {gpu}: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in el0.items() if not k.endswith('spread')))
    print(f'el0 demo loop on {gpu}: {flagship["demo"]["fps"]:.2f} frames/s '
          f'over {flagship["demo"]["frames"]} frames of 720p, assignment '
          f'route {flagship["demo"]["assignment"]}')
    runs = flagship['launches']
    done('6 flagship path')
    print('seconds by phase: ' + ', '.join(f'{k} {v:.1f}'
                                           for k, v in phase_s.items()))

    kernels = []
    for (name, src, replaces, m, err), n, n_eval, n_el0 in zip((
            ('K1 preprocess_resize', 'tpudet3d_torch/kernels/csrc/resize.cu',
             'tpudet3d/ops/image.py:19', k1, max(k1['err'], e1)),
            ('K2 crop_resize_normalize', 'tpudet3d_torch/kernels/csrc/crop.cu',
             'tpudet3d/ops/image.py:86', k2, max(k2['err'], e2)),
            ('K3 decode_nms', 'tpudet3d_torch/kernels/csrc/decode_nms.cu',
             'tpudet3d/detect/nms.py:86', k3, max(k3['err'], e3)),
            ('K4 head_epilogue',
             'tpudet3d_torch/kernels/csrc/head_epilogue.cu',
             'tpudet3d/infer/engine.py:270', k4, max(k4['err'], e4)),
            ('K5 iou_oriented_boxes',
             'tpudet3d_torch/kernels/csrc/box3d_iou.cu',
             'tpudet3d/ops/box3d.py:161', k5,
             max(k5['err'], evaluation['k5_err']))),
            launches + [evaluation['launches'][4]],
            evaluation['launches'], runs['el0 infer_batch(16)']):
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': n, 'max_abs_err': err,
            'ms': m['ms'], 'plain_ms': m['plain_ms'],
            'bound_ms': m['bound'][0], 'bound_by': m['bound'][1],
            'library_ms': m['library_ms'], 'launches_eval': n_eval,
            'launches_el0': n_el0})
    for i, k in enumerate(kernels):
        k['launches_flagship'] = {run: n[i] for run, n in runs.items()}
    kernels[0].update(ms_cold=k1['ms_cold'], ms_n1=k1['ms_n1'],
                      device_ms_n1=k1['device_ms_n1'],
                      library_ms_cold=k1['library_ms_cold'])
    kernels[1].update(ms_cold=k2['ms_cold'], ms_mirror=k2['ms_mirror'],
                      ms_n1=k2['ms_n1'], device_ms=k2['device_ms'],
                      ms_288=k2['ms_288'], device_ms_288=k2['device_ms_288'],
                      bound_ms_288=k2['bound_ms_288'],
                      device_ms_n1=k2['device_ms_n1'],
                      library_ms_cold=k2['library_ms_cold'])
    kernels[2].update(ms_soft=k3['ms_soft'], ms_vote=k3['ms_vote'],
                      ms_n1=k3['ms_n1'], device_ms=k3['device_ms'],
                      device_ms_n1=k3['device_ms_n1'])
    kernels[3].update(launches_per_pass_kernel_plain=k4['launches_per_pass'],
                      device_ms=k4['device_ms'],
                      plain_device_ms=k4['plain_device_ms'],
                      floor_ms=k4['floor_ms'])
    kernels[4].update(device_ms=k5['device_ms'], ms_p8=k5['p8']['ms'],
                      device_ms_p8=k5['p8']['device_ms'],
                      plain_ms_p8=k5['p8']['plain_ms'],
                      bound_ms_p8=k5['p8']['bound'][0],
                      max_abs_err_scipy=k5['host_err'],
                      floor_ms=k5['floor_ms'])
    for k in kernels:
        lib = ('none' if k['library_ms'] is None
               else f"{k['library_ms']:.4f} ms")
        print(f"{k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {lib}, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), {k['launches']} launches on its main "
              f"path ({k['launches_eval']} on the evaluation path, "
              f"{k['launches_el0']} on el0 infer_batch(16), "
              f"{k['launches_flagship']['demo loop']} on the demo loop), max "
              f'|kernel - plain| {k["max_abs_err"]:.3g}')
    print(gpu)
    print(json.dumps({'kernels': kernels}))
    if out_path:
        with open(out_path, 'w') as f:
            json.dump({'gpu': gpu, 'build_s': build_s, 'kernels': kernels,
                       'serving': times, 'max_det_128': wide,
                       'evaluation': evaluation, 'flagship': flagship,
                       'phase_s': phase_s,
                       'torch': torch.__version__,
                       'cuda': torch.version.cuda}, f, indent=1)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
