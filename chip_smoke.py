#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpudet3d_torch``) on one NVIDIA
GPU: ``python3 chip_smoke.py [--out FILE]``.

Phases, each fatal on failure:

1. Build the CUDA kernels from ``tpudet3d_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card at the
   paths' shapes (K1 resize at N=1 and 16 of 720p and on every shape of
   ``K1_CASES``, K2 crop on every case of ``K2_CASES`` with TTA off and
   on, K3 decode+NMS at A=2044, C=9 on every case of ``K3_CASES`` (K up
   to 2044; detector validation's and self-labelling's shapes), K4 head
   epilogue on the crop counts of ``K4_CASES`` with TTA off and on in
   refine and pack mode, on bf16 logits that carry exact ties and on
   logits with NaNs and ties across its warp reduction, K5 oriented-box
   IoU at P=1, 8, 128 and 129 on random boxes and on exact cases, and
   against scipy on 32 pairs).  The cases, inputs and tolerances are
   ``tpudet3d_torch/tools/cases.py``'s, which the card tests and the
   kernel tools share; ``tools/k1_bench.py`` to ``k6_bench.py`` time the
   kernels.
3. Drive the serving path at full width (MNv2-SSD-300 w1.0 + MNv3-large-21k,
   bf16, 224² crops, max_detections 8, random weights from seed 0) through
   ``infer_batch`` (16 frames), ``__call__`` and ``run_async`` /
   ``wait_and_grab``; check the outputs and that K1–K4 were launched; hold
   the path's own intermediates against the plain versions.  Then an
   engine with max_detections 128 (K3 at K=512) through ``infer_batch``,
   checked the same way.
4. (None: the serving path's frames/s and latency are the benchmark's
   cells ``serve.mnv3l21k.b32`` and ``serve.el0.b32``, ``perfbench/``.)
5. Drive the evaluation path at full width: ``objectron_eval``'s
   ``evaluate_category`` over 2 categories × 24 synthetic portrait
   1280×720 examples at batch 8, with the CLI's defaults at ``det_tresh``
   0, with ``--preset recall`` and with ``--int8`` (calibrated on each
   category's first frame, as the CLI does); check the reports and that
   K1–K7 were launched (counted by kernel name from a trace of the card's
   activity, under which the run is timed); re-score the same lifted predictions with the plain K5 (same
   IoUs, same report text); hold the card's float32 EPnP lift against the
   float64 host lift; time examples/s and its split.
6. Serve the flagship configuration from converted snapshots at full
   width: write a cascade MNv2-SSD-300 w1.0 and an EfficientNet-lite0
   regressor whose EMA differs from its weights (seeded) as ``snap_3.pt``
   files; ``build_engine`` on ``configs/scene_regressor_el0_ema.py``
   (serves the EMA) through ``infer_batch`` (16 frames), checked as in
   phase 3, with rows equal bit for bit to an engine of the same modules
   in memory; ``configs/scene_regressor_el0_r288.py`` (288² crops)
   through ``infer_batch``; ``tools/demo.py``'s ``run`` with the tracker
   over 32 720p frames of moving boxes (tracks kept, each result equal to
   ``infer_batch`` of its frame, frames/s, the assignment route); the
   ``Detector`` wrapper over 4 frames (K1 and K3 against their plain
   versions).  Each of these runs counts every kernel's launches (K5–K7
   too; a graphed ``infer_batch``'s replay by kernel name from a device
   trace, ``drive_replay``) and must give exactly the path's own: one K1
   and K3 a batch or frame, one K2 and K4 a regress pass, no K5, K6 or
   K7.
7. Serve int8: K6 and K7 against their plain versions bit for bit on
   every case of ``K6_CASES`` and ``K7_CASES`` (bf16 and f32, the stems'
   k×k, padded depths, M = 17, 49 and 128·49; K6 in channels-last and
   NCHW memory, each on the route the case names, all three routes
   taken), ``torch._int_mm`` against the exact product; MNv3-large-21k
   and the el0 engine of phase 6's snapshots calibrated by
   ``calibrate_engine`` on the 16 frames and served int8 through
   ``infer_batch`` (one K6 and one K7 a quantized conv in a replay,
   counted exactly from a device trace), the replay's rows equal bit for
   bit to the eager path's on the uploaded frames and those to its rows
   through the plain K6 and K7 (cuDNN's deterministic algorithms), their
   drift
   from bf16, K6 and K7 against their plain versions and K7 and
   ``_int_mm`` timed over the convs of one eager call (K6's route of
   every conv, none ``strided``; K6's times are ``tools/k6_bench.py``'s),
   launches and device time per call and frames/s and latency at batch
   16, bf16 and int8 in turns; el0 exported from its snapshot by
   ``tools/export.py``, reloaded and held against the eager module.
8. Train the regressor at full width from seeded random weights
   (``tpudet3d_torch.train``): the card's float32 step against the CPU's
   first (MNv3-large-21k, batch 8 at 224², 2 steps, the same weights,
   batch and dropout masks, ALWA firing; the loss, every gradient, the
   parameters within Adam's sign rule, the running statistics and the
   ALWA state, TF32 off, cuDNN's deterministic algorithms); then
   ``configs/scene_regressor.py`` (MNv3-large-21k) and
   ``configs/scene_regressor_el0_ema.py`` (el0 with its EMA), bf16 with
   float32 parameters, AdamW, batch 128 of 224² seeded noise images with
   projected box keypoints, 30 steps with no host synchronisation inside
   them (the loss must fall, every metric be finite, the EMA move and lag
   the parameters, ``step`` reach 30), then the eval step with the 3D IoU
   (exactly one K5 launch, none without the IoU; the same sums through
   the plain K5, the IoU within 1e-5 a sample); step ms (median of 20
   after 5 warm-up steps), images/s, peak memory, and device busy time,
   idle share and kernel groups over 5 steps under ``torch.profiler``.
9. Train el0 end to end at full width (``configs/scene_regressor_el0_ema.py``
   through ``setup_training``, ``Trainer`` and ``Evaluator``, bf16, batch
   128 of 224², EMA 0.995, the config's augmentations fused into the
   step and, with cv2, its warps in the loader threads;
   ``SyntheticObjectron`` items in place of the scenes; 2048 items, 2 epochs of 16 steps, validation
   on 512 after each, a snapshot each epoch): finite metrics, the
   learning rate from the schedule, the EMA moving, no synchronising call
   inside a step, exactly 4 K5 launches in the last validation (the IoU)
   and none elsewhere, the IoU against the plain K5, the augmentations on
   the card against the CPU's given the same draws, ``resume_from``
   ``snap_0.pt`` bit for bit, and ``build_engine`` serving ``snap_1.pt``'s
   EMA bit for bit through ``infer_batch``; loop, loader, step and
   validation throughput, a profiled epoch's busy time and idle share,
   the augmentations' launches and device ms, snapshot seconds.
10. Train the detector at full width (``tools/train_detector.py``'s path,
   ``tpudet3d_torch.detect.train``): first the card's float32 step of the
   cascade w1.0 against the CPU's (batch 4 of 300² SyntheticDetection
   hard items through the augmentations with fixed draws, GIoU 2, SGD
   with momentum and weight decay, 2 steps from the same weights; stage-1
   assignment equal, stage 2 but where the devices' IoUs straddle 0.5,
   the metrics, the gradients and the moves of parameters and momentum
   within DET_NOISE times the CPU's own float32 rounding against float64,
   the running statistics); then
   ``configs/detection/mnv2_ssd_300_scene_cascade.py`` (bf16, batch 64 of
   300², SGD 0.05 with warmup, GIoU 2, flip 0.5) on 1024
   SyntheticDetection(hard) items, 2 epochs of 16 steps with validation
   (mAP@0.5 through K3: 4 launches each, none in a step, no other kernel;
   one batch's rows against the plain K3 and the mAP unchanged through
   it), the learning rate from ``warmup_step_lr`` at each step, no
   synchronising call in a step or the augmentations, snapshots;
   ``resume_from`` ``snap_0.pt`` bit for bit; ``build_engine`` serving
   ``snap_1.pt`` bit for bit (K1–K4 once each for 16 frames);
   ``generate_selflabel_boxes`` over 32 scenes (one K3 launch, the same
   npz through the plain K3) consumed by ``SceneCrops``; loop, loader,
   validation and self-label throughput, a profiled epoch's idle share,
   the step alone for the cascade and ``mnv2_ssd_300_synthetic_hard.py``
   and the loss alone (launches, device ms).

11. The last modules at full width: (a) seeded checkpoints laid out to
   the timm ``mobilenetv3_large_100`` 21k contract and the
   efficientnet-lite0 contract vetted by ``tools/check_pretrained.py`` (a
   drifted one refused), ``setup_training(configs/default_config.py)``
   loading the 21k file bit for bit, its load seconds, 10 bf16 steps at
   batch 128 with a falling loss; (b) el0 bf16 at batch 128 under an NCCL
   group of one process against no group (step ms; 3 f32 steps bit for
   bit under cuDNN's deterministic algorithms; a validation with the IoU
   on keypoints that overlap their ground truth: 2 K5 launches, the
   averages as without the group and through the plain K5); (c) the
   cascade config at batch 64 through
   ``tools/train_detector.py``'s ``setup`` under the group (one epoch of
   256 items, a validation with its K3 launches and the mAP as without
   the group); two gloo processes on cuda:0 (NCCL refuses two ranks on
   one device) at 2×32 el0 rows and 2×8 cascade rows, float32, against
   one process over the same rows: the loss at step 0 within 1e-4, over
   the steps within 5e-2, the update at step 1 within 5e-2 of its norm
   and the parameters within a leaf-wise 5e-2, running statistics, ALWA
   and EMA equal on both ranks; ``Evaluator.val`` over both ranks within
   1e-6 of one process fed the same batches, rank 0's ``save_snap`` at a barrier resumed on
   both, ``DetectorEvaluator``'s mAP over both ranks' detections equal to
   one process's over them; (d)
   ``build_engine()`` over 16 720p frames unsharded, ``shard(['cuda:0'])``
   and ``shard(['cuda:0', 'cuda:0'])``: rows bit for bit against the
   unsharded ``infer_batch(16)`` (two replicas also against its two
   slices), K1–K4 once a slice, N=3
   refused, frames/s of each, K1–K4 at a slice's shapes against their
   plain versions; (e) ``tools/get_complexity.py`` on MNv3 and el0,
   ``utils/profiling.trace`` around a serving call naming K1–K4's
   kernels, ``tools/optuna_optim.py`` for 2 trials of 1 epoch at batch
   128 on synthetic items.
12. The card against the JAX package's golden record
   (``tests/fixtures/torch_port_golden``, written by
   ``tests/torch_port_golden.py`` on the CPU): every weight, frame and
   training item remade from its manifest by ``utils/golden.py`` and
   checked against its sha256; (A) the default build and (B) the cascade
   with EfficientNet-lite0, bf16, through ``infer_batch``, the engine's
   ``_detect`` (logits, deltas) and ``_heads`` on the JAX engine's crop
   boxes, K3 on JAX's own detector outputs, the engine's second stage
   (crop boxes, heads, K4's packed rows) on JAX's detections; (C) both
   int8 on the record's scales, and ``calibrate_engine`` on the
   detections JAX's calibration cropped; (D) the regressor's bf16 and
   float32 train steps and its eval step with the IoU; (E) the cascade
   detector's bf16 train step (reported), its float32 training forward,
   and the gradient of its loss on JAX's float32 forward outputs carried
   back through the float32 network; TF32 off. Each output is held by
   ``utils/golden.py``'s rules against JAX's with JAX's next precision
   as the yardstick (bf16 against float32, int8 against bf16, float32
   against float64; the free-running rows, the port's calibration on its
   own detections, the loss terms and E's bf16 gradient are reported),
   in one JSON line of every error beside its yardstick, fatal on any
   miss; every run's launches
   are exactly the path's own (one K1 and K3 a batch, one K2 and K4 a
   regress pass, one K6 and K7 a quantized conv, one K5 an eval batch
   with the IoU). Then both training CLIs through
   ``torch.distributed.run`` with one process: an NCCL group of one from
   torchrun's environment, rank 0's log, one snapshot resumed bit for
   bit.
13. Swin-T (``configs/scene_regressor_swint.py``): K8 window attention
   against its plain version at the four stage shapes at 256 crops
   (``[256, s, s, 96·heads]`` bf16, s = 56, 28, 14, 7), unshifted and
   shifted, within two bf16 ulps and no farther from the float64 function
   than 1.5× the plain version, timed with a call's 12 launches summed
   against its bound at 989 TFLOP/s; ``build_engine`` on the config
   through the eager ``_pipeline_batch`` and the graphed ``infer_batch``,
   each launching K1–K4 once and K8 12 times (a replay counted by kernel
   name), the replayed rows bit for bit the eager ones.

Prints the card's name and power limit, a JSON line of each kernel's
largest error and launches on every path (and K7's and K8's times), and
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
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

from tpudet3d_torch.parallel.sharding import (free_port, group_config,
                                              spawn_group)
from tpudet3d_torch.tools.cases import (
    EL0_CONFIG, FRAME, HBM_BYTES_PER_S, K1_CASES, K1_TOLS, K2_CASES, K2_TOLS,
    K3_CASES, K4_CASES, K4_REFINE, K6_CASES, K7_CASES, box_kps, compare_dets,
    compare_k4, cycle_ms, k1_frames, k2_case, k3_case, k4_inputs,
    k5_exact_cases, k5_fuzz_pairs, k6_input, k6_plan, k6_route, k7_input,
    max_err, max_leaf_err, moving_frames, plain_quant,
    projected_box_keypoints, recording_int8_convs, rotation, update_err,
    write_snapshots)
from tpudet3d_torch.utils import golden
from tpudet3d_torch.utils.profiling import (KERNEL_NAMES, device_events, drive,
                                            drive_replay, traced_launches)

FP32_FLOPS = 67e12             # H100 SXM, non-tensor float32, published
BF16_FLOPS = 989e12            # H100 SXM, dense bf16 tensor cores, published
INT8_OPS = 1979e12             # H100 SXM, dense int8 tensor cores, published
EVAL_FRAME = (1280, 720, 3)    # portrait frames of the evaluation phase
EVAL_EXAMPLES = 24             # per category
EVAL_CLASSES = ('bike', 'book')
# the evaluation phase's CLI settings: the defaults at det_tresh 0, the
# recall preset, and int8 serving at det_tresh 0
EVAL_SETTINGS = (('default', ['--det_tresh', '0']),
                 ('recall', ['--preset', 'recall']),
                 ('int8', ['--det_tresh', '0', '--int8']))
# float32 EPnP lift of exact box projections against the float64 lift: the
# CPU parity tests find ~1e-4 (tests/test_torch_port_box3d.py)
LIFT_TOL = 1e-3


def expect(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def time_ms(fn, iters):
    """Mean device time of ``fn`` over back-to-back calls (CUDA events,
    after one warm-up call; the L2 cache is not flushed)."""
    return cycle_ms([fn], iters)


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else \
        'operations'


def gpu_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check_k1(dev, frames, ops):
    """K1 against its plain version at N=1 and 16 of 720p and on every
    K1_CASES shape; returns the largest error."""
    resize_bilinear, resize_bilinear_plain = ops
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
    return err


def check_k2(dev, ops, norm):
    """K2 against its plain version on every K2_CASES entry with and
    without the mirror, in bf16 and f32; returns the largest error."""
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
    return err


def check_k3(dev, ops, anchors):
    """K3 against its plain version on every K3_CASES entry; returns the
    largest error."""
    decode_detections, decode_detections_plain = ops
    err = 0.0
    for case, *_ in K3_CASES:
        logits, deltas, kw = k3_case(case, dev)
        err = max(err, compare_dets(
            decode_detections(logits, deltas, anchors, **kw),
            decode_detections_plain(logits, deltas, anchors, **kw),
            f'K3 {case} N={logits.shape[0]}'))
    return err


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


def check_k4(dev, ops):
    """K4 against its plain version on every (B, NaNs and ties) of
    K4_CASES with TTA off and on, in refine and pack mode; returns the
    largest error."""
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
    return err


def check_k5(dev, ops):
    """K5 against its plain version at P=1, 8, 128 and 129 and on the
    exact cases, and against scipy on 32 pairs; returns the largest error
    against the plain version and against scipy."""
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
    return err, e_host


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
    from tpudet3d_torch.infer.quant import serve_int8
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
    for name, flags in EVAL_SETTINGS:
        args = parse_args(['--eval_data', '-', *flags])
        engine = engine_from_args(args)        # the card, full width
        if args.int8:
            # the CLI's calibration frames: each category's first frame
            serve_int8(engine, [data[cls][0][0] for cls in EVAL_CLASSES])
        engine.infer_batch(np.stack([e[0] for e in
                                     data[EVAL_CLASSES[0]][:args.batch]]))
        engines.append((name, args, engine))
    geometry.lift_2d_batched(torch.rand((8, 9, 2), device=dev),
                             portrait=True)                  # warm-up
    torch.cuda.synchronize()

    def evaluate():
        runs = []
        for name, args, engine in engines:
            for cls in EVAL_CLASSES:
                ev, timings = Recording(), {}
                t0 = time.perf_counter()
                evaluate_category(engine, iter(data[cls]), args.batch,
                                  args.vis_thresh, evaluator=ev,
                                  timings=timings)
                timings['wall'] = time.perf_counter() - t0
                runs.append((name, cls, ev, timings))
        return runs
    # the engines replay their graphs, which call no kernel wrapper: the
    # launches are counted by kernel name from a trace, warmed by a replay
    # of the first engine
    first = np.stack([e[0] for e in
                      data[EVAL_CLASSES[0]][:engines[0][1].batch]])
    runs, launches = traced_launches(
        wrappers, evaluate, warm=lambda: engines[0][2].infer_batch(first))
    print(f'evaluation path: {len(EVAL_SETTINGS)} settings x '
          f'{len(EVAL_CLASSES)} categories x {EVAL_EXAMPLES} examples of '
          f'{EVAL_FRAME[0]}x{EVAL_FRAME[1]}, launches K1-K7 = {launches}')
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
    for name, _ in EVAL_SETTINGS:
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


# Phase 6: the flagship regressor config (cases.EL0_CONFIG), its 288²
# variant, the frames of the demo loop (cases.moving_frames) and of the
# Detector
R288_CONFIG = 'configs/scene_regressor_el0_r288.py'
DEMO_FRAMES = 32
DETECTOR_FRAMES = 4


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
    """Expect equal rows; returns the largest |a - b| over their values."""
    err = 0.0
    for r, q in zip(a, b):
        for k in r:
            expect(np.array_equal(r[k], q[k]), f'{what}: {k} differs')
            if np.size(r[k]):
                err = max(err, float(np.abs(np.float64(r[k])
                                             - np.float64(q[k])).max()))
    return err


def flagship_path(dev, wrappers, frames_np, plain, norm):
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
    resize, crop, decode, epilogue = wrappers[:4]
    h, w = FRAME[:2]
    out = {'launches': {}}

    def counted(name, fn, expected, replayed=False):
        """``fn()`` counted by :func:`drive`, or by :func:`drive_replay`
        where it is a graphed ``infer_batch``."""
        res, n = (drive_replay if replayed else drive)(wrappers, fn)
        print(f'phase 6 {name}: launches K1-K7 = {n}')
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
                    per_pass(engine, 1), replayed=True)
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
        frames_np), per_pass(r288, 1), replayed=True)
    check_results(res, h, w)
    expect(sum(len(r['scores']) for r in res) > 0, 'r288: no detection')
    del r288

    # (d) the demo loop: pipelined engine and tracker over moving frames
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

    # (e) split inference: the Detector wrapper (K1, K3)
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


# Phase 7: int8 serving, on K6's and K7's cases (cases.K6_CASES, K7_CASES)
def check_int8_kernels(dev, quant_ops):
    """K6 and K7 against their plain versions, bit for bit, on every
    K6_CASES and K7_CASES entry in bf16 and f32; torch._int_mm on the
    int8 conv's operand layout against the exact product (float64 holds
    every sum below 2^53).  Returns the case count and the largest
    |kernel - plain| of K6 (in int8 steps) and of K7 (in its dtype)."""
    qops = quant_ops
    n_cases, k6_err, k7_err, routes = 0, 0, 0.0, set()
    for case, *_ in K6_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for cl in (True, False):
                x, k, stride, pad = k6_input(case, dtype, dev, cl)
                route = k6_plan(qops, x, k, stride, pad).route
                expect(route == k6_route(case, dtype, cl),
                       f'K6 {case} {dtype} channels_last={cl} takes {route}')
                routes.add(route)
                for s_x in (127.0, 3.7):
                    out = qops.quantize_input(x, s_x, k, stride, pad)
                    ref = qops.quantize_input_plain(x, s_x, k, stride, pad)
                    k6_err = max(k6_err, int8_err(out, ref))
                    expect(torch.equal(out, ref), f'K6 {case} {dtype} '
                           f's_x={s_x} channels_last={cl} ({route}) '
                           f'disagrees: {int((out != ref).sum())} of '
                           f'{out.numel()}')
                    n_cases += 1
    expect(routes == {'rows', 'staged', 'strided'}, f'K6 routes {routes}')
    for case, *_ in K7_CASES:
        y, scale, bias = k7_input(case, dev)
        for dtype in (torch.bfloat16, torch.float32):
            out = qops.rescale(y, scale, bias, dtype)
            ref = qops.rescale_plain(y, scale, bias, dtype)
            k7_err = max(k7_err, max_err(out, ref))
            expect(out.is_contiguous() and torch.equal(out, ref),
                   f'K7 {case} {dtype} disagrees: '
                   f'{int((out != ref).sum())} of {out.numel()}')
            n_cases += 1
    print(f'K6 and K7: {n_cases} cases, kernel == plain bit for bit (K6 on '
          'the rows, staged and strided routes)')
    gen = torch.Generator(device=dev).manual_seed(5)
    # the last two: widths that cuBLASLt refuses at these rows (72 and 24,
    # odd multiples of 8), padded as int8_weight pads them
    padded = lambda n: -(-n // qops.N_ALIGN) * qops.N_ALIGN  # noqa: E731
    for m, kp, n in ((17, 32, 320), (49, 1152, 320), (6272, 1152, 320),
                     (6272, 160, 960), (1600, 32, 16), (50176, 48, 128),
                     (200704, 32, padded(72)), (50176, 32, padded(24))):
        a = torch.randint(-127, 128, (m, kp), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, kp), generator=gen, device=dev,
                          dtype=torch.int8)
        got = torch._int_mm(a, w.t())
        exact = (a.double() @ w.double().t()).long()
        expect(got.dtype == torch.int32 and torch.equal(got.long(), exact),
               f'torch._int_mm [{m},{kp}]x[{kp},{n}] is not the exact product')
    print('torch._int_mm: equal to the exact product at M = 17 to 200704, '
          'K up to 1152')
    # why the weight is padded: the same widths unpadded (not an error
    # here; a torch or CUDA that takes them is reported)
    refused = {}
    for m, n in ((200704, 72), (50176, 24)):
        a = torch.zeros((m, 32), device=dev, dtype=torch.int8)
        w = torch.zeros((n, 32), device=dev, dtype=torch.int8)
        try:
            torch._int_mm(a, w.t())
            torch.cuda.synchronize()
            refused[f'M={m} N={n}'] = False
        except RuntimeError as e:
            refused[f'M={m} N={n}'] = str(e).splitlines()[0][:120]
    print(f'torch._int_mm unpadded: {refused}')
    return dict(cases=n_cases, k6_err=k6_err, k7_err=k7_err,
                int_mm_unpadded_refused=refused)


def int8_err(a, b):
    """Largest |a - b| of two int8 tensors, in int8 steps."""
    return int((a.int() - b.int()).abs().max())


def int8_kernel_times(qops, calls):
    """K6, torch._int_mm and K7 over the int8 convs of one serving call
    (``calls`` from recording_int8_convs): K6's route of every conv, none
    ``strided``; K6's and K7's largest |kernel - plain| at these shapes;
    K7's and ``_int_mm``'s device ms per call from the profiler,
    back-to-back ms, K7's plain version's ms, each one's bound (bytes:
    every input read once, every output written once; K7 reads the N
    columns of each row that it rescales, not the padded width) and, for
    K7, the library call ``torch.mul(y[:, :N], scale)``.  No served conv
    has a bias (``ConvBN``), so that product is K7's whole function there;
    it is checked bit for bit against the plain version.  K6's own times
    are ``tools/k6_bench.py``'s."""
    mm_args, k7_args, lib_args = [], [], []
    k7_bytes = k7_ops = mm_ops = mm_bytes = 0
    k6_err, k7_err, conv_routes = 0, 0.0, []
    for x, layer, s_x in calls:
        expect(layer.bias is None, 'a served int8 conv has a bias')
        args = (x, s_x, layer.kernel_size, layer.stride, layer.padding)
        route = k6_plan(qops, x, *args[2:]).route
        expect(route != 'strided', f'a served conv of input '
               f'{tuple(x.shape)} {x.stride()} takes the strided route')
        conv_routes.append(f'{"x".join(map(str, x.shape))} '
                           f'k{layer.kernel_size[0]} {route}')
        rows = qops.quantize_input(*args)
        k6_err = max(k6_err, int8_err(rows, qops.quantize_input_plain(*args)))
        w, scale = qops.int8_weight(layer, s_x)
        y = torch._int_mm(rows, w.t())
        mm_args.append((rows, w.t()))
        k7_args.append((y, scale, None, x.dtype))
        n = scale.numel()
        lib_args.append((y[:, :n], scale.to(x.dtype)))
        ref = qops.rescale_plain(*k7_args[-1])
        k7_err = max(k7_err, max_err(qops.rescale(*k7_args[-1]), ref))
        expect(torch.equal(torch.mul(*lib_args[-1]), ref),
               'torch.mul(y, scale) differs from the plain K7')
        k7_bytes += y.shape[0] * n * (4 + x.element_size()) + n * 4
        k7_ops += 2 * y.shape[0] * n
        mm_ops += 2 * rows.shape[0] * rows.shape[1] * w.shape[0]
        mm_bytes += rows.numel() + w.numel() + y.numel() * 4
    k7 = lambda: [qops.rescale(*a) for a in k7_args]  # noqa: E731
    library = lambda: [torch.mul(*a) for a in lib_args]  # noqa: E731
    mm = lambda: [torch._int_mm(a, b) for a, b in mm_args]  # noqa: E731
    return {'K6': dict(launches_per_call=len(calls), err=k6_err,
                       conv_routes=conv_routes),
            'K7': dict(launches_per_call=len(calls), err=k7_err,
                       ms=time_ms(k7, 10), device_ms=profile_call(k7, 10)[1],
                       plain_ms=time_ms(lambda: [qops.rescale_plain(*a) for
                                                 a in k7_args], 3),
                       bound=bound_ms(k7_bytes, k7_ops, FP32_FLOPS),
                       bytes=k7_bytes, library_ms=time_ms(library, 10),
                       library_device_ms=profile_call(library, 10)[1]),
            'int_mm': dict(device_ms=profile_call(mm, 10)[1],
                           ms=time_ms(mm, 10), tera_ops=mm_ops / 1e12,
                           bytes=mm_bytes,
                           bound_ms=max(mm_ops / INT8_OPS,
                                        mm_bytes / HBM_BYTES_PER_S) * 1e3)}


def row_drift(got, ref):
    """Box and keypoint drift of int8 rows against bf16 rows of the same
    frames: each int8 row against the bf16 row of its frame whose box
    overlaps it most (IoU > 0.5); keypoints in pixels of the box."""
    box, kp, n, n_rows = [], [], 0, 0
    for g, r in zip(got, ref):
        n_rows += len(g['scores'])
        if not len(g['scores']) or not len(r['scores']):
            continue
        lo = np.maximum(g['boxes'][:, None, :2], r['boxes'][None, :, :2])
        hi = np.minimum(g['boxes'][:, None, 2:], r['boxes'][None, :, 2:])
        inter = np.prod(np.clip(hi - lo, 0, None), -1)
        area = lambda b: np.prod(b[:, 2:] - b[:, :2], -1)  # noqa: E731
        iou = inter / (area(g['boxes'])[:, None] + area(r['boxes'])[None]
                       - inter)
        j, m = iou.argmax(1), iou.max(1) > 0.5
        n += int(m.sum())
        box.append(np.abs(g['boxes'][m] - r['boxes'][j[m]]).ravel())
        side = (g['boxes'][m, 2:] - g['boxes'][m, :2])[:, None, :]
        kp.append((np.abs(g['kp'][m] - r['kp'][j[m]]) * side).ravel())
    box, kp = np.concatenate(box), np.concatenate(kp)
    stat = lambda v: dict(mean=float(v.mean()), p95=float(  # noqa: E731
        np.percentile(v, 95)), max=float(v.max())) if len(v) else None
    return dict(rows=n_rows, matched=n, box_px=stat(box), kp_px=stat(kp))


def int8_ab_times(engine, dev, scales, iters):
    """Server frames/s at batch 16 and blocked single-frame p50 latency,
    bf16 and int8 in turns (bf16, int8, int8, bf16), on 16 seeded frames
    already on the card."""
    h, w = FRAME[:2]
    gen = torch.Generator(device=dev).manual_seed(3)
    frames = torch.randint(0, 256, (16, *FRAME), dtype=torch.uint8,
                           device=dev, generator=gen)
    runs = {'bf16': [], 'int8': []}
    for mode in ('bf16', 'int8', 'int8', 'bf16'):
        engine.cfg.det_int8_scales, engine.cfg.reg_int8_scales = \
            scales if mode == 'int8' else (None, None)
        engine._pipeline_batch(frames, h, w)
        torch.cuda.synchronize()
        fps = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                engine._pipeline_batch(frames, h, w)
            torch.cuda.synchronize()
            fps.append(16 * iters / (time.perf_counter() - t0))
        lat = []
        for _ in range(2 * iters):
            t0 = time.perf_counter()
            engine._pipeline(frames[0], h, w)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        runs[mode].append(dict(fps_b16=float(np.median(fps)),
                               latency_ms_p50=float(np.median(lat))))
    engine.cfg.det_int8_scales, engine.cfg.reg_int8_scales = scales
    return runs


def int8_path(dev, wrappers, frames_np, iters):
    """Phase 7: int8 serving of MNv3-large-21k (the default build) and of
    el0 from the phase-6 snapshots at batch 16 of 720p, each calibrated by
    ``calibrate_engine`` on the phase's frames; the export of el0 from its
    snapshot through tools/export.py.  Returns its numbers."""
    import os
    import tempfile
    from tpudet3d_torch.infer import build_engine, quant
    from tpudet3d_torch.infer.export import load_exported, make_export_fn
    from tpudet3d_torch.ops import quant as qops
    from tpudet3d_torch.tools import export as export_cli
    h, w = FRAME[:2]
    out = {'kernels': check_int8_kernels(dev, qops), 'launches': {}}
    engines = {'mnv3': build_engine(det_conf=0.0, device=dev)}
    with tempfile.TemporaryDirectory() as root:
        paths = write_snapshots(root)[0]
        engines['el0'] = build_engine(
            EL0_CONFIG, det_checkpoint=paths['detector'],
            reg_checkpoint=paths['regressor'], det_conf=0.0, device=dev)
        # the el0 regressor exported from its snapshot, reloaded, against
        # the served module in eager mode
        dest = os.path.join(root, 'export')
        export_cli.main(['--config', EL0_CONFIG, '--snapshot',
                         paths['regressor'], '--model_export_path', dest,
                         '--img_size', '224', '224', '--batch_size', '8'])
        reloaded = load_exported(dest)
        raw = torch.randint(0, 256, (8, 224, 224, 3), dtype=torch.uint8,
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(8))
        eager = make_export_fn(engines['el0'].reg_model)
        with torch.no_grad(), cudnn_deterministic():
            pairs = list(zip(reloaded(raw), eager(raw)))
        errs = [max_err(a, b) for a, b in pairs]
        size = os.path.getsize(os.path.join(dest, 'model.pt2'))
        print(f'el0 exported from its snapshot: {size} bytes; reloaded '
              f'against eager on 8 crops, held bit for bit: kp {errs[0]:.3g},'
              f' logits {errs[1]:.3g}')
        expect(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
               f'the exported el0 disagrees with eager: {errs}')
        out['export'] = dict(kp_err=errs[0], logits_err=errs[1])
    for name, engine in engines.items():
        bf16 = engine.infer_batch(frames_np)
        scales = quant.serve_int8(engine, list(frames_np))
        n_q = [len(quant.quantized_conv_paths(m)) for m in
               (engine.det_model, engine.reg_model)]
        expect(len(scales[1]) > 0, f'{name}: the regressor was not '
               'calibrated (no detection)')
        frames = engine._upload(frames_np)

        def eager():
            return engine._readback([engine._pipeline_batch(frames, h, w)])
        # the main path's int8 rows come from a replay (the switch is part
        # of the graph's key); a replayed graph runs no Python, so the
        # plain K6/K7 and the recorder below see the eager path on the
        # uploaded frames, which the replay must equal
        with cudnn_deterministic():
            res, n = drive_replay(wrappers,
                                  lambda: engine.infer_batch(frames_np))
            again = eager()
            with plain_quant(qops):
                plain = eager()
        print(f'phase 7 {name} int8 infer_batch(16): launches '
              f'K1/K2/K3/K4/K5/K6/K7 = {n} ({n_q[0]} + {n_q[1]} '
              'quantized convs)')
        expect(n == [1, 1, 1, 1, 0, sum(n_q), sum(n_q)],
               f'{name} int8: launches {n}')
        out['launches'][name] = n
        check_results(res, h, w)
        expect(sum(len(r['scores']) for r in res) > 0, f'{name}: no row')
        same_results(res, again, f'{name} int8 replayed against eager')
        rows_err = same_results(again, plain,
                                f'{name} int8 against the plain K6/K7')
        drift = row_drift(res, bf16)
        print(f'{name} int8 against bf16 on 16 frames: {drift}')
        with recording_int8_convs(quant) as calls:
            engine._pipeline_batch(frames, h, w)
        times = int8_kernel_times(qops, calls)
        profile = {}
        for mode in ('bf16', 'int8'):
            engine.cfg.det_int8_scales, engine.cfg.reg_int8_scales = \
                scales if mode == 'int8' else (None, None)
            profile[mode] = dict(zip(('events_per_call', 'device_ms'),
                                     profile_call(lambda: engine
                                                  ._pipeline_batch(
                                                      frames, h, w), 10)))
        serving = int8_ab_times(engine, dev, scales, max(iters // 2, 1))
        print(f'{name} serving batch 16 bf16 / int8: {serving}; per call '
              f'{profile}; K6 {times["K6"]["err"]} from its plain version '
              f'over {len(calls)} served convs; K7 {times["K7"]}; _int_mm '
              f'{times["int_mm"]}')
        out[name] = dict(scales=[len(s) for s in scales], drift=drift,
                         times=times, profile=profile, serving=serving,
                         quantized_convs=n_q, rows_err=rows_err)
        del engine
    engines.clear()
    return out


# phase 8: regressor training at full width
TRAIN_CONFIGS = (('mnv3', 'configs/scene_regressor.py'),
                 ('el0', 'configs/scene_regressor_el0_ema.py'))
TRAIN_BATCH = 128
TRAIN_STEPS = 30
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED = 5, 20, 5
# the card's f32 step against the CPU's: MNv3-large-21k, batch 8, 2 steps.
# cuDNN's and oneDNN's f32 convolutions and batch norms reduce in other
# orders, and a train-mode batch norm at batch 8 amplifies it toward the
# stem: the loss and metrics within 1e-4 relative; the gradients within
# 1e-3 of their norm over the whole model, and each tensor within 1e-2 of
# its largest plus 1e-4 of the model's largest (a gradient that is 0 in
# exact arithmetic is rounding noise on either device); running variances
# and the ALWA state within 1e-4 relative, running means within 1e-4 of
# their channel's running std; the parameters by Adam's sign rule
# (tests/test_torch_port_train.py).  A float64 CPU step beside them says
# how far each float32 step is from exact.
CARD_CPU_BATCH = 8
CARD_CPU_TOL = dict(metrics=1e-4, grad_norm=1e-3, grad=1e-2, grad_floor=1e-4,
                    stats=1e-4)


def train_batch(cfg, n, dev, seed):
    """n normalised NHWC float32 images of noise, the keypoints of boxes
    projected as portrait frames are, and categories, from ``seed``."""
    rng = np.random.RandomState(seed)
    h, w = cfg.data.resize
    imgs = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    kp = projected_box_keypoints(n, seed)
    cats = rng.randint(0, 9, n)
    return (torch.from_numpy(imgs).to(dev), torch.from_numpy(kp).to(dev),
            torch.from_numpy(cats).long().to(dev))


def train_parts(cfg, dev, seed=0):
    from tpudet3d_torch.train import (create_train_state, make_eval_step,
                                      make_train_step)
    state = create_train_state(cfg, device=dev,
                               generator=torch.Generator().manual_seed(seed))
    step = make_train_step(state.model, state.loss_manager, state.optimizer,
                           ema_decay=state.ema_decay)
    return state, step, make_eval_step(state.model)


def rel_err(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def grad_norm_err(a, b):
    """||a - b|| / ||b|` over every parameter's gradient."""
    num = sum(float(((x.grad.detach().cpu().double()
                      - y.grad.detach().cpu().double()) ** 2).sum())
              for x, y in zip(a.parameters(), b.parameters()))
    den = sum(float((y.grad.detach().cpu().double() ** 2).sum())
              for y in b.parameters())
    return (num / den) ** 0.5


def card_against_cpu(dev, config):
    """Two f32 train steps of MNv3-large-21k on the card and on the CPU from
    the same weights, batch and dropout masks (one CPU generator seed for
    both), ALWA on with C = 1 (it fires on the second step; ver_2, since
    ver_1 at C = 1 takes the sqrt of a zero variance), and a float64 CPU
    step beside them.  Before the second step the card and the float64
    model take the CPU's parameters (they differ only where Adam's sign
    rule moved rounding noise apart).  Returns the largest errors seen."""
    from tpudet3d_torch.core.config import read_py_config
    cfg = read_py_config(config)
    cfg.model.bf16 = False
    cfg.loss.coeffs = ([1., .1], [1.])
    cfg.loss.alwa = dict(use=True, lam_cls=1., lam_reg=1., C=1,
                         compute_std=False)
    cpu = train_parts(cfg, 'cpu')
    card = train_parts(cfg, dev)
    f64 = train_parts(cfg, 'cpu')
    f64[0].model.double()
    f64[0].model.dtype = torch.float64
    imgs, kp, cats = train_batch(cfg, CARD_CPU_BATCH, 'cpu', seed=5)
    lr = float(cfg.optim.lr)
    errs = dict(metrics=0.0, grad_norm=0.0, grad=0.0, grad_norm_cpu_f64=[],
                grad_norm_card_f64=[], param=0.0, param_bound_share=0.0,
                stats=0.0, alwa=0.0)
    moved = {}
    with cudnn_deterministic():
        for i in range(2):
            (s_cpu, m_cpu) = cpu[1](cpu[0], imgs, kp, cats,
                                    torch.Generator().manual_seed(10 + i))
            (s_dev, m_dev) = card[1](card[0], imgs.to(dev), kp.to(dev),
                                     cats.to(dev),
                                     torch.Generator().manual_seed(10 + i))
            (s_64, m_64) = f64[1](f64[0], imgs, kp, cats,
                                  torch.Generator().manual_seed(10 + i))
            e = rel_err(m_dev, m_cpu)
            expect(e <= CARD_CPU_TOL['metrics'],
                   f'card vs CPU step {i}: metrics {e}')
            errs['metrics'] = max(errs['metrics'], e)
            norm = grad_norm_err(s_dev.model, s_cpu.model)
            errs['grad_norm_cpu_f64'].append(
                grad_norm_err(s_cpu.model, s_64.model))
            errs['grad_norm_card_f64'].append(
                grad_norm_err(s_dev.model, s_64.model))
            errs['grad_norm'] = max(errs['grad_norm'], norm)
            p_cpu = dict(s_cpu.model.named_parameters())
            g_max = max(p.grad.abs().max().item() for p in p_cpu.values())
            worst = []
            for name, p in s_dev.model.named_parameters():
                g, r = p.grad.detach().cpu(), p_cpu[name].grad
                err = (g - r).abs()
                tol = (CARD_CPU_TOL['grad'] * r.abs().max().item()
                       + CARD_CPU_TOL['grad_floor'] * g_max)
                worst.append((err.max().item() / tol, name,
                              err.max().item(), r.abs().max().item()))
                errs['grad'] = max(errs['grad'], err.max().item()
                                   / max(r.abs().max().item(), 1e-30))
                rel = (err + CARD_CPU_TOL['grad_floor'] * g_max) / (
                    torch.maximum(g.abs(), r.abs()) + 1e-8)
                moved[name] = torch.clamp(moved.get(name, 0.0) + 3 * rel,
                                          max=2.0 * (i + 1))
                d = (p.detach().cpu() - p_cpu[name].detach()).abs()
                bound = 1e-6 + lr * moved[name]
                expect(bool((d <= bound).all()),
                       f'card vs CPU step {i}: {name} beyond the Adam bound')
                errs['param'] = max(errs['param'], d.max().item())
                errs['param_bound_share'] = max(
                    errs['param_bound_share'], (d / bound).max().item())
            worst.sort(reverse=True)
            print(f'card vs CPU step {i}: loss {float(m_cpu[0]):.6f} (CPU) '
                  f'{float(m_dev[0]):.6f} (card) {float(m_64[0]):.6f} '
                  f'(CPU f64); gradients, ||card - CPU|| / ||CPU|| '
                  f'{norm:.3g}, ||CPU - f64|| / ||f64|| '
                  f'{errs["grad_norm_cpu_f64"][-1]:.3g}, ||card - f64|| / '
                  f'||f64|| {errs["grad_norm_card_f64"][-1]:.3g}; largest '
                  f'gradient {g_max:.3g}; nearest the per-tensor bound '
                  f'(share, name, |error|, largest |gradient|): {worst[:3]}')
            expect(norm <= CARD_CPU_TOL['grad_norm'],
                   f'card vs CPU step {i}: gradient norm error {norm}')
            expect(worst[0][0] <= 1.0,
                   f'card vs CPU step {i}: gradients beyond the bound')
            sd_cpu = s_cpu.model.state_dict()
            for name, t in s_dev.model.state_dict().items():
                if 'running' in name:
                    # a mean in units of its channel's spread: behind an
                    # identity batch norm and a conv it is 0 up to rounding
                    ref = sd_cpu[name]
                    scale = (sd_cpu[name.replace('_mean', '_var')].sqrt()
                             if name.endswith('running_mean') else ref)
                    e = ((t.cpu() - ref).abs().max()
                         / scale.abs().max()).item()
                    expect(e <= CARD_CPU_TOL['stats'],
                           f'card vs CPU step {i}: {name} {e}')
                    errs['stats'] = max(errs['stats'], e)
            for f in ('lam_cls', 'lam_reg', 'sum_cls', 'sumsq_cls',
                      'sum_reg', 'sumsq_reg', 'count'):
                e = rel_err(getattr(s_dev.alwa, f), getattr(s_cpu.alwa, f))
                expect(e <= CARD_CPU_TOL['stats'],
                       f'card vs CPU step {i}: ALWA {f} {e}')
                errs['alwa'] = max(errs['alwa'], e)
            expect(int(s_dev.step) == int(s_cpu.step) == i + 1,
                   'card vs CPU: step count')
            with torch.no_grad():
                for (name, p), q in zip(s_dev.model.named_parameters(),
                                        s_64.model.parameters()):
                    p.copy_(p_cpu[name])
                    q.copy_(p_cpu[name])
    expect(float(s_dev.alwa.lam_cls) != 1.0, 'card vs CPU: ALWA never fired')
    print(f'card vs CPU, MNv3-large-21k f32 at batch {CARD_CPU_BATCH}, 2 '
          f'steps: metrics {errs["metrics"]:.3g}, gradients '
          f'{errs["grad_norm"]:.3g} of their norm, {errs["grad"]:.3g} of '
          f'their tensor, parameters {errs["param"]:.3g} '
          f'({errs["param_bound_share"]:.3g} of the Adam bound), running '
          f'statistics {errs["stats"]:.3g}, ALWA {errs["alwa"]:.3g} '
          f'(tolerances {CARD_CPU_TOL})')
    return errs


def same_sums(a, b, rtol=1e-6):
    """Per-class float32 sums equal but for their order of addition."""
    return bool(((a - b).abs() <= rtol * b.abs()).all())


def eval_against_plain(dev, parts, batch, wrappers):
    """The eval step over the trained batch with ``compute_iou`` on (one K5
    launch, counted) and off (none), and on again through the plain K5:
    accuracy and counts equal, ADD and SADD equal but for the order of
    the card's atomic adds (1e-6), the IoU sums within 1e-5 a sample
    (phase 2's K5 bound)."""
    from tpudet3d_torch.eval import metrics
    from tpudet3d_torch.ops import box3d
    from tpudet3d_torch.train import eval_params
    state, _, eval_step = parts
    params = eval_params(state)
    with cudnn_deterministic():
        (sums, _), n_iou = drive(wrappers, lambda: eval_step(
            params, *batch, compute_iou=True))
        (no_iou, _), n_none = drive(wrappers, lambda: eval_step(
            params, *batch, compute_iou=False))
        kernel = metrics.iou_oriented_boxes
        metrics.iou_oriented_boxes = box3d.iou_oriented_boxes_plain
        try:
            plain, _ = eval_step(params, *batch, compute_iou=True)
        finally:
            metrics.iou_oriented_boxes = kernel
    expect(n_iou == [0, 0, 0, 0, 1, 0, 0],
           f'eval step with IoU: launches {n_iou}, want one K5')
    expect(n_none == [0] * 7, f'eval step without IoU: launches {n_none}')
    # the per-class sums are atomic adds on the card: their order, and so
    # a float sum's last bits, vary between calls
    for i in (3, 4):
        expect(torch.equal(sums[i], plain[i]) and
               torch.equal(sums[i], no_iou[i]), f'eval sums {i} differ')
    for i in (0, 1):
        expect(same_sums(sums[i], plain[i]) and same_sums(sums[i], no_iou[i]),
               f'eval sums {i} differ')
    counts = sums[4].cpu()
    iou_err = (sums[2] - plain[2]).abs().cpu()
    expect(bool((iou_err <= 1e-5 * counts
                 + 1e-6 * plain[2].abs().cpu()).all()),
           f'eval IoU sums against the plain K5: {iou_err.tolist()}')
    expect(int(counts.sum()) == batch[0].shape[0], 'eval counts')
    expect(bool(torch.isfinite(sums[2]).all()) and
           float(sums[2].sum()) / float(counts.sum()) <= 1.0, 'eval IoU')
    return dict(sums=sums, iou_err=iou_err.max().item(),
                mean_iou=float(sums[2].sum() / counts.sum()),
                mean_add=float(sums[0].sum() / counts.sum()),
                launches_iou=n_iou, launches_no_iou=n_none)


def train_times(parts, batch, gen):
    """:func:`step_times` of the regressor's train step at TRAIN_BATCH."""
    state, step, _ = parts
    return step_times(lambda: step(state, *batch, gen), TRAIN_BATCH)


def step_times(step, batch_size):
    """Median ms of ``step()`` over TRAIN_TIMED calls after TRAIN_WARMUP
    (CUDA events between calls, no host read inside), images/s at
    ``batch_size``, peak memory, and over TRAIN_PROFILED calls under
    ``torch.profiler`` the device busy time (the sum of kernel times; one
    stream), the idle share of that window (1 - busy / its wall time per
    call) and the kernel groups."""
    from torch.profiler import ProfilerActivity, profile

    from tpudet3d_torch.tools.profile_serving import group_of
    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_TIMED + 1)]
    events[0].record()
    for i in range(TRAIN_TIMED):
        step()
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    median = ms[len(ms) // 2] if len(ms) % 2 else \
        (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILED):
            step()
        torch.cuda.synchronize()
        profiled = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILED
    kernels = {}
    for e in device_events(prof):
        t, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(t for t, _ in kernels.values()) / TRAIN_PROFILED
    groups = {}
    for name, (t, n) in kernels.items():
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += t / TRAIN_PROFILED
        g[1] += n / TRAIN_PROFILED
    expect(busy > 0, 'the profiler saw no device time in the train steps')
    return dict(step_ms=median, step_ms_min=ms[0], step_ms_max=ms[-1],
                images_per_s=batch_size / median * 1e3,
                peak_memory_gib=peak, device_busy_ms=busy,
                profiled_step_ms=profiled,
                device_idle_share=max(0.0, 1.0 - busy / profiled),
                launches_per_step=sum(n for _, n in kernels.values())
                / TRAIN_PROFILED,
                groups_ms={k: v[0] for k, v in sorted(
                    groups.items(), key=lambda kv: -kv[1][0])},
                group_launches={k: v[1] for k, v in groups.items()})


def training_path(dev, wrappers, gpu):
    """Phase 8: regressor training at full width; returns its numbers."""
    import warnings

    from tpudet3d_torch.core.config import read_py_config
    from tpudet3d_torch.train import eval_params
    out = {'launches': {}}
    out['card_vs_cpu'] = card_against_cpu(dev, TRAIN_CONFIGS[0][1])
    for name, config in TRAIN_CONFIGS:
        cfg = read_py_config(config)
        expect(int(cfg.data.train_batch_size) == TRAIN_BATCH,
               f'{config}: batch')
        parts = train_parts(cfg, dev)
        state, step, eval_step = parts
        batch = train_batch(cfg, TRAIN_BATCH, dev, seed=3)
        gen = torch.Generator(device=dev).manual_seed(4)
        ema0 = (None if state.ema_params is None else
                {k: v.clone() for k, v in state.ema_params.items()})

        def thirty_steps():
            metrics = []
            t0 = time.perf_counter()
            # any synchronizing call inside a step warns
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    for _ in range(TRAIN_STEPS):
                        _s, m = step(state, *batch, gen)
                        metrics.append(m)
                finally:
                    torch.cuda.set_sync_debug_mode('default')
            syncs = [str(w.message) for w in caught
                     if 'called a synchronizing' in str(w.message)]
            with cudnn_deterministic():
                sums, _ = eval_step(eval_params(state), *batch)
            return (torch.stack(metrics).cpu(), syncs, sums,
                    time.perf_counter() - t0)

        (metrics, syncs, sums, secs), n = drive(wrappers, thirty_steps)
        out['launches'][f'{name} {TRAIN_STEPS} steps + eval'] = n
        ev = eval_against_plain(dev, parts, batch, wrappers)
        expect(all(same_sums(a, b, 1e-5) for a, b in zip(sums, ev['sums'])),
               f'{name}: the eval step is not repeatable')
        expect(not syncs, f'{name}: host syncs inside the steps: {syncs[:3]}')
        expect(n == [0, 0, 0, 0, 1, 0, 0],
               f'{name}: launches {n}, want K5 once (the eval step)')
        expect(bool(torch.isfinite(metrics).all()), f'{name}: metrics')
        first, last5 = float(metrics[0, 0]), float(metrics[-5:, 0].mean())
        expect(last5 < first, f'{name}: the loss did not fall: {first} → '
               f'{last5}')
        expect(int(state.step) == TRAIN_STEPS, f'{name}: step count')
        ev['sums'] = [x.tolist() for x in ev['sums']]
        r = dict(loss_first=first, loss_last5=last5,
                 metrics_last=metrics[-1].tolist(), eval=ev,
                 steps_s=secs, ema=state.ema_params is not None)
        if state.ema_params is not None:
            params = dict(state.model.named_parameters())
            moved = any(not torch.equal(state.ema_params[k], ema0[k])
                        for k in ema0)
            lags = any(not torch.equal(state.ema_params[k], params[k])
                       for k in ema0)
            expect(moved and lags, f'{name}: the EMA did not move or does '
                   f'not lag the parameters')
        r.update(train_times(parts, batch, gen))
        out[name] = r
        top = ', '.join(f'{g} {t:.2f}' for g, t in
                        list(r['groups_ms'].items())[:5])
        print(f'training {name} ({config}) on {gpu}: loss {first:.4f} → '
              f'{last5:.4f} (mean of the last 5 of {TRAIN_STEPS} steps); '
              f'step {r["step_ms"]:.2f} ms (median of {TRAIN_TIMED}), '
              f'{r["images_per_s"]:.1f} images/s at batch {TRAIN_BATCH}, '
              f'peak {r["peak_memory_gib"]:.2f} GiB, device busy '
              f'{r["device_busy_ms"]:.2f} ms a step of '
              f'{r["profiled_step_ms"]:.2f} profiled, idle share '
              f'{r["device_idle_share"]:.3f}, '
              f'{r["launches_per_step"]:.0f} launches a step; by group ms: '
              f'{top}; eval IoU {ev["mean_iou"]:.4f}, max |K5 - plain| '
              f'{ev["iou_err"]:.3g}')
        del parts, state, step, eval_step
        torch.cuda.empty_cache()
    return out


# phase 9: the training loop at full width (data path, epochs, validation,
# snapshots), configs/scene_regressor_el0_ema.py with what the time limit
# needs: SyntheticObjectron's items in place of SceneCrops (which renders a
# 640×480 scene on the host per item pair), 2048 of them, 2 epochs
LOOP_OVERRIDES = dict(synthetic=True, synthetic_length=2048, max_epochs=2,
                      save_freq=1, eval_freq=1)
LOOP_STEPS, LOOP_VAL_BATCHES = 16, 4
# the augmentations on the card against the CPU, relative after
# normalisation; a device warp moves with an ulp of its source coordinates
# times the image's gradient, so its bound grows with the image
# (tests/test_torch_port_data.py)
AUG_TOL, WARP_TOL = 1e-5, 1e-6    # the latter × max(h, w)
AUG_PROFILED = 5


class ScalarLog:
    """A stand-in for the trainer's summary writer: every scalar with the
    host clock when it was written (a step's metrics are read then)."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, global_step=None):
        self.rows.append((tag, float(value), global_step,
                          time.perf_counter()))

    def losses(self):
        return [(v, s, t) for tag, v, s, t in self.rows if tag == 'Train/loss']


def sync_checked(fn):
    """``fn`` with any synchronising CUDA call inside it an error."""
    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return guarded


def loop_config(out_dir):
    from tpudet3d_torch.core.config import read_py_config
    cfg = read_py_config(EL0_CONFIG)
    for k in ('synthetic', 'synthetic_length', 'max_epochs'):
        cfg.data[k] = LOOP_OVERRIDES[k]
    for k in ('save_freq', 'eval_freq'):
        cfg.utils[k] = LOOP_OVERRIDES[k]
    cfg.output_dir = out_dir
    return cfg


def train_state_copy(state):
    """Clones of every field ``resume_from`` restores."""
    import copy
    return dict(params={k: v.detach().clone() for k, v in
                        state.model.state_dict().items()
                        if not k.endswith('num_batches_tracked')},
                optimizer=copy.deepcopy(state.optimizer.state_dict()),
                alwa={f: getattr(state.alwa, f).clone() for f in
                      ('lam_cls', 'lam_reg', 'sum_cls', 'sumsq_cls',
                       'sum_reg', 'sumsq_reg', 'count')},
                step=state.step.clone(),
                ema={k: v.clone() for k, v in state.ema_params.items()})


def same_state(a, b, what):
    """Expect two ``train_state_copy`` s equal bit for bit."""
    for k, v in a['params'].items():
        expect(torch.equal(v, b['params'][k]), f'{what}: {k}')
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    expect(sa.keys() == sb.keys(), f'{what}: optimizer state keys')
    for i in sa:
        for k, v in sa[i].items():
            expect(torch.equal(torch.as_tensor(v).cpu(),
                               torch.as_tensor(sb[i][k]).cpu()),
                   f'{what}: optimizer state {i} {k}')
    expect([g['lr'] for g in a['optimizer']['param_groups']] ==
           [g['lr'] for g in b['optimizer']['param_groups']],
           f'{what}: learning rate')
    for k, v in a['alwa'].items():
        expect(torch.equal(v, b['alwa'][k]), f'{what}: ALWA {k}')
    expect(torch.equal(a['step'], b['step']), f'{what}: step')
    for k, v in a['ema'].items():
        expect(torch.equal(v, b['ema'][k]), f'{what}: EMA {k}')


def kernel_profile(fn, calls):
    """Device busy ms, launches and wall ms of ``calls`` calls of ``fn``
    under ``torch.profiler``; returns also the kernels by group."""
    from torch.profiler import ProfilerActivity, profile

    from tpudet3d_torch.tools.profile_serving import group_of
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, launches, groups, names = 0.0, 0, {}, {}
    for e in device_events(prof):
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        launches += 1
        for key, table in ((group_of(e.name), groups), (e.name, names)):
            g = table.setdefault(key, [0.0, 0])
            g[0] += ms
            g[1] += 1
    expect(busy > 0, 'the profiler saw no device time')

    def ranked(table, n=None):
        return dict(sorted(table.items(), key=lambda kv: -kv[1][0])[:n])
    return dict(busy_ms=busy, launches=launches, wall_ms=wall,
                idle_share=max(0.0, 1.0 - busy / wall),
                groups=ranked(groups), top_kernels=ranked(names, 8))


def check_augmentations(dev, cfg, imgs, kps):
    """The train pipelines (host warps or device warps) on the card
    against the same functions on the CPU, given the same draws."""
    from tpudet3d_torch.data.transforms import build_augmentations
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(11)
    for host_geometric in (True, False):
        aug = build_augmentations(cfg, host_geometric=host_geometric)[0]
        params = aug.sample(imgs.shape[0], gen, dev)
        out = aug.apply(imgs.to(dev), kps.to(dev), params)

        def cpu(tree):
            if isinstance(tree, dict):
                return {k: cpu(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [cpu(v) for v in tree]
            return tree.cpu()

        ref = aug.apply(imgs, kps, cpu(params))
        for name, a, b in zip(('images', 'keypoints'), out, ref):
            e = rel_err(a, b)
            tol = (AUG_TOL if host_geometric or name == 'keypoints'
                   else WARP_TOL * max(imgs.shape[1:3]))
            expect(e <= tol, f'augmentations (host_geometric='
                   f'{host_geometric}) {name}: card against CPU {e}')
            errs[f'{name} host_geometric={host_geometric}'] = e
    return errs


def loop_path(dev, wrappers, frames_np, gpu):
    """Phase 9: the regressor's training loop at full width; returns its
    numbers."""
    import os
    import tempfile

    from tpudet3d_torch.core.prng import set_random_seed
    from tpudet3d_torch.eval.evaluator import Evaluator
    from tpudet3d_torch.infer import build_engine
    from tpudet3d_torch.train import current_learning_rate
    from tpudet3d_torch.train.pipeline import setup_training
    from tpudet3d_torch.train.trainer import Trainer
    from tpudet3d_torch.utils.checkpoint import resume_from, save_snap
    out = {'launches': {}, 'overrides': LOOP_OVERRIDES}
    root = tempfile.mkdtemp(prefix='loop_')
    cfg = loop_config(root)
    seed = set_random_seed(int(cfg.utils.random_seeds))
    pipe = setup_training(cfg, device=dev, seed=seed)
    state = pipe.state
    expect(len(pipe.train_loader) == LOOP_STEPS and
           len(pipe.val_loader) == LOOP_VAL_BATCHES,
           f'loader lengths {len(pipe.train_loader)}, {len(pipe.val_loader)}')
    try:
        import cv2
        out['cv2'] = cv2.__version__
    except ImportError:
        out['cv2'] = None
    # the geometric augmentations run in the loader threads with cv2 and
    # are off without it, as in the JAX package
    expect((pipe.train_loader.host_transform is None) == (out['cv2'] is None),
           f'host warps with cv2 {out["cv2"]}')
    log = ScalarLog()
    puts, batches = [], []

    def put(imgs, kps, cats):
        puts.append(time.perf_counter())
        if len(batches) < 1:
            batches.append((imgs, kps, cats))
        return pipe.put_fn(imgs, kps, cats)

    trainer = Trainer(train_step=sync_checked(pipe.train_step), state=state,
                      train_loader=pipe.train_loader,
                      lr_schedule=pipe.lr_schedule, writer=log,
                      max_epoch=int(cfg.data.max_epochs), log_path=root,
                      put_fn=put, generator=torch.Generator(
                          device=dev).manual_seed(seed),
                      save_freq=int(cfg.utils.save_freq), print_freq=8)
    evaluator = Evaluator(eval_step=pipe.eval_step,
                          state_fn=lambda: trainer.state,
                          val_loader=pipe.val_loader, test_loader=None,
                          test_transform=pipe.test_aug, put_fn=pipe.put_fn)
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}

    def counted(name, fn, k5=0):
        res, n = drive(wrappers, fn)
        out['launches'][name] = n
        expect(n == [0, 0, 0, 0, k5, 0, 0],
               f'{name}: launches {n}, want K5 {k5} and no other')
        return res

    epochs = {}
    for epoch in range(int(cfg.data.max_epochs)):
        last = epoch == int(cfg.data.max_epochs) - 1
        n_log, n_put = len(log.losses()), len(puts)
        counted(f'train epoch {epoch}', lambda: trainer.train(epoch, last))
        losses = log.losses()[n_log:]
        expect(len(losses) == LOOP_STEPS and len(puts) - n_put == LOOP_STEPS,
               f'epoch {epoch}: {len(losses)} steps')
        expect(all(np.isfinite(v) for v, _, _ in losses) and all(
            np.isfinite(v) for _, v, _, _ in log.rows), 'non-finite metrics')
        lr = current_learning_rate(state.optimizer)
        expect(lr == pipe.lr_schedule(epoch), f'epoch {epoch}: lr {lr}')
        expect(os.path.isfile(os.path.join(root, f'snap_{epoch}.pt')),
               f'snap_{epoch}.pt not written')
        if epoch == 0:
            after0 = train_state_copy(state)
        t0 = time.perf_counter()
        val = counted(f'val epoch {epoch}', lambda: evaluator.val(epoch, last),
                      k5=LOOP_VAL_BATCHES if last else 0)
        expect(all(np.isfinite(v) for v in val), f'val epoch {epoch}')
        epochs[epoch] = dict(
            loop_s=losses[-1][2] - puts[n_put],
            images_per_s=LOOP_STEPS * TRAIN_BATCH
            / (losses[-1][2] - puts[n_put]),
            loss_first=losses[0][0], loss_last=losses[-1][0], lr=lr,
            val=dict(zip(('ADD', 'SADD', 'ACC', 'IOU'), map(float, val))),
            val_s=time.perf_counter() - t0)
    out['epochs'] = epochs
    moved = any(not torch.equal(state.ema_params[k], ema0[k]) for k in ema0)
    params = dict(state.model.named_parameters())
    lags = any(not torch.equal(state.ema_params[k], params[k]) for k in ema0)
    expect(moved and lags, 'the EMA did not move or does not lag')
    expect(int(state.step) == 2 * LOOP_STEPS, 'step count')

    # the validation IoU of one batch through the kernel and the plain K5
    imgs, kps, cats = pipe.put_fn(*batches[0])
    vimgs, vkps = pipe.test_aug(imgs, kps, torch.Generator(
        device=dev).manual_seed(1))
    ev = eval_against_plain(dev, (state, None, pipe.eval_step),
                            (vimgs, vkps, cats), wrappers)
    out['val_iou_err'] = ev['iou_err']

    # the augmentations on the card against the CPU, the same draws
    out['aug_err'] = check_augmentations(dev, cfg, *(
        torch.from_numpy(np.asarray(a)) for a in batches[0][:2]))

    # resume: snap_0 into a fresh state is the state after epoch 0
    fresh = setup_training(cfg, device=dev, seed=seed, with_loaders=False)
    t0 = time.perf_counter()
    _, start = resume_from(fresh.state,
                           os.path.join(root, 'snap_0.pt'))
    out['resume_s'] = time.perf_counter() - t0
    expect(start == 1, f'resume: start epoch {start}')
    same_state(train_state_copy(fresh.state), after0, 'resume from snap_0')
    del fresh
    t0 = time.perf_counter()
    save_snap(state, 99, tempfile.mkdtemp(prefix='snap_'))
    out['save_snap_s'] = time.perf_counter() - t0

    # serve the trained snapshot: build_engine finds snap_1.pt, the EMA
    reg_cfg = os.path.join(root, 'reg_config.py')
    with open(reg_cfg, 'w') as f:
        f.write(f'exec(open({os.path.abspath(EL0_CONFIG)!r}).read())\n'
                f'output_dir = {root!r}\n')
    engine = build_engine(reg_cfg, det_conf=0.0, device=dev)
    served = engine.reg_model.state_dict()
    for k, v in state.model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            want = state.ema_params.get(k, v)
            expect(torch.equal(served[k], want), f'served {k} is not the '
                   f'trained EMA')
    res, n = drive_replay(wrappers, lambda: engine.infer_batch(frames_np))
    out['launches']['trained el0 infer_batch(16)'] = n
    expect(n == [1, 1, 1, 1, 0, 0, 0], f'serving the trained snapshot: '
           f'launches {n}')
    check_results(res, *FRAME[:2])
    del engine

    # numbers: the loader alone, validation, the step alone, the loop's
    # busy and idle share, the augmentations
    t0 = time.perf_counter()
    n_img = sum(b[0].shape[0] for b in pipe.train_loader)
    out['loader_images_per_s'] = n_img / (time.perf_counter() - t0)
    for iou in (False, True):
        t0 = time.perf_counter()
        counted(f'val iou={iou}', lambda: evaluator.val(None, iou),
                k5=LOOP_VAL_BATCHES if iou else 0)
        out[f'val_examples_per_s_iou_{iou}'] = (
            len(pipe.val_loader.dataset) / (time.perf_counter() - t0))
    trainer.save_chkpt = False
    loop = kernel_profile(lambda: trainer.train(2, False), 1)
    loop['images_per_s'] = LOOP_STEPS * TRAIN_BATCH / loop['wall_ms'] * 1e3
    out['profiled_epoch'] = loop
    gen = torch.Generator(device=dev).manual_seed(3)
    out['aug'] = kernel_profile(lambda: pipe.train_aug(imgs, kps, gen),
                                AUG_PROFILED)
    for k in ('busy_ms', 'launches', 'wall_ms'):
        out['aug'][k] /= AUG_PROFILED
    out['step'] = train_times((state, pipe.train_step, None),
                              (imgs, kps, cats), gen)
    e1, st = epochs[1], out['step']
    print(f'training loop el0 ({EL0_CONFIG}, {LOOP_OVERRIDES}) on {gpu}: '
          f'epoch 1 {e1["images_per_s"]:.1f} images/s (loss '
          f'{e1["loss_first"]:.4f} → {e1["loss_last"]:.4f}), loader alone '
          f'{out["loader_images_per_s"]:.1f} images/s, step alone '
          f'{st["step_ms"]:.2f} ms ({st["images_per_s"]:.1f} images/s, '
          f'peak {st["peak_memory_gib"]:.2f} GiB); a profiled epoch '
          f'{loop["images_per_s"]:.1f} images/s, device busy '
          f'{loop["busy_ms"]:.1f} of {loop["wall_ms"]:.1f} ms (idle share '
          f'{loop["idle_share"]:.3f}); augmentations {out["aug"]["launches"]:.0f} '
          f'launches, {out["aug"]["busy_ms"]:.3f} ms a step on the device; '
          f'validation {out["val_examples_per_s_iou_False"]:.1f} / '
          f'{out["val_examples_per_s_iou_True"]:.1f} examples/s without / '
          f'with the IoU; save_snap {out["save_snap_s"]:.2f} s, resume_from '
          f'{out["resume_s"]:.2f} s; |K5 - plain| {ev["iou_err"]:.3g}; '
          f'cv2 {out["cv2"]}; '
          f'augmentations card vs CPU {max(out["aug_err"].values()):.3g}')
    return out


# phase 10: detector training at full width.  The flagship cascade config
# with what the time limit needs: SyntheticDetection(hard) items in place
# of the 640×480 scene renders, 1024 of them (16 steps an epoch, 256
# validation items in 4 batches), 2 epochs, a snapshot each
DET_CONFIG = 'configs/detection/mnv2_ssd_300_scene_cascade.py'
DET_HARD_CONFIG = 'configs/detection/mnv2_ssd_300_synthetic_hard.py'
DET_OVERRIDES = dict(synthetic=True, synthetic_hard=True,
                     synthetic_length=1024, max_epochs=2, save_freq=1)
DET_BATCH, DET_STEPS, DET_VAL_BATCHES = 64, 16, 4
SELFLABEL_SCENES = 32
# the card's f32 step against the CPU's: the cascade w1.0 at 300², batch
# 4, 2 steps, each from the same weights, momentum and statistics.  The
# mined negatives and the cascade's re-assignment are discrete, so a
# rounding swaps a few between devices: the gradients, and the moves of
# the parameters and momentum buffers, are held to DET_NOISE times the
# CPU's own float32 rounding (its distance from a float64 step of the
# same weights) plus 1e-6 of their norm; the metrics within 1e-4
# relative, running means within 1e-4 of their channel's running std and
# running variances within 1e-4 relative.
DET_CARD_CPU_BATCH = 4
DET_NOISE = 4.0
DET_CARD_CPU_TOL = dict(metrics=1e-4, stats=1e-4)


def det_config(out_dir, config=DET_CONFIG):
    from tpudet3d_torch.core.config import read_py_config
    cfg = read_py_config(config)
    for k in ('synthetic', 'synthetic_hard', 'synthetic_length',
              'max_epochs'):
        cfg.data[k] = DET_OVERRIDES[k]
    cfg.utils.save_freq = DET_OVERRIDES['save_freq']
    cfg.output_dir = out_dir
    return cfg


def det_items(n, seed=3):
    from tpudet3d_torch.data.detection_dataset import SyntheticDetection
    ds = SyntheticDetection(length=n, hard=True, seed=seed)
    items = [ds[i] for i in range(n)]
    return [np.stack([it[k] for it in items]) for k in range(4)]


def det_parts(dev, dtype, lr):
    """A cascade w1.0 detector state from seed 0 and its train step
    (GIoU 2, cascade threshold 0.5, SGD momentum 0.9, weight decay 5e-4)
    on ``dev`` in ``dtype``."""
    from tpudet3d_torch.detect import SSDDetector
    from tpudet3d_torch.detect.train import (create_detector_state,
                                             make_detector_train_step)
    from tpudet3d_torch.models.layers import init_weights
    model = SSDDetector(width_mult=1.0, cascade=True, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(0))
    state = create_detector_state(model.to(dtype), lr=lr, momentum=0.9,
                                  wd=5e-4, device=dev)
    step = make_detector_train_step(state.model, state.optimizer,
                                    giou_weight=2.0, cascade_pos_thr=0.5)
    return state, step


def det_vectors(state):
    """Every parameter (the balance pair too), its gradient and momentum
    buffer, float64 on the CPU, by name."""
    named = dict(state.model.named_parameters(), **{
        f'balance.{k}': p for k, p in state.balance.items()})
    out = {}
    for k, p in named.items():
        buf = state.optimizer.state.get(p, {}).get('momentum_buffer')
        out[k] = tuple(t.detach().double().cpu() for t in (
            p, p.grad if p.grad is not None else torch.zeros_like(p),
            buf if buf is not None else torch.zeros_like(p)))
    return out


def vec_dist(a, b, i):
    """The norm over every name of ``a[k][i] - b[k][i]`` (``b`` None: of
    ``a[k][i]``)."""
    return sum(float(((a[k][i] - (0 if b is None else b[k][i])) ** 2).sum())
               for k in a) ** 0.5


def forward_keep_stats(model, imgs):
    """The training forward without moving the running statistics."""
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if 'running' in k}
    with torch.no_grad():
        out = model(imgs, train=True)
        for k, v in stats.items():
            model.state_dict()[k].copy_(v)
    return out


def det_assign_check(models, imgs, gt, anchors):
    """Stage 1 (anchors against the ground truth) equal on both devices;
    stage 2 (the refined boxes at 0.5) equal but where the two devices'
    IoUs straddle the threshold, or fall within 1e-5 of it, or a ground
    truth's best anchor differs; returns the count of those."""
    from tpudet3d_torch.detect import assign_anchors, decode_boxes, iou_xyxy
    outs = []
    for model, x, (boxes, labels, valid), a in zip(models, imgs, gt,
                                                    anchors):
        _, (d1, _) = forward_keep_stats(model, x)
        a1 = assign_anchors(a, boxes, valid)[0].cpu()
        refined = decode_boxes(a, d1)
        a2 = assign_anchors(refined, boxes, valid, 0.5, 0.5)[0].cpu()
        ious = torch.where(valid[:, None, :], iou_xyxy(refined, boxes), -1.0)
        outs.append((a1, a2, ious.amax(-1).cpu(), ious.argmax(1).cpu()))
    (a1c, a2c, ic, bc), (a1d, a2d, idv, bd) = outs
    expect(torch.equal(a1c, a1d), 'stage-1 assignment differs')
    diff = a2c != a2d
    straddle = ((ic - 0.5) * (idv - 0.5) <= 0) | ((ic - 0.5).abs() <= 1e-5)
    # each valid ground truth's best anchor on either device
    claimed = torch.zeros_like(diff)
    valid = gt[0][2].cpu()
    for b in range(diff.shape[0]):
        for best in (bc[b][valid[b]], bd[b][valid[b]]):
            claimed[b, best] = True
    expect(bool((~diff | straddle | claimed).all()),
           f'stage-2 assignment differs away from the threshold: '
           f'{int((diff & ~straddle & ~claimed).sum())} anchors')
    return int(diff.sum()), int((a2c >= 0).sum())


def det_card_against_cpu(dev):
    """Two f32 steps of the cascade detector on the card and on the CPU
    (and in float64 on the CPU) from the same weights, on
    SyntheticDetection(hard) items through the augmentations with fixed
    draws; before the second step the card and the float64 state take the
    CPU's weights, momentum and statistics."""
    from tpudet3d_torch.data.det_transforms import build_detector_augmentations
    from tpudet3d_torch.detect import generate_anchors
    lr = 0.05 / 3                       # the warmup's first learning rate
    parts = {'cpu': det_parts('cpu', torch.float32, lr),
             'card': det_parts(dev, torch.float32, lr),
             'f64': det_parts('cpu', torch.float64, lr)}
    imgs_u8, boxes, labels, valid = (torch.from_numpy(a) for a in
                                     det_items(DET_CARD_CPU_BATCH))
    aug = build_detector_augmentations(0.5, 0.5)
    draws = aug.sample(DET_CARD_CPU_BATCH, torch.Generator().manual_seed(2),
                       'cpu')
    imgs, aug_boxes = aug.apply(imgs_u8, boxes, draws)
    imgs_d, boxes_d = aug.apply(imgs_u8.to(dev), boxes.to(dev),
                                {k: v.to(dev) for k, v in draws.items()})
    aug_err = rel_err(imgs_d, imgs)
    expect(aug_err <= AUG_TOL and torch.equal(boxes_d.cpu(), aug_boxes),
           f'detector augmentations: card against CPU {aug_err}')
    gt = (aug_boxes, labels.long(), valid)
    gt_d = tuple(t.to(dev) for t in gt)
    anchors = torch.from_numpy(generate_anchors())
    errs = dict(aug=aug_err, metrics=0.0, stage2_flips=[], stage2_pos=[],
                grad_card=[], grad_cpu_f64=[], param_card=[],
                param_cpu_f64=[], momentum_card=[], momentum_cpu_f64=[],
                stats=0.0)
    with cudnn_deterministic():
        for i in range(2):
            flips, n_pos = det_assign_check(
                (parts['cpu'][0].model, parts['card'][0].model),
                (imgs, imgs_d), (gt, gt_d), (anchors, anchors.to(dev)))
            errs['stage2_flips'].append(flips)
            errs['stage2_pos'].append(n_pos)
            start = det_vectors(parts['cpu'][0])
            res = {}
            for name, (state, step) in parts.items():
                x, g = (imgs_d, gt_d) if name == 'card' else (imgs, gt)
                if name == 'f64':
                    x, g = x.double(), (g[0].double(),) + g[1:]
                _, m = step(state, x, *g)
                res[name] = (det_vectors(state), m.double().cpu())
            (cpu, m_cpu), (card, m_card), (f64, _) = (
                res['cpu'], res['card'], res['f64'])
            e = rel_err(m_card, m_cpu)
            expect(e <= DET_CARD_CPU_TOL['metrics'],
                   f'detector card vs CPU step {i}: metrics {e}')
            errs['metrics'] = max(errs['metrics'], e)
            # gradients against their norm; parameters and momentum
            # buffers (from one start) against the float64 step's move
            for key, idx in (('grad', 1), ('param', 0), ('momentum', 2)):
                err = vec_dist(card, cpu, idx)
                noise = vec_dist(cpu, f64, idx)
                scale = vec_dist(f64, None if key == 'grad' else start, idx)
                errs[f'{key}_card'].append(err / scale)
                errs[f'{key}_cpu_f64'].append(noise / scale)
                expect(err <= DET_NOISE * noise + 1e-6 * scale,
                       f'detector card vs CPU step {i}: {key} '
                       f'{err / scale:.3g} of its norm, CPU vs float64 '
                       f'{noise / scale:.3g}')
            sd_cpu = parts['cpu'][0].model.state_dict()
            for name, t in parts['card'][0].model.state_dict().items():
                if 'running' in name:
                    ref = sd_cpu[name]
                    scale = (sd_cpu[name.replace('_mean', '_var')].sqrt()
                             if name.endswith('running_mean') else ref)
                    e = ((t.cpu() - ref).abs().max()
                         / scale.abs().max()).item()
                    expect(e <= DET_CARD_CPU_TOL['stats'],
                           f'detector card vs CPU step {i}: {name} {e}')
                    errs['stats'] = max(errs['stats'], e)
            print(f'detector card vs CPU step {i}: loss {float(m_cpu[0]):.6f}'
                  f' (CPU) {float(m_card[0]):.6f} (card); stage 2 '
                  f'{flips} of {n_pos} positives flipped at the threshold; '
                  f'|card - CPU| / |CPU - f64| of gradients '
                  f'{errs["grad_card"][-1]:.3g} / '
                  f'{errs["grad_cpu_f64"][-1]:.3g}, parameter moves '
                  f'{errs["param_card"][-1]:.3g} / '
                  f'{errs["param_cpu_f64"][-1]:.3g}, momentum '
                  f'{errs["momentum_card"][-1]:.3g} / '
                  f'{errs["momentum_cpu_f64"][-1]:.3g} (of their norms)')
            # the next step starts from the CPU's state on every device
            src = parts['cpu'][0]
            for name in ('card', 'f64'):
                dst = parts[name][0]
                with torch.no_grad():
                    for (_, p), q in zip(dst.model.state_dict().items(),
                                         src.model.state_dict().values()):
                        p.copy_(q)
                    for p, q in zip(dst.optimizer.param_groups[0]['params'],
                                    src.optimizer.param_groups[0]['params']):
                        dst.optimizer.state[p]['momentum_buffer'] = \
                            src.optimizer.state[q]['momentum_buffer'] \
                            .to(p).clone()
                        p.copy_(q)
    expect(int(parts['card'][0].step) == 2, 'detector card vs CPU: step')
    print(f'detector card vs CPU, cascade w1.0 f32 at batch '
          f'{DET_CARD_CPU_BATCH}: metrics {errs["metrics"]:.3g}, running '
          f'statistics {errs["stats"]:.3g}, augmentations {aug_err:.3g} '
          f'(tolerances {DET_CARD_CPU_TOL}, noise factor {DET_NOISE})')
    return errs


def det_state_copy(state, counter):
    """Clones of every field ``resume_from`` restores, and the host step
    counter."""
    import copy
    return dict(weights={k: v.detach().clone() for k, v in
                         state.model.state_dict().items()
                         if not k.endswith('num_batches_tracked')},
                optimizer=copy.deepcopy(state.optimizer.state_dict()),
                balance={k: v.detach().clone()
                         for k, v in state.balance.items()},
                step=state.step.clone(), counter=counter)


def same_det_state(a, b, what):
    for k, v in a['weights'].items():
        expect(torch.equal(v, b['weights'][k]), f'{what}: {k}')
    sa, sb = a['optimizer']['state'], b['optimizer']['state']
    expect(sa.keys() == sb.keys() and len(sa) > 0,
           f'{what}: momentum buffers')
    for i in sa:
        expect(torch.equal(sa[i]['momentum_buffer'].cpu(),
                           sb[i]['momentum_buffer'].cpu()),
               f'{what}: momentum buffer {i}')
    for k, v in a['balance'].items():
        expect(torch.equal(v, b['balance'][k]), f'{what}: balance {k}')
    expect(torch.equal(a['step'], b['step']), f'{what}: step')
    expect(a['counter'] == b['counter'], f'{what}: host step counter')


def ssd_loss_profile(logits, d1, d2, gt):
    """``ssd_loss`` forward and backward alone on the step's shapes."""
    from tpudet3d_torch.detect import generate_anchors, ssd_loss
    anchors = torch.from_numpy(generate_anchors()).to(logits.device)
    leaves = [t.detach().clone().requires_grad_() for t in (logits, d1, d2)]

    def call():
        total, _ = ssd_loss(leaves[0], leaves[1], anchors, *gt,
                            cascade_deltas=leaves[2], giou_weight=2.0)
        total.backward()
    call()
    prof = kernel_profile(call, AUG_PROFILED)
    for k in ('busy_ms', 'launches', 'wall_ms'):
        prof[k] /= AUG_PROFILED
    return prof


def det_step_alone(dev, cfg):
    """A detector run's step with the augmentations fused in, alone on
    one loader batch (median, images/s, peak memory, profile), and the
    loss alone on the cascade's shapes."""
    from tpudet3d_torch.tools.train_detector import setup
    run = setup(cfg, dev)
    imgs, boxes, labels, valid, _ = next(iter(run.train_loader))
    batch = run.trainer.put_fn(imgs, boxes, labels, valid)
    gen = torch.Generator(device=dev).manual_seed(5)
    aug, step, state = run.trainer.augment_fn, run.trainer.train_step, \
        run.state

    def call():
        x, b = aug(batch[0], batch[1], gen)
        return step(state, x, b, *batch[2:])
    out = step_times(call, DET_BATCH)
    out['loss'] = None
    if run.model.cascade:
        x, b = aug(batch[0], batch[1], gen)
        with torch.no_grad():
            logits, (d1, d2) = run.model(x, train=True)
        out['loss'] = ssd_loss_profile(logits, d1, d2, (b, *batch[2:]))
    del run
    torch.cuda.empty_cache()
    return out


def detector_training_path(dev, wrappers, frames_np, gpu):
    """Phase 10: detector training at full width through
    ``tools/train_detector.py``'s path; returns its numbers."""
    import copy
    import os
    import tempfile

    import tpudet3d_torch.detect as detect_pkg
    from tpudet3d_torch.data.selflabel import (generate_selflabel_boxes,
                                               load_selflabel_boxes)
    from tpudet3d_torch.data.synthetic_scene import SceneCrops, SyntheticScene
    from tpudet3d_torch.detect import decode_detections_plain, generate_anchors
    from tpudet3d_torch.infer import TwoStageEngine, build_engine
    from tpudet3d_torch.tools.train_detector import setup, validate
    from tpudet3d_torch.train import current_learning_rate
    from tpudet3d_torch.utils.checkpoint import resume_from, save_snap
    decode = wrappers[2]
    no_launch = [0] * 7
    k3_only = [0, 0, 1, 0, 0, 0, 0]
    out = {'launches': {}, 'overrides': DET_OVERRIDES}

    def counted(name, fn, want, replayed=False):
        res, n = (drive_replay if replayed else drive)(wrappers, fn)
        out['launches'][name] = n
        expect(n == want, f'{name}: launches {n}, want {want}')
        return res

    # 1. the card against the CPU, float32
    out['card_vs_cpu'] = det_card_against_cpu(dev)

    # 2. the loop: 2 epochs of the flagship cascade config
    root = tempfile.mkdtemp(prefix='det_')
    cfg = det_config(root)
    run = setup(cfg, dev)
    trainer = run.trainer
    expect(len(run.train_loader) == DET_STEPS and
           len(run.val_loader) == DET_VAL_BATCHES,
           f'loader lengths {len(run.train_loader)}, {len(run.val_loader)}')
    expect(run.model.cascade and run.model.dtype == torch.bfloat16,
           'the config did not give a bf16 cascade')
    steps, puts = [], []
    inner_step, inner_put = trainer.train_step, trainer.put_fn
    checked_step = sync_checked(inner_step)
    trainer.augment_fn = sync_checked(trainer.augment_fn)

    def step(state, *batch):
        lr = current_learning_rate(state.optimizer)
        state, m = checked_step(state, *batch)
        steps.append((trainer.step_counter, lr, m))
        return state, m

    def put(*arrays):
        puts.append(time.perf_counter())
        return inner_put(*arrays)
    trainer.train_step, trainer.put_fn = step, put

    val_rows = {}

    def add(ev, imgs, boxes, labels, valid):
        rows = ev.detect(imgs)
        t0 = time.perf_counter()
        host = rows.cpu()
        t1 = time.perf_counter()
        ev.add_batch(imgs, boxes, labels, valid, dets=host)
        val_rows.setdefault('wait_s', 0.0)
        val_rows['wait_s'] += t1 - t0
        val_rows['match_s'] = val_rows.get('match_s', 0.0) \
            + time.perf_counter() - t1
        val_rows.setdefault('first', (imgs, boxes, labels, valid, rows))

    epochs = {}
    for epoch in range(DET_OVERRIDES['max_epochs']):
        last = epoch == DET_OVERRIDES['max_epochs'] - 1
        n_steps, n_puts = len(steps), len(puts)
        counted(f'det train epoch {epoch}', lambda: trainer.train(epoch, last),
                no_launch)
        t_end = time.perf_counter()
        ep = steps[n_steps:]
        expect(len(ep) == DET_STEPS, f'epoch {epoch}: {len(ep)} steps')
        metrics = torch.stack([m for _, _, m in ep]).cpu()
        expect(bool(torch.isfinite(metrics).all()),
               f'epoch {epoch}: non-finite metrics')
        for counter, lr, _ in ep:
            expect(lr == run.lr_fn(counter),
                   f'step {counter}: lr {lr}, want {run.lr_fn(counter)}')
        expect(os.path.isfile(os.path.join(root, f'snap_{epoch}.pt')),
               f'snap_{epoch}.pt not written')
        if epoch == 0:
            after0 = det_state_copy(run.state, trainer.step_counter)
        val_rows.clear()
        t0 = time.perf_counter()
        res = counted(f'det val epoch {epoch}', lambda: validate(
            run, epoch, add_batch=add), [0, 0, DET_VAL_BATCHES, 0, 0, 0, 0])
        val_s = time.perf_counter() - t0
        expect(all(np.isfinite(v) for v in res.values()), 'mAP')
        epochs[epoch] = dict(
            loop_s=t_end - puts[n_puts],
            images_per_s=DET_STEPS * DET_BATCH / (t_end - puts[n_puts]),
            loss_first=float(metrics[0, 0]), loss_last=float(metrics[-1, 0]),
            num_pos_mean=float(metrics[:, 3].mean()),
            lr_last=ep[-1][1], mAP=res['mAP'], val_s=val_s,
            val_images_per_s=len(run.val_loader.dataset) / val_s,
            val_match_share=val_rows['match_s'] / val_s,
            val_wait_share=val_rows['wait_s'] / val_s)
    out['epochs'] = epochs
    expect(int(run.state.step) == trainer.step_counter == 2 * DET_STEPS,
           'step count')
    after1 = det_state_copy(run.state, trainer.step_counter)

    # one validation batch's K3 rows against the plain version, and the
    # mAP with that batch's rows through the plain version
    imgs, boxes, labels, valid, rows = val_rows['first']
    with torch.no_grad():
        logits, deltas = run.model(imgs)
    anchors = torch.from_numpy(generate_anchors()).to(dev)
    plain = decode_detections_plain(logits, deltas, anchors, score_thr=0.02,
                                    max_per_img=100, pre_nms_k=200)
    out['val_k3_err'] = compare_dets(rows, plain, 'K3 detector validation')
    swapped = []

    def add_plain(ev, *batch):
        if not swapped:
            swapped.append(True)
            return ev.add_batch(*batch, dets=plain)
        return ev.add_batch(*batch)
    res_plain = validate(run, 1, add_batch=add_plain)
    expect(abs(res_plain['mAP'] - epochs[1]['mAP']) <= 1e-9,
           f'mAP {epochs[1]["mAP"]} through K3, {res_plain["mAP"]} with the '
           f'plain version on one batch')

    # 4. resume: snap_0 into a fresh run is the state after epoch 0
    fresh = setup(cfg, dev, resume=os.path.join(root, 'snap_0.pt'))
    expect(fresh.start_epoch == 1, f'resume: start epoch {fresh.start_epoch}')
    same_det_state(det_state_copy(fresh.state, fresh.trainer.step_counter),
                   after0, 'resume from snap_0')
    t0 = time.perf_counter()
    resume_from(fresh.state, os.path.join(root, 'snap_1.pt'))
    out['resume_s'] = time.perf_counter() - t0
    del fresh
    t0 = time.perf_counter()
    save_snap(run.state, 99, tempfile.mkdtemp(prefix='snap_'))
    out['save_snap_s'] = time.perf_counter() - t0

    # 5. serve the trained detector (no EMA in this config: the weights)
    engine = build_engine(det_checkpoint=os.path.join(root, 'snap_1.pt'),
                          det_conf=0.0, device=dev)
    served = engine.det_model.state_dict()
    for k, v in after1['weights'].items():
        expect(torch.equal(served[k], v), f'served {k} is not the trained '
               f'weight')
    res = counted('trained detector infer_batch(16)',
                  lambda: engine.infer_batch(frames_np), [1, 1, 1, 1, 0, 0, 0],
                  replayed=True)
    check_results(res, *FRAME[:2])
    memory = TwoStageEngine(copy.deepcopy(run.model), engine.reg_model,
                            engine.cfg, device=dev)
    with cudnn_deterministic():
        same_results(engine.infer_batch(frames_np),
                     memory.infer_batch(frames_np),
                     'the trained detector from snap_1.pt against the '
                     'module in memory')
    out['served_detections'] = sum(len(r['scores']) for r in res)
    del engine, memory

    # 6. self-labelling: one K3 launch per batch of 32 scenes
    scene = SyntheticScene(length=SELFLABEL_SCENES, seed=23)
    npz = os.path.join(root, 'selflabel.npz')
    t0 = time.perf_counter()
    matched, total = counted('self-label', lambda: generate_selflabel_boxes(
        scene, os.path.join(root, 'snap_1.pt'), npz, device=dev), k3_only)
    out['selflabel_scenes_per_s'] = SELFLABEL_SCENES / (time.perf_counter()
                                                        - t0)
    kernel = detect_pkg.decode_detections
    detect_pkg.decode_detections = decode_detections_plain
    try:
        generate_selflabel_boxes(scene, os.path.join(root, 'snap_1.pt'),
                                 npz + '.plain.npz', device=dev)
    finally:
        detect_pkg.decode_detections = kernel
    got, ref = np.load(npz), np.load(npz + '.plain.npz')
    expect(np.array_equal(got['valid'], ref['valid']),
           'self-label: matched objects differ through the plain K3')
    out['selflabel_box_err'] = float(np.abs(got['boxes']
                                            - ref['boxes']).max())
    # compare_dets' 1e-3 px at 300², in 640×480 frame pixels
    expect(out['selflabel_box_err'] <= 1e-3 * 640 / 300,
           f'self-label boxes through the plain K3: '
           f'{out["selflabel_box_err"]}')
    boxes_sl, valid_sl = load_selflabel_boxes(npz, scene)
    crops = SceneCrops(scene, det_boxes=npz, selflabel_p=1.0)
    items = [crops[i] for i in range(8)]
    expect(all(it[0].shape == (224, 224, 3) for it in items),
           'self-labelled crops')
    out['selflabel'] = dict(matched=matched, objects=total)

    # 7. numbers: the loader alone, a profiled epoch, the step and the
    # loss alone for both configs
    t0 = time.perf_counter()
    n_img = sum(b[0].shape[0] for b in run.train_loader)
    out['loader_images_per_s'] = n_img / (time.perf_counter() - t0)
    trainer.train_step, trainer.put_fn = inner_step, inner_put
    loop = kernel_profile(lambda: trainer.train(2, False), 1)
    loop['images_per_s'] = DET_STEPS * DET_BATCH / loop['wall_ms'] * 1e3
    out['profiled_epoch'] = loop
    del run, trainer
    torch.cuda.empty_cache()
    out['step_cascade'] = det_step_alone(dev, cfg)
    out['step_hard'] = det_step_alone(
        dev, det_config(tempfile.mkdtemp(prefix='det_hard_'),
                        DET_HARD_CONFIG))
    e1, cas, hard = epochs[1], out['step_cascade'], out['step_hard']
    loss = cas['loss']
    cc = out['card_vs_cpu']
    top = ', '.join(f'{g} {t:.2f}'
                    for g, t in list(cas['groups_ms'].items())[:5])
    print(f'detector training ({DET_CONFIG}, {DET_OVERRIDES}) on {gpu}: '
          f'epoch 1 {e1["images_per_s"]:.1f} images/s (loss '
          f'{e1["loss_first"]:.4f} → {e1["loss_last"]:.4f}, mAP@0.5 '
          f'{e1["mAP"]:.4f}), loader alone {out["loader_images_per_s"]:.1f} '
          f'images/s; a profiled epoch {loop["images_per_s"]:.1f} images/s, '
          f'device busy {loop["busy_ms"]:.1f} of {loop["wall_ms"]:.1f} ms '
          f'(idle share {loop["idle_share"]:.3f}); validation '
          f'{e1["val_images_per_s"]:.1f} images/s (host matching '
          f'{e1["val_match_share"]:.3f} of it); step alone, cascade '
          f'{cas["step_ms"]:.2f} ms ({cas["images_per_s"]:.1f} images/s, '
          f'peak {cas["peak_memory_gib"]:.2f} GiB, busy '
          f'{cas["device_busy_ms"]:.2f} ms, idle share '
          f'{cas["device_idle_share"]:.3f}, {cas["launches_per_step"]:.0f} '
          f'launches; by group ms: {top}), synthetic_hard '
          f'{hard["step_ms"]:.2f} ms ({hard["images_per_s"]:.1f} images/s, '
          f'peak {hard["peak_memory_gib"]:.2f} GiB); ssd_loss forward and '
          f'backward {loss["launches"]:.0f} launches, {loss["busy_ms"]:.3f} '
          f'ms on the device ({loss["wall_ms"]:.2f} wall); save_snap '
          f'{out["save_snap_s"]:.2f} s, resume_from {out["resume_s"]:.2f} s; '
          f'self-label {out["selflabel_scenes_per_s"]:.1f} scenes/s '
          f'({matched}/{total} objects matched); card vs CPU stage-2 flips '
          f'{cc["stage2_flips"]} of {cc["stage2_pos"]}')
    return out


# phase 11: the last modules at full width.  Reference checkpoints laid out
# to the published contracts (seeded random values: the published files
# are not in the repository), data parallelism under process groups, sharded
# serving, and the tools (complexity, profiling, the HPO sweep)
PRETRAINED_CASES = (('mobilenetv3_large_21k', 'timm', 11221),
                    ('efficientnet-lite0', 'lite', None))
IMPORT_STEPS = 10
DP_BATCH = (64, 16)              # the comparison's global batches
DP_REG_STEPS, DP_DET_STEPS, DP_TIMED = 2, 3, 5
DP_VAL_BATCHES = 2
DP_DET_OVERRIDES = dict(synthetic_length=256, max_epochs=1)
SHARD_CALLS = 10
OPTUNA_ARGS = ('-e', '1', '--n_trials', '2', '--n_training_iterations',
               '0.25', '--n_validate_iterations', '0.5', '--disable_store_log')
K1_K4_NAMES = tuple(names[0] for names in KERNEL_NAMES[:4])


def seeded_state_dict(contract, seed):
    """Random tensors laid out exactly as ``contract`` (keys, shapes and
    order), from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in contract:
        if key.endswith('num_batches_tracked'):
            sd[key] = torch.tensor(10, dtype=torch.int64)
        elif key.endswith('running_var'):
            sd[key] = torch.rand(shape, generator=g) + 0.5
        else:
            sd[key] = torch.randn(shape, generator=g) * 0.05
    return sd


def quiet(fn, *args, **kwargs):
    """``fn``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def reference_import(dev, tmp, gpu):
    """11a: seeded checkpoints to the timm-21k and lite0 contracts vetted by
    ``tools/check_pretrained.py`` (a drifted one refused),
    ``setup_training(configs/default_config.py)`` loading the 21k file bit
    for bit, then IMPORT_STEPS bf16 steps at batch TRAIN_BATCH."""
    import os

    from tpudet3d_torch.core.config import read_py_config
    from tpudet3d_torch.models import build_model
    from tpudet3d_torch.tools import check_pretrained
    from tpudet3d_torch.train import make_train_step
    from tpudet3d_torch.train.pipeline import setup_training
    from tpudet3d_torch.utils.torch_import import load_torch_checkpoint_into
    paths = {}
    for i, (model, kind, nc) in enumerate(PRETRAINED_CASES):
        contract = check_pretrained.get_contract(model, kind, nc)
        paths[model] = os.path.join(tmp, f'{model}.pth')
        torch.save({'state_dict': seeded_state_dict(contract, i)},
                   paths[model])
        code, text = quiet(check_pretrained.main, ['--model', model,
                                                   '--ckpt', paths[model]])
        expect(code == 0 and 'strict import: OK' in text,
               f'check_pretrained refused the {model} checkpoint:\n{text}')
    drifted = seeded_state_dict(check_pretrained.get_contract(
        'efficientnet-lite0', 'lite', None), 9)
    drifted['_conv_head.weight'] = torch.zeros(1280, 328, 1, 1)
    bad = os.path.join(tmp, 'drifted.pth')
    torch.save({'state_dict': drifted}, bad)
    code, text = quiet(check_pretrained.main, ['--model',
                                               'efficientnet-lite0',
                                               '--ckpt', bad])
    expect(code == 1 and 'MISMATCH' in text,
           f'check_pretrained passed a drifted checkpoint:\n{text}')

    os.environ['TPUDET3D_PRETRAINED_DIR'] = tmp
    cfg = read_py_config('configs/default_config.py')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe, text = quiet(setup_training, cfg, device=dev, with_loaders=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    expect('torch import: matched' in text, f'no import:\n{text}')
    seed = int(cfg.utils.random_seeds or 5)
    ref = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    report = {}
    quiet(load_torch_checkpoint_into, ref, paths['mobilenetv3_large_21k'],
          report=report)
    own = pipe.state.model.state_dict()
    for k, v in ref.state_dict().items():
        expect(torch.equal(own[k].cpu(), v), f'imported {k} differs')
    fresh = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    fresh = fresh.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quiet(load_torch_checkpoint_into, fresh, paths['mobilenetv3_large_21k'])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del fresh

    state = pipe.state
    step = make_train_step(state.model, state.loss_manager, state.optimizer,
                           ema_decay=state.ema_decay)
    batch = train_batch(cfg, TRAIN_BATCH, dev, seed=11)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []
    for _ in range(IMPORT_STEPS):
        state, m = step(state, *batch, gen)
        losses.append(m[0])
    losses = torch.stack(losses).float().cpu().tolist()
    expect(all(np.isfinite(losses)), f'imported run: losses {losses}')
    expect(losses[-1] < losses[0], f'imported run: loss did not fall '
           f'{losses}')
    print(f'phase 11a reference import on {gpu}: 21k and lite0 vetted, drift '
          f'refused; {report["matched"]} tensors matched, '
          f'{len(report["leftovers"])} left over {report["leftovers"]}; '
          f'load {load_s:.3f} s (setup_training {setup_s:.3f} s); bf16 '
          f'batch {TRAIN_BATCH} losses {losses[0]:.4f} -> {losses[-1]:.4f}')
    del pipe, state, step, batch
    torch.cuda.empty_cache()
    return dict(load_s=load_s, setup_s=setup_s, losses=losses,
                matched=report['matched'], leftovers=report['leftovers'])


def dp_config(sgd=True):
    """el0 with its EMA in float32; for the comparisons SGD at the
    config's learning rate, 1e-3, as JAX's equivalence test (SGD's update
    is linear in the gradient: Adam's first is about lr·sign(g)), and ALWA
    firing at step 1."""
    from tpudet3d_torch.core.config import read_py_config
    cfg = read_py_config(EL0_CONFIG)
    cfg.model.bf16 = False
    if sgd:
        cfg.optim.name = 'sgd'
        cfg.loss.coeffs = ([1., .1], [1.])    # ALWA's first coefficients
        cfg.loss.alwa.update(use=True, C=1, compute_std=False)
    return cfg


def overlapping_evaluator(state, eval_step, cfg, dev, n, seed,
                          parts=(slice(None),)):
    """An ``Evaluator`` with the IoU over DP_VAL_BATCHES batches of ``n``,
    each fed as one batch a slice of ``parts`` (a rank's rows, or a whole
    batch cut as the ranks cut it), whose keypoints overlap their ground
    truth, so that K5 clips real polygons: the EMA's heads are set as in
    the CPU tests, each class's bias to one projected box and the kernel
    scaled by 0.05 (the images move the box a little), and the ground
    truth is that box jittered by about a pixel."""
    from types import SimpleNamespace

    from tpudet3d_torch.data.transforms import build_augmentations
    from tpudet3d_torch.eval.evaluator import Evaluator
    from tpudet3d_torch.train import eval_params
    from tpudet3d_torch.train.pipeline import HostToDevice
    params = dict(eval_params(state))
    boxes = projected_box_keypoints(9, seed=9)
    params['head_bias'] = torch.from_numpy(np.log(boxes / (1 - boxes))
                                           .reshape(9, 18)).to(dev)
    params['head_kernel'] = params['head_kernel'] * 0.05
    rng = np.random.RandomState(seed)
    h, w = cfg.data.resize
    batches = []
    for _ in range(DP_VAL_BATCHES):
        imgs = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
        cats = rng.randint(0, 9, n)
        kp = np.clip(boxes[cats] + rng.normal(0, 0.004, (n, 9, 2)), 0, 1)
        kp = (kp * np.float32([w, h])).astype(np.float32)
        for rows in parts:
            mine = imgs[rows]
            batches.append((mine, kp[rows], cats[rows], mine.shape[0]))
    return Evaluator(eval_step=eval_step,
                     state_fn=lambda: SimpleNamespace(ema_params=params),
                     val_loader=batches, test_loader=None,
                     test_transform=build_augmentations(cfg)[1],
                     put_fn=HostToDevice(dev))


def dp_work(dev, world, rank, tmp, split=1):
    """The comparison's work in this process, on the rows ``rank::world``
    of each global batch (DP_BATCH): DP_REG_STEPS float32 el0 steps
    (dropout from the shared generator), ``Evaluator.val`` over every
    rank (with ``split`` > 1 also over each batch fed as ``split``
    batches, as that many ranks feed it), rank 0's snapshot at a barrier
    and every rank's ``resume_from`` of it; DP_DET_STEPS cascade steps
    (the augmentations' draws too) and ``DetectorEvaluator``'s mAP over
    every rank's detections; the results on the host."""
    import os

    from tpudet3d_torch.data.det_transforms import (
        DetectorAugmentations, build_detector_augmentations)
    from tpudet3d_torch.detect import DetectorEvaluator
    from tpudet3d_torch.parallel import sharding
    from tpudet3d_torch.utils.checkpoint import (resume_from, save_snap,
                                                 snapshot_path)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dp_config()
    state, step, eval_step = train_parts(cfg, dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(reg_metrics=[], reg_params_0={
        k: p.detach().to('cpu', copy=True)
        for k, p in state.model.named_parameters()})
    mine = slice(rank, None, world)
    with cudnn_deterministic():
        for i in range(DP_REG_STEPS):
            batch = train_batch(cfg, DP_BATCH[0], 'cpu', seed=5 + i)
            rows = [t[mine].to(dev) for t in batch]
            state, m = step(state, *rows, gen)
            out['reg_metrics'].append(m.cpu())
            if i == 0:
                out['reg_params_1'] = {k: p.detach().to('cpu', copy=True)
                                       for k, p in
                                       state.model.named_parameters()}
        if dev.type == 'cuda':
            out.update(dp_step_times(state, step, rows, gen))
        out['reg_stats'] = {k: v.cpu() for k, v in
                            state.model.state_dict().items() if 'running' in k}
        out['reg_alwa'] = {k: v.cpu() for k, v in vars(state.alwa).items()}
        out['reg_ema'] = {k: v.cpu() for k, v in state.ema_params.items()}
        # Evaluator.val of the trained state, and of a seeded one whose
        # weights every run shares, so that its sums through the group
        # can be held against one process's over the same batches
        fresh, _, fresh_eval = train_parts(cfg, dev, seed=1)
        evals = [('reg_val', fresh, fresh_eval, [mine]),
                 ('reg_val_trained', state, eval_step, [mine])]
        if split > 1:
            evals.append(('reg_val_split', fresh, fresh_eval,
                          [slice(r, None, split) for r in range(split)]))
        for key, st, ev_step, parts in evals:
            ev = overlapping_evaluator(st, ev_step, cfg, dev, DP_BATCH[0],
                                       seed=17, parts=parts)
            out[key] = np.asarray(quiet(ev.val, compute_iou=True)[0])
        snaps = os.path.join(tmp, f'snaps_{world}')
        if sharding.is_main_process():
            quiet(save_snap, state, 0, snaps)
        sharding.barrier()
        quiet(resume_from, fresh, snapshot_path(snaps, 0))
        out['resumed'] = all(
            torch.equal(p, q) for p, q in zip(
                list(fresh.model.state_dict().values())
                + list(fresh.ema_params.values())
                + list(vars(fresh.alwa).values()),
                list(state.model.state_dict().values())
                + list(state.ema_params.values())
                + list(vars(state.alwa).values())))
        del rows, state, step, fresh, ev
        dstate, dstep = det_parts(dev, torch.float32, 0.01)
        aug = DetectorAugmentations(flip_p=0.5, rot_p=0.5)
        dgen = torch.Generator(device=dev).manual_seed(1)
        m_det = DP_BATCH[1]
        items = det_items(m_det * DP_DET_STEPS, seed=3)
        out['det_metrics'] = []
        for i in range(DP_DET_STEPS):
            lo = i * m_det
            imgs, boxes, labels, valid = (
                torch.from_numpy(a[lo:lo + m_det][mine]).to(dev)
                for a in items)
            imgs, boxes = aug(imgs, boxes.float(), dgen)
            dstate, m = dstep(dstate, imgs, boxes, labels.long(), valid)
            out['det_metrics'].append(m.cpu())
        out['det_stats'] = {k: v.cpu() for k, v in
                            dstate.model.state_dict().items()
                            if 'running' in k}
        # the detections of this process's images, scored over every
        # rank's
        test_aug = build_detector_augmentations(train=False)
        det_ev = DetectorEvaluator(dstate.model, params=dstate.ema_params)
        items = det_items(m_det * DP_VAL_BATCHES, seed=9)
        out['det_dets'] = []
        for lo in range(0, m_det * DP_VAL_BATCHES, m_det):
            imgs, boxes, labels, valid = (a[lo:lo + m_det][mine]
                                          for a in items)
            imgs_d, _ = test_aug(torch.from_numpy(imgs).to(dev), None)
            dets = det_ev.detect(imgs_d)
            det_ev.add_batch(None, boxes, labels, valid, dets=dets)
            out['det_dets'].append(dets.cpu())
        out['det_map'] = det_map(det_ev)
    return out


def det_map(evaluator):
    """Each class's AP and the mAP of ``evaluator.results()``."""
    res = evaluator.results()
    return np.asarray([res[c] for c in range(9)] + [res['mAP']])


def dp_step_times(state, step, rows, gen):
    """The el0 step's time on this process's rows (CUDA events; gloo's
    collectives stage through the host), and what holds a step: the
    device's busy time, launches and the host's wall time (nccl's and
    gloo's own kernels included)."""
    times = []
    for _ in range(DP_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(state, *rows, gen)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    prof = kernel_profile(lambda: step(state, *rows, gen), 2)
    return dict(reg_step_ms=sorted(times)[len(times) // 2],
                reg_profile={k: prof[k] for k in ('busy_ms', 'launches',
                                                  'wall_ms', 'groups')})


def dp_validation(dev, parts, cfg, wrappers):
    """``Evaluator.val`` with the IoU over DP_VAL_BATCHES batches of
    TRAIN_BATCH whose keypoints overlap their ground truth; returns
    (averages, launches, the averages through the plain K5)."""
    from tpudet3d_torch.eval import metrics
    from tpudet3d_torch.ops import box3d
    ev = overlapping_evaluator(parts[0], parts[2], cfg, dev, TRAIN_BATCH,
                               seed=17)
    avg, launches = drive(wrappers, lambda: quiet(ev.val, compute_iou=True)[0])
    kernel = metrics.iou_oriented_boxes
    metrics.iou_oriented_boxes = box3d.iou_oriented_boxes_plain
    try:
        plain, _ = quiet(ev.val, compute_iou=True)
    finally:
        metrics.iou_oriented_boxes = kernel
    return np.asarray(avg), launches, np.asarray(plain)


def dp_path(dev, wrappers, gpu, tmp):
    """11b and 11c: el0 and the cascade detector under an NCCL group of one
    process against no group; then two gloo processes on cuda:0 against
    one process over the same global batch."""
    import os

    from tpudet3d_torch.core.config import read_py_config
    from tpudet3d_torch.parallel import sharding
    from tpudet3d_torch.tools.train_detector import setup, validate
    res = {}
    cfg = read_py_config(EL0_CONFIG)
    cfg.data.train_batch_size = TRAIN_BATCH
    batch = train_batch(cfg, TRAIN_BATCH, dev, seed=0)

    def timed():
        parts = train_parts(cfg, dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(0)
        t = train_times(parts, batch, gen)
        del parts
        torch.cuda.empty_cache()
        return t

    def f32_steps():
        f32 = dp_config(sgd=False)
        parts = train_parts(f32, dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(0)
        b = train_batch(f32, 64, dev, seed=1)
        with cudnn_deterministic():
            for _ in range(3):
                parts[1](parts[0], *b, gen)
            val = dp_validation(dev, parts, f32, wrappers)
        params = {k: v.detach().clone() for k, v in
                  parts[0].model.state_dict().items()}
        del parts
        torch.cuda.empty_cache()
        return params, val

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    no_group = timed()
    params_ng, val_ng = f32_steps()
    dev1 = sharding.maybe_init_distributed(group_config(free_port(), 1, 0),
                                           dev, backend='nccl')
    expect(torch.distributed.get_backend() == 'nccl' and
           sharding.world() == 1, 'no NCCL group of one process')
    try:
        grouped = timed()
        params_g, val_g = f32_steps()
        for k, v in params_ng.items():
            expect(torch.equal(v, params_g[k]), f'world 1: {k} differs')
        avg, launches, plain = val_g
        expect(launches == [0, 0, 0, 0, DP_VAL_BATCHES, 0, 0],
               f'validation under the group: launches {launches}')
        expect(np.array_equal(avg[[2]], val_ng[0][[2]]) and
               np.allclose(avg, val_ng[0], rtol=1e-6, atol=0),
               f'validation under the group {avg} vs without {val_ng[0]}')
        # the pairs overlap (IoU well above 0), and K5 keeps phase 2's
        # bound of 1e-5 a sample against its plain version
        expect(avg[3] > 0.1 and abs(avg[3] - plain[3]) <= 1e-5 and
               np.allclose(avg[:3], plain[:3], rtol=1e-6, atol=0),
               f'validation IoU against the plain K5: {avg} vs {plain}')
        res['regressor'] = dict(step_ms_no_group=no_group['step_ms'],
                                step_ms_world1=grouped['step_ms'],
                                idle_no_group=no_group['device_idle_share'],
                                idle_world1=grouped['device_idle_share'],
                                busy_ms_no_group=no_group['device_busy_ms'],
                                busy_ms_world1=grouped['device_busy_ms'],
                                val=avg.tolist(), val_launches=launches,
                                val_iou_plain_err=float(abs(avg[3]
                                                            - plain[3])))
        print(f'phase 11b el0 bf16 batch {TRAIN_BATCH} on {gpu}: step '
              f'{no_group["step_ms"]:.2f} ms without a group, '
              f'{grouped["step_ms"]:.2f} ms under NCCL world 1; 3 f32 steps '
              f'bit for bit; validation launches {launches}, averages '
              f'{avg.tolist()}, IoU {abs(avg[3] - plain[3]):.3g} from the '
              f'plain K5\'s')

        # 11c: the cascade detector through tools/train_detector.py
        dcfg = det_config(os.path.join(tmp, 'det'))
        dcfg.data.update(DP_DET_OVERRIDES)
        run, _ = quiet(setup, dcfg, dev)
        quiet(run.trainer.train, 0, True)
        with cudnn_deterministic():
            val_group, det_launches = drive(
                wrappers, lambda: quiet(validate, run, 0)[0])
    finally:
        torch.distributed.destroy_process_group()
    expect(sharding.world() == 1 and not torch.distributed.is_initialized(),
           'the group is still up')
    no_group_after = timed()        # A-B-A: the order's share of the gap
    with cudnn_deterministic():
        val_none, det_launches_ng = drive(
            wrappers, lambda: quiet(validate, run, 0)[0])
    n_val = len(run.val_loader)
    expect(det_launches == det_launches_ng == [0, 0, n_val, 0, 0, 0, 0],
           f'detector validation launches {det_launches} / '
           f'{det_launches_ng}, want {n_val} K3')
    expect(val_group == val_none, f'mAP under the group {val_group} vs '
           f'without {val_none}')
    res['regressor'].update(step_ms_no_group_after=no_group_after['step_ms'],
                            idle_no_group_after=no_group_after[
                                'device_idle_share'])
    print(f'phase 11b el0 step without a group after it on {gpu}: '
          f'{no_group_after["step_ms"]:.2f} ms (idle share without, under, '
          f'after: {no_group["device_idle_share"]:.3f}, '
          f'{grouped["device_idle_share"]:.3f}, '
          f'{no_group_after["device_idle_share"]:.3f})')
    res['detector'] = dict(mAP=val_group['mAP'], launches=det_launches)
    print(f'phase 11c cascade batch {dcfg.data.train_batch_size} on {gpu}: '
          f'{len(run.train_loader)} steps and a validation under NCCL world 1, mAP {val_group["mAP"]:.4f} '
          f'as without it, launches {det_launches}')
    del run
    torch.cuda.empty_cache()

    res.update(compare_dp(dev, tmp, gpu, 2, 'gloo'))
    return res


def compare_dp(dev, tmp, gpu, world, backend):
    """``world`` processes of a ``backend`` group (``dp_work``) against
    one process on ``dev`` over the same global batches: the loss at step
    0 within 1e-4, over the steps within 5e-2 (JAX's bounds); the
    regressor's update at step 1 within 5e-2 of its norm, whatever the
    learning rate, and its parameters within JAX's leaf-wise 5e-2; the
    running statistics, ALWA and EMA equal on every rank; the validation's
    averages within 1e-6 of one process's over the same batches and equal
    on every rank; rank 0's snapshot
    resumed on every rank; the mAP over every rank's detections equal to
    one process's over the same detections.  Each rank's el0 step time."""
    t0 = time.perf_counter()
    device = 'cuda:0' if backend == 'gloo' else 'cuda:{rank}'
    ranks = spawn_group(world, backend, device, dp_work, (tmp,), tmp, 300)
    spawn_s = time.perf_counter() - t0
    one = dp_work(dev, 1, 0, tmp, split=world)
    many = ranks[0]
    res = {}
    for key, tol in (('reg_metrics', 5e-2), ('det_metrics', 5e-2)):
        a = torch.stack(many[key])[:, 0].double()
        b = torch.stack(one[key])[:, 0].double()
        err0 = abs(float(a[0] - b[0])) / abs(float(b[0]))
        errs = ((a - b).abs() / b.abs()).max().item()
        expect(err0 <= 1e-4 and errs <= tol, f'{key}: {world} processes '
               f'{a.tolist()} vs one {b.tolist()}')
        res[key + '_rel_err'] = [err0, errs]
    start = one['reg_params_0']
    for k, v in start.items():
        expect(torch.equal(v, many['reg_params_0'][k]), f'start {k} differs')
    upd = update_err(many['reg_params_1'], one['reg_params_1'], start)
    leaf, worst = max_leaf_err(many['reg_params_1'], one['reg_params_1'])
    worst_upd = update_err(many['reg_params_1'], one['reg_params_1'], start,
                           [worst])
    expect(upd < 5e-2 and leaf < 5e-2, f'regressor after step 1: update '
           f'{upd:.3g} of its norm, leaf-wise {leaf:.3g} at {worst}')
    for field in ('reg_stats', 'reg_alwa', 'reg_ema', 'det_stats',
                  'reg_val', 'reg_val_trained', 'det_map'):
        for other in ranks[1:]:
            for k, v in (many[field].items() if isinstance(many[field], dict)
                         else [('all', many[field])]):
                expect(np.array_equal(np.asarray(v),
                                      np.asarray(other[field][k]
                                                 if k != 'all'
                                                 else other[field])),
                       f'{field} {k} differs between the ranks')
    expect(all(r['resumed'] for r in ranks) and one['resumed'],
           'a rank did not resume rank 0\'s snapshot')
    # the validation's sums through the group against one process fed
    # the same batches: equal but for their order of addition
    def val_err(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b).clip(min=1e-30)))
    split_err = val_err(many['reg_val'], one['reg_val_split'])
    batch_err = val_err(one['reg_val_split'], one['reg_val'])
    trained_err = val_err(many['reg_val_trained'], one['reg_val_trained'])
    expect(split_err <= 1e-6 and one['reg_val'][3] > 0.1,
           f'validation under {world} processes {many["reg_val"]} vs one '
           f'process over the same batches {one["reg_val_split"]}')
    joined, n_records = det_map_over_ranks(ranks, world)
    expect(np.array_equal(joined, many['det_map']) and n_records > 0,
           f'mAP over {world} processes {many["det_map"]} vs one process '
           f'over their {n_records} detections {joined}')
    stats_err = max_leaf_err(many['reg_stats'], one['reg_stats'])[0]
    res.update(params_update_err=upd, params_leaf_err=leaf,
               params_worst_leaf=[worst, worst_upd], stats_leaf_err=stats_err,
               val=many['reg_val'].tolist(), val_rel_err=split_err,
               val_batch_size_rel_err=batch_err,
               val_trained=many['reg_val_trained'].tolist(),
               val_trained_rel_err=trained_err,
               mAP=float(many['det_map'][-1]),
               mAP_own_forward=float(one['det_map'][-1]),
               det_records=n_records, spawn_s=spawn_s, backend=backend,
               world=world, step_ms_ranks=[r['reg_step_ms'] for r in ranks],
               step_ms_one=one['reg_step_ms'],
               profile_rank0=many['reg_profile'], profile_one=one['reg_profile'])
    where = 'cuda:0' if backend == 'gloo' else f'{world} cards'
    print(f'phase 11b/c {world} {backend} processes on {where} of {gpu} '
          f'against one: loss at step 0 '
          f'{res["reg_metrics_rel_err"][0]:.3g} (regressor), '
          f'{res["det_metrics_rel_err"][0]:.3g} (detector), over the steps '
          f'{res["reg_metrics_rel_err"][1]:.3g} / '
          f'{res["det_metrics_rel_err"][1]:.3g}; the update at step 1 '
          f'{upd:.3g} of its norm, parameters {leaf:.3g} leaf-wise (at '
          f'{worst}, whose update is {worst_upd:.3g} of its norm); running '
          f'statistics, ALWA and EMA equal on every rank; validation '
          f'{many["reg_val"].tolist()} ({split_err:.3g} from one process '
          f'over the same batches, which is {batch_err:.3g} from itself '
          f'over whole batches), of the trained state '
          f'{many["reg_val_trained"].tolist()} ({trained_err:.3g} from one '
          f'process\'s); '
          f'rank 0\'s snapshot resumed on every rank; mAP '
          f'{many["det_map"][-1]:.4f} over {n_records} detections as one '
          f'process over them (its own forward: {one["det_map"][-1]:.4f}); '
          f'{spawn_s:.1f} s for the processes; f32 el0 step '
          f'{res["step_ms_ranks"]} ms a rank at {DP_BATCH[0] // world} rows '
          f'(synchronised batch norm through {backend}) against '
          f'{res["step_ms_one"]:.2f} ms for one process at {DP_BATCH[0]}; '
          f'a profiled step (2 steps) rank 0 / one process: busy '
          f'{many["reg_profile"]["busy_ms"] / 2:.2f} / '
          f'{one["reg_profile"]["busy_ms"] / 2:.2f} ms, launches '
          f'{many["reg_profile"]["launches"] / 2:.0f} / '
          f'{one["reg_profile"]["launches"] / 2:.0f}, wall '
          f'{many["reg_profile"]["wall_ms"] / 2:.2f} / '
          f'{one["reg_profile"]["wall_ms"] / 2:.2f} ms')
    return res


def det_map_over_ranks(ranks, world):
    """One process's ``DetectorEvaluator`` (no group) over every rank's
    detections, put back in the global batches' order: the APs and the
    count of records."""
    from tpudet3d_torch.detect import DetectorEvaluator
    m = DP_BATCH[1]
    items = det_items(m * DP_VAL_BATCHES, seed=9)
    ev = DetectorEvaluator(None)
    for i, lo in enumerate(range(0, m * DP_VAL_BATCHES, m)):
        dets = torch.zeros(m, *ranks[0]['det_dets'][i].shape[1:])
        for r, res in enumerate(ranks):
            dets[r::world] = res['det_dets'][i]
        ev.add_batch(None, *(a[lo:lo + m] for a in items[1:]), dets=dets)
    return det_map(ev), ev._n


def serving_fps(fn, calls=SHARD_CALLS):
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return 16 / sorted(ms)[len(ms) // 2] * 1e3


def sharded_serving(dev, wrappers, frames_np, plain, norm, gpu):
    """11d: ``build_engine()`` (bf16, full width) over 16 720p frames,
    unsharded, over one replica and over two replicas on cuda:0."""
    from tpudet3d_torch.infer import build_engine
    engine = build_engine(det_conf=0.0, device=dev)
    with cudnn_deterministic():
        whole = engine.infer_batch(frames_np)
        halves = engine.infer_batch(frames_np[:8]) + \
            engine.infer_batch(frames_np[8:])
        fps = {'unsharded': serving_fps(lambda: engine.infer_batch(
            frames_np))}
        out = {}
        for name, devices in (('1 replica', ['cuda:0']),
                              ('2 replicas', ['cuda:0', 'cuda:0'])):
            engine.shard(devices)
            rows, launches = drive(wrappers,
                                   lambda: engine.infer_batch(frames_np))
            k = len(devices)
            expect(launches == [k] * 4 + [0, 0, 0],
                   f'{name}: launches {launches}')
            check_results(rows, *FRAME[:2])
            ref = whole if k == 1 else halves
            same_results(rows, ref, f'{name} rows')
            same_results(rows, whole, f'{name} rows against the whole batch')
            diff = max(float(np.abs(np.float64(r[key])
                                    - np.float64(q[key])).max())
                       for r, q in zip(rows, whole) for key in r
                       if np.size(r[key]) and r[key].shape == q[key].shape)
            out[name] = dict(launches=launches, max_diff_whole_batch=diff,
                             equal_whole_batch=all(
                                 np.array_equal(r[key], q[key])
                                 for r, q in zip(rows, whole) for key in r))
            fps[name] = serving_fps(lambda: engine.infer_batch(frames_np))
        try:
            engine.infer_batch(frames_np[:3])
            expect(False, 'N=3 over 2 replicas did not raise')
        except ValueError:
            pass
        # the kernels at a slice's shapes against their plain versions
        errs = path_intermediates(engine, frames_np[:8], plain, norm)
    engine.det_model = engine.det_model
    expect(engine._replicas is None, 'a new detector kept the replicas')
    print(f'phase 11d sharded serving on {gpu}: frames/s '
          + ', '.join(f'{k} {v:.1f}' for k, v in fps.items())
          + f'; rows equal the unsharded engine\'s slices bit for bit '
          f'(whole batch: {out["2 replicas"]["equal_whole_batch"]}, '
          f'largest difference {out["2 replicas"]["max_diff_whole_batch"]:.3g}'
          f'); launches {[o["launches"] for o in out.values()]}; N=3 raises')
    return dict(fps=fps, runs=out, slice_errs=list(errs)), engine


def launches_by_card(fn, names, calls=5):
    """``{name: {card: launches per call}}`` of the kernels ``names`` over
    ``calls`` calls of ``fn``, from the device index of each kernel event
    of ``torch.profiler``; a session that records no device activity is
    repeated, up to three times.  The tracer may miss a launch now and
    then, so the counts can fall short; a card it lists did run the
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        events = device_events(prof)
        if events:
            break
    out = {n: {} for n in names}
    for e in events:
        for n in names:
            if n in e.name:
                by = out[n]
                by[e.device_index] = by.get(e.device_index, 0) + 1 / calls
    return out


def sharded_cards(world, wrappers, frames_np, gpu):
    """``--dp-cards``: ``build_engine()`` (bf16, full width) over 16 720p
    frames sharded over ``cuda:0`` to ``cuda:{world-1}``: each replica's
    rows bit for bit the unsharded engine's over the same slice, K1-K4
    launched once a replica on that replica's card, and frames/s
    unsharded and sharded (reported)."""
    from tpudet3d_torch.infer import build_engine
    dev = torch.device('cuda:0')
    engine = build_engine(det_conf=0.0, device=dev)
    n = len(frames_np)
    m = n // world
    with cudnn_deterministic():
        slices = [engine.infer_batch(frames_np[i * m:(i + 1) * m])
                  for i in range(world)]
        fps = {'unsharded': serving_fps(lambda: engine.infer_batch(
            frames_np))}
        devices = [f'cuda:{i}' for i in range(world)]
        engine.shard(devices)
        expect([str(r.device) for r, _ in engine._replicas] == devices,
               f'replicas on {[str(r.device) for r, _ in engine._replicas]}')
        rows, launches = drive(wrappers,
                               lambda: engine.infer_batch(frames_np))
        expect(launches == [world] * 4 + [0, 0, 0],
               f'{world} cards: launches {launches}')
        check_results(rows, *FRAME[:2])
        for i, ref in enumerate(slices):
            same_results(rows[i * m:(i + 1) * m], ref,
                         f'replica on cuda:{i}: rows of frames '
                         f'{i * m}-{(i + 1) * m - 1}')
        # ``world`` launches of each kernel a call (the counts above), and
        # each card runs it: one a replica on its own card
        by_card = launches_by_card(lambda: engine.infer_batch(frames_np),
                                   K1_K4_NAMES)
        for name, by in by_card.items():
            expect(sorted(by) == list(range(world)),
                   f'{name}: launched on cards {sorted(by)} ({by}), every '
                   f'card of {world} wanted')
        fps[f'{world} cards'] = serving_fps(
            lambda: engine.infer_batch(frames_np))
    print(f'sharded serving over {world} cards on {gpu}: rows equal the '
          f'unsharded engine\'s slices bit for bit; K1-K4 once a replica '
          f'on its card; frames/s ' + ', '.join(
              f'{k} {v:.1f}' for k, v in fps.items()) + ' (reported)')
    return dict(fps=fps, launches=launches, by_card={
        k: {str(d): v for d, v in by.items()} for k, by in by_card.items()})


def utilities(dev, engine, frames_np, gpu, tmp):
    """11e: the complexity CLI, a profiled serving call's trace, a sweep of
    2 trials."""
    import os

    from tpudet3d_torch.tools import get_complexity, optuna_optim
    from tpudet3d_torch.utils import profiling
    res = {}
    for cfg in ('configs/scene_regressor.py', EL0_CONFIG):
        r, text = quiet(get_complexity.main, ['--config', cfg])
        expect(r['params'] > 0 and r['macs'] > 0, f'complexity of {cfg}')
        res[cfg] = dict(params=r['params'], macs=r['macs'])
        print(f'phase 11e {cfg} on {gpu}: {r["params"]:,} parameters, '
              f'{r["macs"] / 1e6:.2f} MMac (convolutions and matrix '
              f'products, FlopCounterMode) at {r["input_shape"]}')
    logdir = os.path.join(tmp, 'trace')
    with profiling.trace(logdir):
        for _ in range(2):      # the tracer may miss a first launch
            with profiling.annotate('serving call'):
                engine.infer_batch(frames_np)
        torch.cuda.synchronize()
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    seen = [k for k in K1_K4_NAMES if any(k in n for n in names)]
    expect(seen == list(K1_K4_NAMES) and 'serving call' in names,
           f'the trace names {seen} of {K1_K4_NAMES}')
    res['trace_kernels'] = seen

    path = os.path.join(tmp, 'sweep.py')
    with open(path, 'w') as f:
        f.write(f"exec(open('configs/scene_regressor_el0_wing.py').read())\n"
                f"data.update(synthetic=True, synthetic_length=1024, "
                f"train_batch_size={TRAIN_BATCH}, val_batch_size="
                f"{TRAIN_BATCH})\noutput_dir = {tmp!r}\n")
    t0 = time.perf_counter()
    study, text = quiet(optuna_optim.main, ['--config', path, *OPTUNA_ARGS])
    sweep_s = time.perf_counter() - t0
    trials = [(t.params, t.value) for t in study.trials]
    expect(len(trials) == 2 and all(np.isfinite(v) for _, v in trials),
           f'sweep trials {trials}')
    res.update(trials=trials, sweep_s=sweep_s)
    print(f'phase 11e on {gpu}: the trace names K1-K4; sweep of 2 trials x '
          f'1 epoch at '
          f'batch {TRAIN_BATCH} in {sweep_s:.1f} s: ' + '; '.join(
              f'w {p["w"]:.3f} eps {p["eps"]:.3f} -> SADD {v:.4f}'
              for p, v in trials))
    return res


def parallel_path(dev, wrappers, frames_np, plain, norm, gpu):
    """Phase 11: 11a-11e; the launches of each driven run."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        imported = reference_import(dev, tmp, gpu)
        dp = dp_path(dev, wrappers, gpu, tmp)
        shard, engine = sharded_serving(dev, wrappers, frames_np, plain, norm,
                                        gpu)
        tools = utilities(dev, engine, frames_np, gpu, tmp)
    launches = {'dp validation': dp['regressor']['val_launches'],
                'dp detector validation': dp['detector']['launches'],
                **{f'shard {k}': v['launches']
                   for k, v in shard['runs'].items()}}
    return dict(imported=imported, dp=dp, shard=shard, tools=tools,
                launches=launches)


# phase 12: the card against the JAX package's golden record of the bf16
# and int8 product route (tests/fixtures/torch_port_golden, written by
# tests/torch_port_golden.py): every input remade from its manifest
GOLDEN_ROOT = 'tests/fixtures/torch_port_golden'


def golden_path(dev, wrappers, root=GOLDEN_ROOT):
    """Phase 12: cases A-E of the golden record on ``dev``.  Prints one JSON
    line of every value's error beside its yardstick; fatal on any miss.
    On the card each run's launches must be the path's own."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    count = dev.type == 'cuda'
    manifest, arrays = golden.load_golden(root)
    out = dict(serving={}, int8={}, train={}, launches={})
    for case in sorted(manifest['serving']):
        res, int8, launches = golden.golden_serving(manifest, arrays, case,
                                                    dev, wrappers, count)
        out['serving'][case], out['int8'][case] = res, int8
        out['launches'].update(launches)
    for case in sorted(manifest['train']):
        fn = (golden.golden_regressor_step
              if manifest['train'][case]['kind'] == 'regressor'
              else golden.golden_detector_step)
        out['train'][case], launches, _ = fn(manifest, arrays, case, dev,
                                             wrappers, count)
        out['launches'].update(launches)
    misses = []
    for group in ('serving', 'int8'):
        for case, res in out[group].items():
            misses += [f'{group} {case} {k}' for k, v in res.items()
                       if k not in golden.GOLDEN_REPORTED and not v['ok']]
    misses += [f'train {case}' for case, res in out['train'].items()
               if not res['ok']]
    out['misses'] = misses
    print('phase 12 golden record: ' + json.dumps(
        {k: v for k, v in out.items() if k != 'launches'}))
    expect(not misses, f'phase 12: the port misses the JAX record: {misses}')
    return out


# phase 12b: both training CLIs under torchrun, one process on the card
TORCHRUN_CLIS = (
    ('regressor', 'tpudet3d_torch.tools.main', 'configs/scene_regressor.py',
     ("data.update(synthetic=True, synthetic_length=64, train_batch_size=32,"
      " val_batch_size=32, max_epochs=1)",
      "utils.update(save_freq=1, eval_freq=1, print_freq=1)"),
     'train.log'),
    ('detector', 'tpudet3d_torch.tools.train_detector',
     'configs/detection/mnv2_ssd_300_scene_cascade.py',
     ("data.update(synthetic=True, synthetic_hard=True, synthetic_length=64,"
      " train_batch_size=16, val_batch_size=16, max_epochs=1)",
      "utils.update(save_freq=1, print_freq=1)"),
     'det_train.log'))


def same_snapshots(a, b, what):
    """Expect two loaded snapshots equal bit for bit, key by key."""
    if isinstance(a, dict):
        expect(isinstance(b, dict) and a.keys() == b.keys(),
               f'{what}: keys {sorted(a)} / {sorted(b)}')
        for k in a:
            same_snapshots(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, (list, tuple)):
        expect(len(a) == len(b), f'{what}: lengths')
        for i, (x, y) in enumerate(zip(a, b)):
            same_snapshots(x, y, f'{what}[{i}]')
    elif isinstance(a, torch.Tensor):
        expect(torch.equal(a, b), f'{what} differs')
    else:
        expect(a == b, f'{what}: {a} / {b}')


def cli_state(kind, cfg, dev):
    """A fresh train state of the CLI's config, for ``resume_from``."""
    if kind == 'regressor':
        from tpudet3d_torch.train import create_train_state
        return create_train_state(cfg, device=dev)
    from tpudet3d_torch.detect import SSDDetector
    from tpudet3d_torch.detect.train import create_detector_state
    model = SSDDetector(num_classes=int(cfg.model.num_classes),
                        width_mult=float(cfg.model.width_mult),
                        dtype=torch.bfloat16, cascade=True)
    return create_detector_state(model, lr=float(cfg.optim.lr),
                                 momentum=float(cfg.optim.momentum),
                                 wd=float(cfg.optim.wd), device=dev)


def resume_again(dev, kind, cfg_path, snap, out_dir):
    """``resume_from`` of the snapshot ``snap`` into a fresh state of the
    CLI's config, saved again as ``out_dir/snap_0.pt``; returns that
    path."""
    import os
    from tpudet3d_torch.core.config import read_py_config
    from tpudet3d_torch.utils.checkpoint import resume_from, save_snap
    cfg = read_py_config(cfg_path)
    cfg.data_parallel = dict(use_parallel=False)
    state, start = resume_from(cli_state(kind, cfg, dev), snap)
    expect(start == 1, f'{snap}: resumed at epoch {start}')
    save_snap(state, 0, out_dir)
    return os.path.join(out_dir, 'snap_0.pt')


def resume_work(dev, world, rank, kind, cfg_path, snap, root):
    """:func:`resume_again` on one rank of a group (``spawn_group``)."""
    import os
    return resume_again(dev, kind, cfg_path, snap,
                        os.path.join(root, f'again_{rank}'))


def torchrun_clis(dev, tmp, world=1):
    """Each training CLI through ``torch.distributed.run`` with ``world``
    processes, one a card, on its config cut to one short epoch of
    synthetic items (bf16; the batch sizes are global): the NCCL group of
    ``world`` from torchrun's environment in rank 0's log, that one log
    file, one snapshot, and ``resume_from`` of it saved again bit for bit
    (on every rank of an NCCL group of ``world``)."""
    import glob
    import os
    out = {}
    for kind, module, config, overrides, log in TORCHRUN_CLIS:
        root = os.path.join(tmp, f'torchrun_{kind}')
        os.makedirs(root)
        cfg_path = os.path.join(root, 'config.py')
        with open(cfg_path, 'w') as f:
            f.write('\n'.join([f'exec(open({os.path.abspath(config)!r})'
                               '.read())', *overrides, '']))
        run_dir = os.path.join(root, 'run')
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc_per_node', str(world), '-m', module, '--config',
             cfg_path,
             '--output_dir', run_dir], capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        expect(res.returncode == 0, f'torchrun {module}: rc '
               f'{res.returncode}\n{res.stdout[-3000:]}\n'
               f'{res.stderr[-3000:]}')
        logs = glob.glob(os.path.join(run_dir, log + '-*'))
        expect(len(logs) == 1, f'torchrun {module}: rank 0 logs {logs}')
        text = open(logs[0]).read()
        expect(f'process group: nccl, world {world}, rank 0' in text,
               f'torchrun {module}: no NCCL group of {world} in the log')
        snaps = sorted(glob.glob(os.path.join(run_dir, 'snap_*.pt')))
        expect([os.path.basename(s) for s in snaps] == ['snap_0.pt'],
               f'torchrun {module}: snapshots {snaps}')
        if world == 1:
            again = [resume_again(dev, kind, cfg_path, snaps[0],
                                  os.path.join(root, 'again'))]
        else:
            again = spawn_group(world, 'nccl', 'cuda:{rank}', resume_work,
                                (kind, cfg_path, snaps[0], root), root, 300)
        saved = torch.load(snaps[0], map_location='cpu', weights_only=True)
        for r, path in enumerate(again):
            same_snapshots(saved, torch.load(path, map_location='cpu',
                                             weights_only=True),
                           f'torchrun {module} snapshot resumed on rank {r}')
        out[kind] = dict(seconds=seconds, world=world,
                         log=os.path.basename(logs[0]),
                         snapshot='snap_0.pt', resumed_bit_for_bit=True,
                         resumed_ranks=len(again))
        print(f'torchrun {module}: NCCL world {world}, {out[kind]["log"]}, '
              f'snap_0.pt resumed bit for bit on {len(again)} rank(s) '
              f'({seconds:.1f} s)')
    return out


# phase 13: Swin-T's shifted-window attention (K8) at the four stage shapes,
# and the Swin-T regressor served through the graphed infer_batch
SWIN_CONFIG = 'configs/scene_regressor_swint.py'
K8_CROPS = 256                 # the benchmark's call: 32 frames × 8 rows
# Swin-T's stages at 224² crops: (map side, heads, blocks); heads of 32
# channels, 7×7 windows, odd blocks shifted by 3 but on the one-window map
K8_STAGES = ((56, 3, 2), (28, 6, 2), (14, 12, 6), (7, 24, 2))
K8_WINDOW, K8_SHIFT, K8_F64_CROPS = 7, 3, 16
# launches of K1-K8 in one Swin-T infer_batch, eager or replayed
SWIN_LAUNCHES = [1, 1, 1, 1, 0, 0, 0, 12]


def k8_work(side, heads, crops):
    """``(bytes, ops)`` of one K8 launch: each token's q, k, v read and its
    output written once in bf16, the bias table in float32, and
    2·(2·49·49·32) operations a window and head."""
    c = 32 * heads
    tokens = crops * side * side
    windows = tokens // K8_WINDOW ** 2
    n_bytes = tokens * 4 * c * 2 + (2 * K8_WINDOW - 1) ** 2 * heads * 4
    return n_bytes, windows * heads * 2 * (2 * K8_WINDOW ** 4 * 32)


def check_k8(dev, ops):
    """K8 against its plain version at Swin-T's four stage shapes at
    :data:`K8_CROPS` crops, unshifted and shifted (the one-window map too,
    where the model never shifts): within two bf16 ulps of the output's
    largest magnitude, and on the first crops no farther from the float64
    function than 1.5× the plain version (the card test's rules), one
    launch a call; then each shape timed, kernel and plain version, and a
    Swin-T call's 12 launches summed (shift 3 on the odd blocks of the
    first three stages)."""
    attend, plain = ops
    out = {'shapes': {}, 'err': 0.0, 'rel_err': 0.0}
    for side, heads, _ in K8_STAGES:
        for shift in (0, K8_SHIFT):
            g = torch.Generator(device=dev).manual_seed(side + shift)
            qkv = (2 * torch.randn((K8_CROPS, side, side, 96 * heads),
                                   generator=g, device=dev)
                   ).to(torch.bfloat16)
            table = torch.randn(((2 * K8_WINDOW - 1) ** 2, heads),
                                generator=g, device=dev)
            args = (qkv, table, heads, K8_WINDOW, shift)
            attend.launches = 0
            with torch.no_grad():
                got = attend(*args)
            ref = plain(*args)
            if dev.type == 'cuda':
                torch.cuda.synchronize()
                expect(attend.launches == 1, f'K8 launches {attend.launches}')
            scale = ref.float().abs().max().item()
            gap = max_err(got, ref)
            name = f'{side}x{side}x{heads} shift {shift}'
            expect(gap <= 2 * 2 ** -7 * scale,
                   f'K8 {name}: |kernel - plain| {gap:.3g} over two bf16 '
                   f'ulps of {scale:.3g}')
            n = K8_F64_CROPS
            exact = plain(qkv[:n].double(), table.double(), heads,
                          K8_WINDOW, shift, shift > 0)
            k8_err = (got[:n].double() - exact).abs().max().item()
            plain_err = (ref[:n].double() - exact).abs().max().item()
            expect(k8_err <= 1.5 * plain_err + 1e-6,
                   f'K8 {name}: {k8_err:.3g} from float64 against the '
                   f'plain version\'s {plain_err:.3g}')
            del exact, ref
            with torch.no_grad():
                ms = time_ms(lambda: attend(*args), 50)
                plain_ms = time_ms(lambda: plain(*args), 3)
            out['shapes'][name] = dict(ms=ms, plain_ms=plain_ms, err=gap,
                                       scale=scale, f64_err=k8_err,
                                       plain_f64_err=plain_err,
                                       bound=bound_ms(*k8_work(
                                           side, heads, K8_CROPS),
                                           peak_ops=BF16_FLOPS))
            out['err'] = max(out['err'], gap)
            out['rel_err'] = max(out['rel_err'], gap / scale)
            print(f'K8 {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, max '
                  f'|kernel - plain| {gap:.3g} of {scale:.3g}, from float64 '
                  f'{k8_err:.3g} (plain {plain_err:.3g})')
    n_bytes = n_ops = 0
    for key in ('ms', 'plain_ms'):
        out[key] = 0.0
    for side, heads, blocks in K8_STAGES:
        shifted = blocks // 2 if side > K8_WINDOW else 0
        b, o = k8_work(side, heads, K8_CROPS)
        n_bytes, n_ops = n_bytes + blocks * b, n_ops + blocks * o
        for key in ('ms', 'plain_ms'):
            sh = out['shapes']
            out[key] += ((blocks - shifted)
                         * sh[f'{side}x{side}x{heads} shift 0'][key]
                         + shifted * sh[f'{side}x{side}x{heads} shift '
                                        f'{K8_SHIFT}'][key])
    out['bound'] = bound_ms(n_bytes, n_ops, peak_ops=BF16_FLOPS)
    out['bytes'], out['ops'] = n_bytes, n_ops
    return out


def swin_path(dev, wrappers, frames_np):
    """Phase 13b: ``build_engine`` on the Swin-T config through the eager
    ``_pipeline_batch`` (launches counted by the wrappers) and the graphed
    ``infer_batch`` (a replay's launches counted by kernel name,
    :func:`drive_replay`), each exactly :data:`SWIN_LAUNCHES`; the
    replayed rows bit for bit the eager ones under cuDNN's deterministic
    algorithms."""
    from tpudet3d_torch.infer import build_engine
    h, w = FRAME[:2]
    engine = build_engine(SWIN_CONFIG, det_conf=0.0, device=dev)
    out = {}
    with cudnn_deterministic():
        eager, n_eager = drive(wrappers, lambda: engine._pipeline_batch(
            engine._upload(frames_np), h, w))
        res, n = drive_replay(wrappers, lambda: engine.infer_batch(
            frames_np))
        if dev.type == 'cuda':
            (graph,) = engine._graphs.values()
            expect(torch.equal(graph.static_out, eager),
                   'Swin-T: the replayed rows differ from the eager ones')
            out['graph_stats'] = dict(engine.graph_stats)
    print(f'phase 13 Swin-T infer_batch({len(frames_np)}): launches K1-K8 '
          f'eager {n_eager}, replayed {n}')
    for what, got in (('eager', n_eager), ('replayed', n)):
        expect(got == SWIN_LAUNCHES, f'Swin-T {what} launches {got}, '
               f'expected {SWIN_LAUNCHES}')
    expect(len(res) == len(frames_np), 'Swin-T infer_batch result count')
    check_results(res, h, w)
    out.update(launches_eager=n_eager, launches=n,
               detections=sum(len(r['scores']) for r in res))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default='', help='also write the numbers here')
    ap.add_argument('--dp-cards', type=int, default=0,
                    help='instead of the phases: over this many cards, one '
                         'process a card through NCCL, the data-parallel '
                         'comparison of phase 11, both training CLIs under '
                         'torchrun, and the engine sharded over the cards')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    if args.dp_cards:
        return dp_cards(args.dp_cards, args.out)
    return run(torch.device('cuda'), args.out)


def dp_cards(world, out_path):
    """``--dp-cards``: over ``world`` cards, one process a card through
    NCCL, :func:`compare_dp`, both training CLIs under ``torchrun``
    (:func:`torchrun_clis`), and the engine sharded over the cards
    (:func:`sharded_cards`); then the contract's last line."""
    import tempfile

    from tpudet3d_torch.detect import decode_detections
    from tpudet3d_torch.infer.epilogue import head_epilogue
    from tpudet3d_torch.kernels.build import build, library
    from tpudet3d_torch.ops import box3d, crop_and_resize, resize_bilinear
    from tpudet3d_torch.ops import quant as qops
    expect(torch.cuda.device_count() >= world,
           f'{world} cards asked for, {torch.cuda.device_count()} visible')
    build()
    library()
    gpu = gpu_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = (resize_bilinear, crop_and_resize, decode_detections,
                head_epilogue, box3d.iou_oriented_boxes, qops.quantize_input,
                qops.rescale)
    dev = torch.device('cuda:0')
    frames = np.random.RandomState(1).randint(0, 256, (16, *FRAME)) \
        .astype(np.uint8)
    t0, seconds = time.perf_counter(), {}
    with tempfile.TemporaryDirectory() as tmp:
        res = compare_dp(dev, tmp, gpu, world, 'nccl')
        seconds['compare_dp'] = time.perf_counter() - t0
        clis = torchrun_clis(dev, tmp, world)
        seconds['torchrun'] = time.perf_counter() - t0 - sum(
            seconds.values())
    shard = sharded_cards(world, wrappers, frames, gpu)
    seconds['sharded'] = time.perf_counter() - t0 - sum(seconds.values())
    print(f'--dp-cards {world}: ' + ', '.join(
        f'{k} {v:.1f} s' for k, v in seconds.items()))
    if out_path:
        with open(out_path, 'w') as f:
            json.dump({'gpu': gpu, 'dp_cards': res, 'torchrun': clis,
                       'sharded': shard, 'seconds': seconds}, f, indent=1)
    print(gpu)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def run(dev, out_path, iters=20):
    """All phases on ``dev``; ``iters`` sets the timing loops of phase
    7's bf16 and int8 serving (half as many calls each)."""
    from tpudet3d_torch.detect import (decode_detections,
                                       decode_detections_plain)
    from tpudet3d_torch.infer import build_engine
    from tpudet3d_torch.infer.engine import REG_OFFSET, REG_SCALE
    from tpudet3d_torch.infer.epilogue import (head_epilogue,
                                               head_epilogue_plain)
    from tpudet3d_torch.kernels.build import build, library
    from tpudet3d_torch.ops import box3d
    from tpudet3d_torch.ops import (crop_and_resize, crop_and_resize_plain,
                                    resize_bilinear, resize_bilinear_plain)
    from tpudet3d_torch.ops import quant as qops
    iou = box3d.iou_oriented_boxes
    int8_wrappers = (qops.quantize_input, qops.rescale)
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
    k1 = check_k1(dev, frames, (resize_bilinear, resize_bilinear_plain))
    k2 = check_k2(dev, (crop_and_resize, crop_and_resize_plain), norm)
    from tpudet3d_torch.detect import generate_anchors
    anchors = torch.from_numpy(generate_anchors()).to(dev)
    k3 = check_k3(dev, (decode_detections, decode_detections_plain),
                  anchors)
    k4 = check_k4(dev, (head_epilogue, head_epilogue_plain))
    k5, k5_scipy = check_k5(dev, (iou, box3d.iou_oriented_boxes_plain,
                                  box3d.iou_single_host))
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
    del engine
    done('3 serving path')

    # 5. the evaluation path at full width
    evaluation = eval_path(dev, wrappers + (iou,) + int8_wrappers)
    done('5 evaluation path')

    # 6. the flagship EfficientNet-lite0 regressor and the cascade detector
    # from converted snapshots: serving, 288² crops, the demo loop with the
    # tracker, and the Detector wrapper
    flagship = flagship_path(dev, wrappers + (iou,) + int8_wrappers,
                             frames_np, (
        resize_bilinear_plain, crop_and_resize_plain,
        decode_detections_plain, crop_and_resize, head_epilogue,
        head_epilogue_plain), norm)
    print(f'el0 demo loop on {gpu}: {flagship["demo"]["fps"]:.2f} frames/s '
          f'over {flagship["demo"]["frames"]} frames of 720p, assignment '
          f'route {flagship["demo"]["assignment"]}')
    runs = flagship['launches']
    done('6 flagship path')

    # 7. int8 serving (MNv3 and el0, K6 and K7) and the el0 export
    int8 = int8_path(dev, wrappers + (iou,) + int8_wrappers, frames_np,
                     iters)
    done('7 int8 path')

    # 8. regressor training (MNv3-large-21k and el0 with its EMA) at full
    # width, the card's f32 step against the CPU's, the eval step with K5
    training = training_path(dev, wrappers + (iou,) + int8_wrappers, gpu)
    done('8 training path')

    # 9. the training loop of el0 at full width: data, epochs, validation
    # with K5, snapshots, resume, serving the trained snapshot
    loop = loop_path(dev, wrappers + (iou,) + int8_wrappers, frames_np, gpu)
    done('9 training loop')

    # 10. detector training at full width: the card's step against the
    # CPU's, the loop with validation through K3, resume, serving and
    # self-labelling from the trained snapshot
    det = detector_training_path(dev, wrappers + (iou,) + int8_wrappers,
                                 frames_np, gpu)
    done('10 detector training')

    # 11. the last modules: reference checkpoints, data parallelism under
    # process groups, sharded serving, the tools
    parallel = parallel_path(dev, wrappers + (iou,) + int8_wrappers,
                             frames_np, (
        resize_bilinear_plain, crop_and_resize_plain,
        decode_detections_plain, crop_and_resize, head_epilogue,
        head_epilogue_plain), norm, gpu)
    done('11 parallel and tools')

    # 12. the card against the JAX package's golden record of the bf16 and
    # int8 product route, and both training CLIs under torchrun
    golden_res = golden_path(dev, wrappers + (iou,) + int8_wrappers)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        golden_res['torchrun'] = torchrun_clis(dev, tmp)
    done('12 golden record and torchrun')

    # 13. Swin-T's window attention (K8) at its four stage shapes, and the
    # Swin-T regressor served through the graphed infer_batch
    from tpudet3d_torch.ops.attention import (window_attention,
                                              window_attention_plain)
    k8 = check_k8(dev, (window_attention, window_attention_plain))
    swin = swin_path(dev, wrappers + (iou,) + int8_wrappers
                     + (window_attention,), frames_np)
    done('13 window attention and Swin-T')
    print('seconds by phase: ' + ', '.join(f'{k} {v:.1f}'
                                           for k, v in phase_s.items()))

    def int8_path_err(key):
        """K6's or K7's largest |kernel - plain| in phase 7: its cases, the
        served convs' shapes and the engine rows through it."""
        return max([int8['kernels'][key.lower() + '_err']]
                   + [int8[m]['times'][key]['err'] for m in ('mnv3', 'el0')]
                   + [int8[m]['rows_err'] for m in ('mnv3', 'el0')])

    kernels = []
    for (name, src, replaces, err), n, n_eval, n_el0 in zip((
            ('K1 preprocess_resize', 'tpudet3d_torch/kernels/csrc/resize.cu',
             'tpudet3d/ops/image.py:19', max(k1, e1)),
            ('K2 crop_resize_normalize', 'tpudet3d_torch/kernels/csrc/crop.cu',
             'tpudet3d/ops/image.py:87', max(k2, e2)),
            ('K3 decode_nms', 'tpudet3d_torch/kernels/csrc/decode_nms.cu',
             'tpudet3d/detect/nms.py:86', max(k3, e3)),
            ('K4 head_epilogue',
             'tpudet3d_torch/kernels/csrc/head_epilogue.cu',
             'tpudet3d/infer/engine.py:270', max(k4, e4)),
            ('K5 iou_oriented_boxes',
             'tpudet3d_torch/kernels/csrc/box3d_iou.cu',
             'tpudet3d/ops/box3d.py:161', max(k5, evaluation['k5_err'])),
            ('K6 quantize_input', 'tpudet3d_torch/kernels/csrc/quant.cu',
             'tpudet3d/infer/quant.py:158', int8_path_err('K6')),
            ('K7 int8_rescale', 'tpudet3d_torch/kernels/csrc/quant.cu',
             'tpudet3d/infer/quant.py:171', int8_path_err('K7'))),
            launches + [evaluation['launches'][4]]
            + int8['launches']['mnv3'][5:],
            evaluation['launches'], runs['el0 infer_batch(16)']):
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': n, 'max_abs_err': err,
            'launches_eval': n_eval, 'launches_el0': n_el0})
    for i, k in enumerate(kernels):
        for key, part in (('flagship', flagship), ('train', training),
                          ('loop', loop), ('det', det), ('int8', int8),
                          ('parallel', parallel), ('golden', golden_res)):
            k[f'launches_{key}'] = {run: n[i] for run, n in
                                    part['launches'].items()}
    kernels[4]['max_abs_err_scipy'] = k5_scipy
    kernels[5]['conv_routes'] = int8['mnv3']['times']['K6']['conv_routes']
    t = int8['mnv3']['times']['K7']
    kernels[6].update(
        ms=t['ms'], device_ms=t['device_ms'], plain_ms=t['plain_ms'],
        bound_ms=t['bound'][0], bound_by=t['bound'][1], bytes=t['bytes'],
        library_ms=t['library_ms'], library_device_ms=t['library_device_ms'],
        el0=int8['el0']['times']['K7'], int_mm=int8['mnv3']['times']['int_mm'])
    k8_row = {
        'name': 'K8 window_attention', 'route': 'cuda',
        'source': 'tpudet3d_torch/kernels/csrc/window_attn.cu',
        'replaces': None, 'launches': swin['launches'][7],
        'launches_eager': swin['launches_eager'][7],
        'max_abs_err': k8['err'], 'max_rel_err': k8['rel_err'],
        'ms': k8['ms'], 'plain_ms': k8['plain_ms'],
        'bound_ms': k8['bound'][0], 'bound_by': k8['bound'][1],
        'library_ms': None, 'bytes': k8['bytes'], 'ops': k8['ops'],
        'shapes': k8['shapes']}
    for k in kernels:
        print(f"{k['name']}: {k['launches']} launches on its main "
              f"path ({k['launches_eval']} on the evaluation path, "
              f"{k['launches_el0']} on el0 infer_batch(16), "
              f"{k['launches_flagship']['demo loop']} on the demo loop, "
              f"{k['launches_int8']} int8 infer_batch(16), "
              f"{k['launches_train']} on the training path, "
              f"{k['launches_loop']} on the training loop, "
              f"{k['launches_det']} on detector training, "
              f"{k['launches_parallel']} on phase 11, "
              f"{k['launches_golden']} on phase 12), max "
              f'|kernel - plain| {k["max_abs_err"]:.3g}')
    print(f"{k8_row['name']}: {k8_row['ms']:.4f} ms a Swin-T call of "
          f"{K8_CROPS} crops (12 launches), plain {k8_row['plain_ms']:.4f} "
          f"ms, library none, bound {k8_row['bound_ms']:.4f} ms "
          f"({k8_row['bound_by']}), {k8_row['launches']} launches a replayed "
          f"Swin-T infer_batch({len(frames_np)}) "
          f"({k8_row['launches_eager']} eager), max |kernel - plain| "
          f"{k8_row['max_abs_err']:.3g} ({k8_row['max_rel_err']:.3g} of the "
          f"output's largest)")
    kernels.append(k8_row)
    print(gpu)
    print(json.dumps({'kernels': kernels}))
    if out_path:
        with open(out_path, 'w') as f:
            json.dump({'gpu': gpu, 'build_s': build_s, 'kernels': kernels,
                       'max_det_128': wide,
                       'evaluation': evaluation, 'flagship': flagship,
                       'int8': int8, 'training': training,
                       'loop': loop, 'detector_training': det,
                       'parallel': parallel, 'golden': golden_res,
                       'swin': swin,
                       'phase_s': phase_s,
                       'torch': torch.__version__,
                       'cuda': torch.version.cuda}, f, indent=1)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
