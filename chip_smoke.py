#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpudet3d_torch``) on one NVIDIA
GPU: ``python3 chip_smoke.py [--out FILE]``.

Phases, each fatal on failure:

1. Build the CUDA kernels from ``tpudet3d_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (K1 resize at N=1 and 16 of 720p, K2 crop on 128
   boxes with TTA off and on, K3 decode+NMS at N=16, A=2044, C=9, K=32 in
   the greedy, soft-NMS and box-vote settings) and time kernel, plain
   version and, where one exists, the PyTorch library call.
3. Drive the serving path at full width (MNv2-SSD-300 w1.0 + MNv3-large-21k,
   bf16, 224² crops, max_detections 8, random weights from seed 0) through
   ``infer_batch`` (16 frames), ``__call__`` and ``run_async`` /
   ``wait_and_grab``; check the outputs and that every kernel's launch
   counter rose; hold the path's own intermediates against the plain
   versions.
4. Time server frames/s at batches 16 and 32 (device-resident input,
   median of 3 loops) and the blocked single-frame latency.

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is unavailable or any phase fails.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS = 67e12             # H100 SXM, non-tensor float32, published
FRAME = (720, 1280, 3)


def expect(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def time_ms(fn, iters):
    """Mean device time of ``fn`` over back-to-back calls (CUDA events,
    after one warm-up call; the L2 cache is not flushed)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def engine_like_boxes(n, k, h, w, seed):
    """Boxes as the serving path makes them: inside the frame, some on its
    edges, some thinner than a pixel."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-40, w, (n, k))
    y0 = rng.uniform(-40, h, (n, k))
    b = np.stack([x0, y0, x0 + rng.uniform(0.2, w / 2, (n, k)),
                  y0 + rng.uniform(0.2, h / 2, (n, k))], -1)
    return np.clip(b, 0, [w, h, w, h]).astype(np.float32)


def check_k1(dev, frames, ops):
    resize_bilinear, resize_bilinear_plain, resize_weights = ops
    err = 0.0
    for n in (1, 16):
        f = frames[:n]
        ref = resize_bilinear_plain(f, (300, 300), True, 1 / 255.0)
        for dtype, tol in ((torch.bfloat16, 2 ** -8), (torch.float32, 1e-5)):
            e = max_err(resize_bilinear(f, (300, 300), True, 1 / 255.0,
                                        dtype), ref)
            print(f'K1 N={n} {dtype}: max |kernel - plain| = {e:.3g} '
                  f'(tol {tol:.3g})')
            expect(e <= tol, f'K1 N={n} {dtype} disagrees: {e}')
            err = max(err, e)
    run = lambda: resize_bilinear(frames, (300, 300), True, 1 / 255.0,  # noqa
                                  torch.bfloat16)
    x_f32 = frames.permute(0, 3, 1, 2).float().contiguous()
    taps_y = (resize_weights(FRAME[0], 300, dev) > 0).sum()
    taps_x = (resize_weights(FRAME[1], 300, dev) > 0).sum()
    n = frames.shape[0]
    n_bytes = frames.numel() + n * 300 * 300 * 3 * 2
    n_ops = 2 * 3 * n * int(taps_y) * int(taps_x)
    return dict(
        err=err, ms=time_ms(run, 50),
        plain_ms=time_ms(lambda: resize_bilinear_plain(
            frames, (300, 300), True, 1 / 255.0, torch.bfloat16), 5),
        library_ms=time_ms(lambda: F.interpolate(
            x_f32, size=(300, 300), mode='bilinear', antialias=True,
            align_corners=False), 20),
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


def check_k2(dev, frames, ops, norm):
    crop_and_resize, crop_and_resize_plain = ops
    boxes = torch.from_numpy(engine_like_boxes(16, 8, *FRAME[:2], 1)).to(dev)
    args = ((224, 224), True, norm[0], norm[1])
    err = 0.0
    for mirror in (False, True):
        ref = crop_and_resize_plain(frames, boxes, *args, mirror)
        for dtype, tol in ((torch.bfloat16, 2 ** -7 + 1e-4),
                           (torch.float32, 1e-4)):
            e = max_err(crop_and_resize(frames, boxes, *args, mirror, dtype),
                        ref)
            print(f'K2 128 boxes mirror={mirror} {dtype}: max |kernel - '
                  f'plain| = {e:.3g} (tol {tol:.3g})')
            expect(e <= tol, f'K2 mirror={mirror} {dtype} disagrees: {e}')
            err = max(err, e)
    # library yardstick: grid_sample with border padding on an f32 frame
    x_f32 = frames.permute(0, 3, 1, 2).float().contiguous()
    b = boxes
    side = (b[..., 2:] - b[..., :2]).clamp(min=1.0)                # [N,K,2]
    t = torch.arange(224, device=dev, dtype=torch.float32) + 0.5
    sx = t * side[..., 0:1] / 224 - 0.5 + b[..., 0:1]             # [N,K,224]
    sy = t * side[..., 1:2] / 224 - 0.5 + b[..., 1:2]
    gx = (2 * sx + 1) / FRAME[1] - 1
    gy = (2 * sy + 1) / FRAME[0] - 1
    grid = torch.stack([gx[..., None, :].expand(-1, -1, 224, -1),
                        gy[..., :, None].expand(-1, -1, -1, 224)], -1)
    grid = grid.reshape(16, 8 * 224, 224, 2)
    n_out = boxes.shape[0] * boxes.shape[1] * 224 * 224
    n_bytes = 3 * touched_pixels(boxes, *FRAME[:2], (224, 224)) \
        + boxes.numel() * 4 + n_out * 3 * 2
    n_ops = n_out * 3 * 8
    return dict(
        err=err,
        ms=time_ms(lambda: crop_and_resize(frames, boxes, *args, False,
                                           torch.bfloat16), 50),
        plain_ms=time_ms(lambda: crop_and_resize_plain(
            frames, boxes, *args, False, torch.bfloat16), 5),
        library_ms=time_ms(lambda: F.grid_sample(
            x_f32, grid, mode='bilinear', padding_mode='border',
            align_corners=False), 20),
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


def check_k3(dev, ops, anchors):
    decode_detections, decode_detections_plain = ops
    rng = np.random.RandomState(2)
    logits = (rng.standard_normal((16, 2044, 10)) * 2.0).astype(np.float32)
    logits[:, 100:140] = logits[:, 99:100]              # exact score ties
    deltas = (rng.standard_normal((16, 2044, 4)) * 0.5).astype(np.float32)
    logits, deltas = (torch.from_numpy(a).to(dev) for a in (logits, deltas))
    base = dict(score_thr=0.02, iou_thr=0.45, max_per_img=8, pre_nms_k=32)
    err = 0.0
    for name, kw in (('greedy', {}),
                     ('soft', dict(soft_nms_sigma=0.5, soft_nms_dup_iou=0.75)),
                     ('vote', dict(box_vote_iou=0.6))):
        kw = dict(base, **kw)
        err = max(err, compare_dets(
            decode_detections(logits, deltas, anchors, **kw),
            decode_detections_plain(logits, deltas, anchors, **kw),
            f'K3 N=16 {name}'))
    n_bytes = (logits.numel() + deltas.numel() + anchors.numel()
               + 16 * 8 * 6) * 4
    # softmax (sub, exp, add, div per logit), decode, and the K^2 IoUs of
    # each (image, class)
    n_ops = logits.numel() * 4 + 16 * 9 * (32 * 32 * 12 + 32 * 16)
    return dict(
        err=err,
        ms=time_ms(lambda: decode_detections(logits, deltas, anchors,
                                             **base), 50),
        plain_ms=time_ms(lambda: decode_detections_plain(
            logits, deltas, anchors, **base), 3),
        library_ms=None, bound=bound_ms(n_bytes, n_ops))


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
          f'K1/K2/K3 = {launches}')
    for f, n in zip(wrappers, launches):
        expect(n > 0, f'{f.__name__} was never launched on the main path')
    return launches


def path_intermediates(engine, frames_np, plain, norm):
    """The path's own stage-1 outputs through the plain versions."""
    resize_plain, crop_plain, decode_plain, crop = plain
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
    return e1, e2, e3


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
    from tpudet3d_torch.kernels.build import build, library
    from tpudet3d_torch.ops import (crop_and_resize, crop_and_resize_plain,
                                    resize_bilinear, resize_bilinear_plain,
                                    resize_weights)
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

    # 2. kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (16, *FRAME), dtype=torch.uint8,
                           device=dev, generator=gen)
    k1 = check_k1(dev, frames, (resize_bilinear, resize_bilinear_plain,
                                resize_weights))
    k2 = check_k2(dev, frames, (crop_and_resize, crop_and_resize_plain),
                  norm)
    from tpudet3d_torch.detect import generate_anchors
    anchors = torch.from_numpy(generate_anchors()).to(dev)
    k3 = check_k3(dev, (decode_detections, decode_detections_plain),
                  anchors)
    del frames

    # 3. the serving path at full width
    engine = build_engine(det_conf=0.0, device=dev)
    frames_np = np.random.RandomState(1).randint(0, 256, (16, *FRAME)) \
        .astype(np.uint8)
    wrappers = (resize_bilinear, crop_and_resize, decode_detections)
    launches = main_path(engine, wrappers, frames_np)
    e1, e2, e3 = path_intermediates(
        engine, frames_np, (resize_bilinear_plain, crop_and_resize_plain,
                            decode_detections_plain, crop_and_resize), norm)

    # 4. serving times
    times = serving_times(engine, dev, iters)
    print(f'serving on {gpu}: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in times.items() if not k.endswith('spread')))

    kernels = []
    for (name, src, replaces, m, err), n in zip((
            ('K1 preprocess_resize', 'tpudet3d_torch/kernels/csrc/resize.cu',
             'tpudet3d/ops/image.py:19', k1, max(k1['err'], e1)),
            ('K2 crop_resize_normalize', 'tpudet3d_torch/kernels/csrc/crop.cu',
             'tpudet3d/ops/image.py:86', k2, max(k2['err'], e2)),
            ('K3 decode_nms', 'tpudet3d_torch/kernels/csrc/decode_nms.cu',
             'tpudet3d/detect/nms.py:86', k3, max(k3['err'], e3))),
            launches):
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': n, 'max_abs_err': err,
            'ms': m['ms'], 'plain_ms': m['plain_ms'],
            'bound_ms': m['bound'][0], 'bound_by': m['bound'][1],
            'library_ms': m['library_ms']})
    for k in kernels:
        lib = ('none' if k['library_ms'] is None
               else f"{k['library_ms']:.4f} ms")
        print(f"{k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {lib}, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), {k['launches']} launches on the main "
              f'path, max |kernel - plain| {k["max_abs_err"]:.3g}')
    print(gpu)
    print(json.dumps({'kernels': kernels}))
    if out_path:
        with open(out_path, 'w') as f:
            json.dump({'gpu': gpu, 'build_s': build_s, 'kernels': kernels,
                       'serving': times, 'torch': torch.__version__,
                       'cuda': torch.version.cuda}, f, indent=1)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
