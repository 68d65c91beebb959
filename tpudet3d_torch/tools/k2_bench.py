"""K2 (crop, resize and normalise the detector's boxes) on one NVIDIA GPU,
at the serving path's shapes: 128 crops (16 frames of 720p × 8 boxes) to
224² bf16 with the channel reversal and the regressor's normalisation.

    python tpudet3d_torch/tools/k2_bench.py [--trees DIR ...] [--out FILE]
    python tpudet3d_torch/tools/k2_bench.py --phase-copies DEST [--trees DIR]

Times the kernel warm (back-to-back launches on one 44 MB batch of frames),
cold (launches cycling over 3 batches, 133 MB, so that each finds its
frames evicted from the 50 MB L2), with the TTA mirror, and at N=1 (8
crops) back to back and on the device (``torch.profiler``), and
``F.grid_sample`` (border padding, float32 NCHW frames) warm and cold as
the library's yardstick.  Where the tree's K2 has a band plan, it also
times each band height.  Checks the kernel against its plain version
first.  With ``--trees``, each DIR's own ``tpudet3d_torch``, its kernels
built from its own sources, is timed in a process of its own, in the order
given (``--trees parent . . parent`` compares two checkouts in turns);
every process makes the same inputs from the same seeds.  Prints a JSON
line per run with the card's name and power limit and the crop source's
``ptxas`` report.  ``--unchecked`` times trees whose K2 is not meant to be
right, such as copies of the kernel that return after a phase, and only
records their error.  ``--phase-copies DEST`` writes such copies of DIR's
(or this checkout's) ``tpudet3d_torch`` to DEST/p1_stage (the first
pass's staging and tap tables only), DEST/p2_nostore (no stores) and
DEST/p3_storeonly (stores of made-up values only), and needs no CUDA.
Otherwise it needs CUDA.
"""

import os
import sys

import numpy as np
import torch

if not __package__:     # run as a script: the package is two levels up
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from tpudet3d_torch.tools.k1_bench import (bench_main,  # noqa: E402
                                           cycle_ms, device_ms, gpu_line,
                                           use_tree, write_copies)

FRAME = (720, 1280, 3)
N, K = 16, 8
OUT_HW = (224, 224)
BANDS = (1, 2, 4, 8, 16)


def engine_like_boxes(n, k, h, w, seed):
    """Boxes as the serving path makes them: inside the frame, some on its
    edges, some thinner than a pixel."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-40, w, (n, k))
    y0 = rng.uniform(-40, h, (n, k))
    b = np.stack([x0, y0, x0 + rng.uniform(0.2, w / 2, (n, k)),
                  y0 + rng.uniform(0.2, h / 2, (n, k))], -1)
    return np.clip(b, 0, [w, h, w, h]).astype(np.float32)


def serving_inputs(dev):
    """Three batches of 16 uint8 720p frames (seeded on the card) and the
    serving path's boxes [16,8,4]."""
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [torch.randint(0, 256, (N, *FRAME), dtype=torch.uint8,
                             device=dev, generator=gen) for _ in range(3)]
    boxes = torch.from_numpy(engine_like_boxes(N, K, *FRAME[:2], 1)).to(dev)
    return batches, boxes


def k2_times(crop, batches, boxes, norm):
    """``crop`` (a K2 wrapper) on ``batches`` of frames with ``boxes``,
    bf16: warm ms on the first batch, cold ms cycling over all, warm ms
    with the mirror, ms at N=1 back to back (the host's dispatch may set
    it) and the device time at N=16 and N=1."""
    def call(f, b, mirror=False):
        return lambda: crop(f, b, OUT_HW, True, norm[0], norm[1], mirror,
                            torch.bfloat16)
    first, one = batches[0], batches[0][:1]
    return dict(ms=cycle_ms([call(first, boxes)], 100),
                ms_cold=cycle_ms([call(b, boxes) for b in batches], 120),
                ms_mirror=cycle_ms([call(first, boxes, True)], 100),
                ms_n1=cycle_ms([call(one, boxes[:1])], 200),
                device_ms=device_ms(call(first, boxes)),
                device_ms_n1=device_ms(call(one, boxes[:1])))


def library_times(batches, boxes):
    """``F.grid_sample`` (bilinear, border padding) of float32 NCHW copies
    of ``batches`` at the crops' sample positions, warm and cycling."""
    import torch.nn.functional as F
    xs = [b.permute(0, 3, 1, 2).float().contiguous() for b in batches]
    h, w = FRAME[:2]
    side = (boxes[..., 2:] - boxes[..., :2]).clamp(min=1.0)       # [N,K,2]
    t = torch.arange(OUT_HW[0], device=boxes.device,
                     dtype=torch.float32) + 0.5
    sx = t * side[..., 0:1] / OUT_HW[1] - 0.5 + boxes[..., 0:1]
    sy = t * side[..., 1:2] / OUT_HW[0] - 0.5 + boxes[..., 1:2]
    gx, gy = (2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1
    grid = torch.stack([gx[..., None, :].expand(-1, -1, OUT_HW[0], -1),
                        gy[..., :, None].expand(-1, -1, -1, OUT_HW[1])], -1)
    grid = grid.reshape(N, K * OUT_HW[0], OUT_HW[1], 2)

    def call(x):
        return lambda: F.grid_sample(x, grid, mode='bilinear',
                                     padding_mode='border',
                                     align_corners=False)
    return dict(library_ms=cycle_ms([call(xs[0])], 20),
                library_ms_cold=cycle_ms([call(x) for x in xs], 30))


def band_sweep(image, crop, batches, boxes, norm):
    """Warm and cold ms at each band height in BANDS (the plan forced to
    it), where the tree's K2 has a band plan."""
    if not hasattr(image, 'crop_plan'):
        return None
    saved, out = image.K2_BANDS, {}
    try:
        for band in BANDS:
            image.K2_BANDS = (band,)
            image.crop_plan.cache_clear()
            try:
                t = k2_times(crop, batches, boxes, norm)
            except ValueError:          # the band does not fit
                out[band] = None
                continue
            out[band] = dict(ms=t['ms'], ms_cold=t['ms_cold'],
                             device_ms=t['device_ms'])
    finally:
        image.K2_BANDS = saved
        image.crop_plan.cache_clear()
    return out


def run_tree(tree, checked=True):
    """Times the K2 of the ``tpudet3d_torch`` found in ``tree``."""
    use_tree(tree)
    from tpudet3d_torch.infer.engine import REG_OFFSET, REG_SCALE
    from tpudet3d_torch.kernels.build import build
    from tpudet3d_torch.ops import image
    _, build_s, log = build()
    ptxas = next((part for part in log.split('== ')
                  if part.startswith('crop.cu')), '')
    dev = torch.device('cuda')
    norm = (REG_SCALE, REG_OFFSET)
    batches, boxes = serving_inputs(dev)
    err = 0.0
    for mirror in (False, True):
        args = (batches[0], boxes, OUT_HW, True, *norm, mirror)
        err = max(err, (image.crop_and_resize(*args, torch.bfloat16).float()
                        - image.crop_and_resize_plain(*args)).abs().max()
                  .item())
    if checked and not err <= 2 ** -7 + 1e-4:
        raise RuntimeError(f'k2_bench: K2 of {tree} disagrees: {err}')
    return dict(tree=tree, gpu=gpu_line(), build_s=build_s,
                max_abs_err=err,
                **k2_times(image.crop_and_resize, batches, boxes, norm),
                **library_times(batches, boxes),
                bands=band_sweep(image, image.crop_and_resize, batches,
                                 boxes, norm),
                ptxas=ptxas.strip())


def phase_copies(tree, dest):
    """Writes the copies of ``tree``'s ``tpudet3d_torch`` whose K2 returns
    after a phase (see the module's note) to ``dest``; returns their
    directories.  Each keeps a value of the phases it runs alive."""
    base = os.path.join(tree, 'tpudet3d_torch')
    with open(os.path.join(base, 'kernels/csrc/crop.cu')) as f:
        src = f.read()
    sync = '    cp_async_wait_all();\n    __syncthreads();\n'
    store = '      const int oy = oy0 + r0 + r, ox = g * kRun;'
    stage = '    // 1. stage: a warp per staged row'
    compute = '      const float4 ye = ytab[r];'
    end = '    r0 += m;'
    for mark in (sync, store, stage, compute, end):
        if src.count(mark) != 1:
            raise ValueError(f'crop.cu of {tree} lacks {mark.strip()!r}')
    copies = {'p1_stage': src.replace(sync, sync + (
        '    if (threadIdx.x == 0)\n'
        '      out[b] = tpd::from_float<T>(__uint_as_float(stage[0] | '
        'stage[stride]) +\n'
        '                                  xtab[0].x + ytab[0].x);\n'
        '    return;\n'))}
    copies['p2_nostore'] = src[:src.index(store)] + (
        '      if (v[0] == 12345.f && v[23] == 0.5f) out[b] = '
        'tpd::from_float<T>(v[1]);\n    }\n') + src[src.index(end):]
    body = src[:src.index(stage)] + src[src.index(sync):]
    copies['p3_storeonly'] = body[:body.index(compute)] + (
        '      float v[3 * kRun];\n#pragma unroll\n'
        '      for (int q = 0; q < 3 * kRun; ++q) v[q] = (float)(r + g + q);\n'
        ) + body[body.index(store):]
    return write_copies(tree, dest, 'crop.cu', copies)


def main():
    return bench_main(__file__, __doc__, run_tree, phase_copies)


if __name__ == '__main__':
    sys.exit(main())
