"""Where the serving path's device time goes, on one NVIDIA GPU.

    python -m tpudet3d_torch.tools.profile_serving [--reg_config CONFIG]
        [--out FILE]

Builds the default engine (MNv2-SSD-300 w1.0 + MNv3-large-21k, bf16, 224²
crops, max_detections 8, random weights from seed 0; ``--reg_config``
names another regressor config, e.g.
``configs/scene_regressor_el0_hpo.py``), runs 5 calls of
``_pipeline_batch`` at batches 1, 16 and 32 after three warm-up calls,
first timed alone and then under ``torch.profiler``, and prints for each
batch: wall time per call (unprofiled), device busy time per call (the sum
of kernel times; one stream, so kernels do not overlap), the device's idle
share (1 - busy / unprofiled wall), kernel launches per call, peak device
memory, device time by kernel group and by kernel, and the host and device
ms a call of each ``tpudet3d_torch.serve.*`` span (``utils/profiling.py``
``span_times``: ``_pipeline_batch`` runs ``serve.detect`` and
``serve.regress``); ``--out`` also gets the launches per call of every
kernel by name.  Then the same frames from the host through
``infer_batch``, which replays the engine's CUDA graph of that path: its
wall and device busy time a call, its spans (``serve.upload``,
``serve.replay``, ``serve.readback``) and the engine's ``graph_stats``
(captures, replays, eager calls).  Needs CUDA.
"""

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from tpudet3d_torch.utils.profiling import SPAN_PREFIX, span_times

FRAME = (720, 1280, 3)
BATCHES = (1, 16, 32)
STEPS = 5

# kernel-name fragments → group, first match wins
GROUPS = (
    ('K1 resize', ('resize_tiled_u8_kernel',)),
    ('K2 crop', ('crop_band_kernel',)),
    ('K3 decode_nms', ('decode_nms_kernel',)),
    ('K4 head_epilogue', ('head_epilogue_kernel',)),
    ('convolution', ('conv', 'xmma', 'cudnn', 'implicit', 'depthwise',
                     'winograd', 'fprop', 'sm90', 'nhwc')),
    ('matmul', ('gemm', 'cutlass', 'cublas')),
    ('batch norm', ('batch_norm', 'bn_fw', 'batchnorm')),
    ('reduction', ('reduce',)),
    ('sort / index', ('sort', 'radix', 'gather', 'scatter', 'index',
                      'arange')),
    ('optimizer', ('multi_tensor_apply',)),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')),
    ('copy / fill', ('copy', 'memcpy', 'memset', 'fill')),
)


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def _kernels(prof):
    """``{name: (device ms, launches)}`` of a finished profile; device-side
    annotation ranges span other events and are left out."""
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            t, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return kernels


def profile_graphed(engine, frames, steps):
    """``infer_batch`` on host ``frames`` after three warm-up calls (the
    first captures the graph): wall and busy ms a call, device events a
    call, the serving spans' ms a call and ``graph_stats``."""
    for _ in range(3):
        engine.infer_batch(frames)
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.infer_batch(frames)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.infer_batch(frames)
    kernels = _kernels(prof)
    return {
        'wall_ms_per_call': wall_ms,
        'device_busy_ms_per_call': sum(t for t, _ in kernels.values())
        / steps,
        'events_per_call': sum(n for _, n in kernels.values()) / steps,
        'spans_ms_per_call': {
            name: {'host': t['host_ms'] / steps,
                   'device': t['device_ms'] / steps}
            for name, t in span_times(prof, SPAN_PREFIX + 'serve.').items()},
        'graph_stats': dict(engine.graph_stats),
    }


def profile_batch(engine, batch, steps):
    h, w = FRAME[:2]
    gen = torch.Generator(device='cuda').manual_seed(batch)
    frames = torch.randint(0, 256, (batch, *FRAME), dtype=torch.uint8,
                           device='cuda', generator=gen)
    for _ in range(3):
        engine._pipeline_batch(frames, h, w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine._pipeline_batch(frames, h, w)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._pipeline_batch(frames, h, w)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _kernels(prof)
    busy_ms = sum(t for t, _ in kernels.values()) / steps
    groups = {}
    for name, (t, n) in kernels.items():
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += t / steps
        g[1] += n / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    graphed = profile_graphed(engine, frames.cpu().numpy(), steps)
    return {
        'batch': batch, 'wall_ms_per_call': wall_ms,
        'profiled_wall_ms_per_call': profiled_ms,
        'device_busy_ms_per_call': busy_ms,
        'device_idle_share': max(0.0, 1.0 - busy_ms / wall_ms),
        'kernel_launches_per_call': sum(n for _, n in kernels.values())
        / steps,
        'peak_memory_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
        'groups_ms_per_call': {k: v[0] for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1][0])},
        'group_launches_per_call': {k: v[1] for k, v in groups.items()},
        'top_kernels_ms_per_call': [(name[:120], t / steps, n / steps)
                                    for name, (t, n) in top],
        'launches_by_kernel_per_call': {
            name: n / steps for name, (_, n) in sorted(kernels.items())},
        'spans_ms_per_call': {
            name: {'host': t['host_ms'] / steps,
                   'device': t['device_ms'] / steps}
            for name, t in span_times(prof, SPAN_PREFIX + 'serve.').items()},
        'infer_batch_graphed': graphed,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reg_config', default='',
                    help='regressor config (default: MNv3-large-21k)')
    ap.add_argument('--out', default='')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_serving: CUDA is not available', file=sys.stderr)
        return 1
    from tpudet3d_torch.infer import build_engine
    engine = build_engine(args.reg_config, det_conf=0.0)
    report = {'gpu': torch.cuda.get_device_name(0),
              'reg_config': args.reg_config,
              'torch': torch.__version__, 'runs': []}
    for b in BATCHES:
        r = profile_batch(engine, b, STEPS)
        report['runs'].append(r)
        print(f"batch {b}: wall {r['wall_ms_per_call']:.3f} ms, device busy "
              f"{r['device_busy_ms_per_call']:.3f} ms, idle share "
              f"{r['device_idle_share']:.3f}, "
              f"{r['kernel_launches_per_call']:.0f} launches, peak "
              f"{r['peak_memory_gib']:.2f} GiB")
        for g, t in r['groups_ms_per_call'].items():
            print(f'  {g:16s} {t:8.3f} ms  '
                  f"{r['group_launches_per_call'][g]:6.0f} launches")
        print(f"  {'span':31s} {'host ms':>8s} {'device ms':>10s}")
        for name, t in r['spans_ms_per_call'].items():
            print(f"  {name:31s} {t['host']:8.3f} {t['device']:10.3f}")
        g = r['infer_batch_graphed']
        print(f"  infer_batch from the host, graphed: wall "
              f"{g['wall_ms_per_call']:.3f} ms, device busy "
              f"{g['device_busy_ms_per_call']:.3f} ms, "
              f"{g['events_per_call']:.0f} device events; graph_stats "
              f"{g['graph_stats']}")
        for name, t in g['spans_ms_per_call'].items():
            print(f"  {name:31s} {t['host']:8.3f} {t['device']:10.3f}")
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
