"""K6 (the int8 conv's input quantization) on one NVIDIA GPU, over every
int8 conv of a MNv3 and an el0 ``infer_batch(16)`` call of 720p frames.

    python tpudet3d_torch/tools/k6_bench.py [--trees DIR ...] [--out FILE]

Builds the default engine (MNv2-SSD-300 + MNv3-large-21k) and the el0
engine of ``chip_smoke.py`` phase 7 (the seeded snapshots of
``cases.write_snapshots``), calibrates each with ``calibrate_engine`` on
16 frames and records every int8 conv of one eager
``_pipeline_batch(16)`` call on the uploaded frames, the path that
``infer_batch`` graphs (``cases.recording_int8_convs``).  Checks K6
against its plain version bit for bit on each, then times it on the
device (``torch.profiler``) and back to back (CUDA events), summed over
the call and split into the stems (k×k), the unpadded 1×1 convs (C = Kp)
and the padded ones (C < Kp), each with its bytes (every input read
once, every output written once) and byte bound at 3.35 TB/s; each
launch's own device time; the
largest 1×1 launch alone warm and with a cold L2 (launches cycling over
copies of its input that exceed the 50 MB L2 three times); and the launch
floor, the device time of an add on one float.  A tree whose
``ops/quant.py`` has ``quantize_plan`` also reports each conv's route.
With ``--trees``, each DIR's own ``tpudet3d_torch``, its kernels built
from its own sources, is timed in a process of its own, in the order
given (``--trees parent . . parent`` compares two checkouts in turns);
every process makes the same inputs and weights from the same seeds.
Prints a JSON line per run with the card's name and power limit and the
K6 source's ``ptxas`` report.  ``--unchecked`` times trees whose K6 is
not meant to be right and only records their error.  Needs CUDA.
"""

import os
import sys
import tempfile

import numpy as np
import torch

if not __package__:     # run as a script: the package is two levels up
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from tpudet3d_torch.tools.cases import (  # noqa: E402
    EL0_CONFIG, FRAME, HBM_BYTES_PER_S, cycle_ms, recording_int8_convs,
    write_snapshots)
from tpudet3d_torch.tools.k1_bench import (bench_main,  # noqa: E402
                                           device_ms, gpu_line,
                                           launch_floor_ms, use_tree)

L2_BYTES = 50e6


def group_of(x, rows, layer):
    """``stems``, ``unpadded`` or ``padded``: the part of the call a conv
    belongs to."""
    if tuple(layer.kernel_size) != (1, 1):
        return 'stems'
    return 'unpadded' if x.shape[1] == rows.shape[1] else 'padded'


def kernel_us(fn, calls=20):
    """Device µs of each kernel that ``fn`` launches, in launch order, the
    mean over ``calls`` calls (``torch.profiler``; None if it records no
    device activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not us or len(us) % calls:
        return None
    per = len(us) // calls
    return [sum(us[i::per]) / calls for i in range(per)]


def conv_times(qops, calls, checked):
    """K6 over the recorded ``calls`` of one serving call: its largest
    |kernel - plain| in int8 steps, the routes, and the times of the
    whole call, of each group and of the largest 1×1 launch."""
    from tpudet3d_torch.ops.image import _sm_count
    groups, err, routes = {'stems': [], 'unpadded': [], 'padded': []}, 0, {}
    plan = getattr(qops, 'quantize_plan', None)
    for x, layer, s_x in calls:
        args = (x, s_x, layer.kernel_size, layer.stride, layer.padding)
        rows = qops.quantize_input(*args)
        e = int((rows.int() - qops.quantize_input_plain(*args).int())
                .abs().max())
        if checked and e:
            raise RuntimeError(f'k6_bench: K6 disagrees on {tuple(x.shape)} '
                               f'kernel {layer.kernel_size}: {e}')
        err = max(err, e)
        if plan is not None:
            route = plan(tuple(x.shape), x.stride(), x.dtype, *args[2:],
                         x.data_ptr(), _sm_count(x.device)).route
            routes[route] = routes.get(route, 0) + 1
        groups[group_of(x, rows, layer)].append(
            (args, x.numel() * x.element_size() + rows.numel()))
    groups['all'] = [a for g in list(groups.values()) for a in g]
    out = dict(max_abs_err=err, routes=routes or None)
    for name, items in groups.items():
        args = [a for a, _ in items]
        n_bytes = sum(b for _, b in items)

        def call(args=args):
            return [qops.quantize_input(*a) for a in args]
        out[name] = dict(launches=len(args), bytes=n_bytes,
                         bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                         device_ms=device_ms(call, 20) if args else None,
                         ms=cycle_ms([call], 20) if args else None)
    us = kernel_us(lambda: [qops.quantize_input(*a) for a, _ in
                            groups['all']])
    out['per_launch'] = None if us is None else [
        dict(shape=list(a[0].shape), kernel=list(a[2]), bytes=b, us=t)
        for (a, b), t in zip(groups['all'], us)]
    args, n_bytes = max(groups['unpadded'] + groups['padded'],
                        key=lambda item: item[1])
    x = args[0]
    copies = [x] + [torch.empty_like(x).copy_(x) for _ in range(
        int(3 * L2_BYTES // n_bytes) + 1)]
    warm = device_ms(lambda: qops.quantize_input(*args), 50)
    out['largest_1x1'] = dict(
        shape=list(x.shape), dtype=str(x.dtype), bytes=n_bytes,
        bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, device_ms=warm,
        tb_per_s=n_bytes / warm / 1e9 if warm else None,
        ms=cycle_ms([lambda: qops.quantize_input(*args)], 50),
        ms_cold=cycle_ms([lambda c=c: qops.quantize_input(c, *args[1:])
                          for c in copies], 10 * len(copies)),
        cold_copies=len(copies))
    return out


def run_tree(tree, checked=True):
    """Times the K6 of the ``tpudet3d_torch`` found in ``tree``."""
    use_tree(tree)
    from tpudet3d_torch.infer import build_engine, quant
    from tpudet3d_torch.kernels.build import build
    from tpudet3d_torch.ops import quant as qops
    _, build_s, log = build()
    ptxas = next((part for part in log.split('== ')
                  if part.startswith('quant.cu')), '')
    dev = torch.device('cuda')
    frames = np.random.RandomState(1).randint(0, 256, (16, *FRAME)) \
        .astype(np.uint8)
    res = dict(tree=tree, gpu=gpu_line(), build_s=build_s)
    with tempfile.TemporaryDirectory() as root:
        paths = write_snapshots(root)[0]
        for name in ('mnv3', 'el0'):
            engine = build_engine(det_conf=0.0, device=dev) \
                if name == 'mnv3' else build_engine(
                    EL0_CONFIG, det_checkpoint=paths['detector'],
                    reg_checkpoint=paths['regressor'], det_conf=0.0,
                    device=dev)
            quant.serve_int8(engine, list(frames))
            # eagerly: a replayed CUDA graph calls no int8 conv from Python
            up = engine._upload(frames)
            with recording_int8_convs(quant) as calls:
                engine._pipeline_batch(up, *FRAME[:2])
            res[name] = conv_times(qops, calls, checked)
            del engine, calls
            torch.cuda.empty_cache()
    res.update(floor_ms=launch_floor_ms(dev), ptxas=ptxas.strip())
    return res


def main():
    return bench_main(__file__, __doc__, run_tree)


if __name__ == '__main__':
    sys.exit(main())
