"""What every cell shares: the profiler's reading of a traced window, the
per-layer metric readers found by name, the grouping of kernels and the
result line.

A traced window runs a few calls or steps under ``torch.profiler``; its
device events are the kernels, copies and fills on the card, without the
device-side ranges of ``record_function`` annotations (the optimizer's
``step`` and ``zero_grad``), which span other events and would count their
time again.
"""

import bisect
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent      # perfbench/
SPAN = 'perfbench.'                                # the harness's own spans

# kernel-name fragments → group, first match wins (the grouping of the
# port's profiling tool when the benchmark was written, frozen here)
GROUPS = (
    ('K1 resize', ('resize_tiled_u8_kernel',)),
    ('K2 crop', ('crop_band_kernel',)),
    ('K3 decode_nms', ('decode_nms_kernel',)),
    ('K4 head_epilogue', ('head_epilogue_kernel',)),
    ('collective', ('nccl',)),
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

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'tpudet3d')


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``tpudet3d_torch`` is the port)."""
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_trace(prof):
    """``(device, host)`` of a finished profile: the device events as
    ``(name, start_us, end_us)`` sorted by start, and the host's outermost
    operations (the harness's spans left out) as ``(start_us, end_us,
    name)`` sorted by start."""
    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, 'is_user_annotation', False):
                device.append((e.name, tr.start, tr.end))
        elif not e.name.startswith(SPAN):
            host.append((tr.start, tr.end, e.name))
    device.sort(key=lambda d: d[1])
    host.sort()
    outer, end = [], float('-inf')
    for start, stop, name in host:
        if start >= end:
            outer.append((start, stop, name))
            end = stop
    return device, outer


def busy_intervals(device):
    """The union of the device events' intervals, in order."""
    out = []
    for _, s, e in device:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_ops(device):
    """The ten groups of device operations that took most time, seconds."""
    groups = {}
    for name, s, e in device:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + (e - s) / 1e6
    return [list(kv) for kv in sorted(groups.items(), key=lambda kv: -kv[1])
            [:10]]


def idle_gaps(device, host):
    """The card's idle time between the first and the last host operation
    of a trace, summed by what the host was doing (its outermost operation
    at the middle of each gap), ten largest; seconds."""
    if not host:
        return []
    busy = busy_intervals(device)
    window = (host[0][0], max(h[1] for h in host))
    edges = [window[0]] + [v for b in busy for v in b] + [window[1]]
    starts = [h[0] for h in host]
    idle = {}
    for i in range(0, len(edges), 2):
        lo, hi = edges[i], edges[i + 1]
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        j = bisect.bisect_right(starts, mid) - 1
        label = (host[j][2] if j >= 0 and host[j][1] >= mid
                 else 'host: no operation')
        idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e6
    return [list(kv) for kv in sorted(idle.items(), key=lambda kv: -kv[1])
            [:10]]


def traced(call, n, n_host, dev, span):
    """Trace ``call(i)`` for ``n`` calls with the device's activity alone
    (the profiler then adds little to the host's time), then ``n_host``
    more with the host's operations too, for what the host was doing while
    the card idled.  Returns ``(device_events, window_s, breakdown)``;
    ``window_s`` is the first trace's wall time, from a synchronise before
    its first call to one after its last."""
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = torch.device(dev).type == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda *a: None)
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        sync(dev)
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        sync(dev)
        window_s = time.perf_counter() - t0
    device, _ = read_trace(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_host):
            with record_function(SPAN + span):
                call(n + i)
        sync(dev)
    device2, host = read_trace(prof)
    return device, window_s, {'device_ops': device_ops(device or device2),
                              'idle_gaps': idle_gaps(device2, host)}


def cuda(dev, fn, *args):
    """``fn(*args)`` where ``dev`` is a card; None elsewhere (the tests'
    CPU runs)."""
    if torch.device(dev).type == 'cuda':
        return fn(*args)
    return None


def split(t0, marks):
    """Seconds of each phase of set-up: process start to the harness,
    then each mark from the one before."""
    out, last = {'start': marks[0][1] - t0}, marks[0][1]
    for name, t in marks[1:]:
        out[name] = t - last
        last = t
    return out


def load_metric(name):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(trace)``, which returns the value or None."""
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'perfbench_metric_{name}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench, cell, trace):
    """The per-layer metrics of ``cell`` that find something to read in
    ``trace``, as ``{name: {'value', 'unit'}}``."""
    reported = {m['name'] for m in bench['end_to_end']
                if 'workloads' not in m or cell['name'] in m['workloads']}
    out = {}
    for m in bench['per_layer']:
        if 'workloads' in m:
            if cell['name'] not in m['workloads']:
                continue
        elif m['moves'] not in reported:
            continue
        value = load_metric(m['name'])(trace)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def card_line():
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    None where it does not run."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def emit(result, checks):
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line of standard output,
    the checks under their own key, last."""
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line['checks'] = checks
    print(json.dumps(line))
    sys.stdout.flush()
