"""Tracing and profiling hooks (counterpart of
``tpudet3d/utils/profiling.py``), on ``torch.profiler``:

* ``trace`` — a context manager recording host and card activity, written
  as a Chrome trace (``chrome://tracing``, Perfetto);
* ``annotate`` — a named range in that trace, recorded only while a
  profiler runs; otherwise one shared no-op context, for the cost of a
  flag read.  Ranges nest in the caller's own ranges on the calling
  thread.  The port's layer boundaries are such ranges, its spans
  (``tpudet3d_torch.serve.*`` in ``infer/engine.py``,
  ``tpudet3d_torch.train.*`` in ``train/steps.py``), and ``trace`` writes
  them into its Chrome trace beside the kernels;
* ``span_times`` — each span's host and device time in a finished
  profile;
* ``flops_of`` — the floating-point operations of a call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (the complexity CLI's
  backend).  That counter counts convolutions and matrix products only;
  XLA's ``cost_analysis`` in the JAX package also counts elementwise work
  and counts convolutions its own way;
* ``drive``, ``traced_launches`` and ``drive_replay`` — the launches of
  each CUDA kernel of the port (K1–K8) in a call: counted by its Python
  wrapper, or by kernel name (``KERNEL_NAMES``) from a trace of the
  card's activity (``device_events``), which also sees a CUDA graph's
  replay.  The card smoke (``chip_smoke.py``) and the golden record's
  drivers (``utils/golden.py``) hold each path's count to its own.
"""

import bisect
import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ['trace', 'flops_of', 'annotate', 'span_times', 'TRACE_FILE',
           'SPAN_PREFIX', 'KERNEL_NAMES', 'REPLAYS_TRACED', 'device_events',
           'drive', 'traced_launches', 'drive_replay']

TRACE_FILE = 'trace.json'
SPAN_PREFIX = 'tpudet3d_torch.'

_NO_RANGE = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir='./profile_trace'):
    """Record the enclosed block (CPU, and CUDA when there is a card);
    yields the ``torch.profiler.profile`` object and writes
    ``{logdir}/trace.json`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name):
    """A named range that shows in the trace, while a profiler runs (the
    flag ``torch.profiler.profile`` sets); a shared no-op context
    otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


def span_times(prof, prefix=SPAN_PREFIX):
    """``{name: {'calls', 'host_ms', 'device_ms'}}`` of the spans named
    ``prefix...`` in the finished profile ``prof`` (CPU activity, and CUDA
    for device time), totals over the profile.

    ``host_ms`` is the spans' wall time on the host.  ``device_ms`` is the
    device time of the kernels, copies and fills launched while a span was
    open, on whichever thread launched them (autograd runs the backward on
    a thread of its own): the profiler links each device event to the host
    range that launched it by their correlation, and the event counts for
    the innermost span open when that range started.  Device-side
    annotation ranges are left out: they span other events and would
    count their time again."""
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name.startswith(prefix))
    out = {}
    for start, end, name in spans:
        s = out.setdefault(name, {'calls': 0, 'host_ms': 0.0,
                                  'device_ms': 0.0})
        s['calls'] += 1
        s['host_ms'] += (end - start) / 1e3
    starts = [s[0] for s in spans]
    for e in events:
        if e.is_async:
            continue
        us = sum(k.duration for k in e.kernels
                 if not (e.is_user_annotation and k.name == e.name))
        if not us:
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][1] < t:
            i -= 1
        if i >= 0:
            out[spans[i][2]]['device_ms'] += us / 1e3
    return out


def flops_of(fn, *example_args, **kwargs):
    """Floating-point operations of ``fn(*example_args, **kwargs)``
    (convolutions and matrix products; a multiply-add counts 2)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*example_args, **kwargs)
    return counter.get_total_flops()


def device_events(prof):
    """The profile's kernels, copies and fills on the card: not the
    device-side ranges of ``record_function`` annotations (the optimizer's
    ``step`` and ``zero_grad``), which span other events and would count
    their time again."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]


def drive(wrappers, fn):
    """``fn()`` with the launch counts set to 0 just before it; returns its
    result and the counts read just after it (on the CPU the wrappers
    count nothing)."""
    for f in wrappers:
        f.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, [f.launches for f in wrappers]


# the kernels each wrapper of K1-K8 launches, as a device trace names them
KERNEL_NAMES = (('resize_tiled_u8_kernel',), ('crop_band_kernel',),
                ('decode_nms_kernel',), ('head_epilogue_kernel',),
                ('box3d_iou_kernel',),
                ('quantize_rows_kernel', 'quantize_staged_kernel',
                 'quantize_input_kernel'), ('int8_rescale_kernel',),
                ('window_attn_kernel',))
REPLAYS_TRACED = 3           # the replays a drive_replay counts over


def traced_launches(wrappers, fn, calls=1, warm=None):
    """``fn()`` ``calls`` times under a profile of the card's activity
    alone: the last call's result and the launches a call of each
    wrapper's kernels (:data:`KERNEL_NAMES`), counted by name from the
    trace, eager and replayed alike.  The tracer loses the first events
    of a session while it starts, so a warm-up step (``warm()``, by
    default ``fn()``) is traced and thrown away first (the profiler's
    schedule).  A session that records no device activity is repeated,
    up to three times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            (warm or fn)()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                out = fn()
            torch.cuda.synchronize()
            prof.step()
        events = device_events(prof)
        if events:
            break
    return out, [sum(any(n in e.name for n in names) for e in events)
                 // calls for names, _ in zip(KERNEL_NAMES, wrappers)]


def drive_replay(wrappers, fn):
    """``fn()``, a call of a card engine's ``infer_batch``, once (the
    capture of its graph, if its key is new) and then
    :data:`REPLAYS_TRACED` times under :func:`traced_launches`: returns
    the last call's result and the launches a call.  A replay calls no
    kernel wrapper, so the wrappers' own counts must stay 0 over it.
    Without a card the call is eager and :func:`drive` counts it."""
    if not torch.cuda.is_available():
        return drive(wrappers, fn)
    fn()
    torch.cuda.synchronize()
    for f in wrappers:
        f.launches = 0
    out, n = traced_launches(wrappers, fn, REPLAYS_TRACED)
    if not all(f.launches == 0 for f in wrappers):
        raise RuntimeError(f'a replay called the kernel wrappers: '
                           f'{[f.launches for f in wrappers]}')
    return out, n
