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
  and counts convolutions its own way.
"""

import bisect
import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ['trace', 'flops_of', 'annotate', 'span_times', 'TRACE_FILE',
           'SPAN_PREFIX']

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
