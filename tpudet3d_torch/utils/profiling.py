"""Tracing and profiling hooks (counterpart of
``tpudet3d/utils/profiling.py``), on ``torch.profiler``:

* ``trace`` — a context manager recording host and card activity, written
  as a Chrome trace (``chrome://tracing``, Perfetto);
* ``annotate`` — a named range in that trace;
* ``StepTimer`` — wall-clock step timing that waits for the card's work on
  the tensors it is given before it reads the clock;
* ``flops_of`` — the floating-point operations of a call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (the complexity CLI's
  backend).  That counter counts convolutions and matrix products only;
  XLA's ``cost_analysis`` in the JAX package also counts elementwise work
  and counts convolutions its own way.
"""

import contextlib
import os
import time

import torch

__all__ = ['trace', 'StepTimer', 'flops_of', 'annotate', 'TRACE_FILE']

TRACE_FILE = 'trace.json'


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
    """A named range that shows in the trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timer with an exponential average; ``stop`` waits
    for the work queued on the current stream of each given tensor's card
    (an event recorded there and waited on) before reading the clock."""

    def __init__(self, ema=0.9):
        self.ema = ema
        self.avg = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *tensors):
        for dev in {t.device for t in tensors if t.device.type == 'cuda'}:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            event.synchronize()
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else \
            self.ema * self.avg + (1 - self.ema) * dt
        return dt

    @property
    def steps_per_sec(self):
        return 1.0 / self.avg if self.avg else 0.0


def flops_of(fn, *example_args, **kwargs):
    """Floating-point operations of ``fn(*example_args, **kwargs)``
    (convolutions and matrix products; a multiply-add counts 2)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*example_args, **kwargs)
    return counter.get_total_flops()
