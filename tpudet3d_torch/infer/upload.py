"""The staged upload of host frames to a device: the span
``tpudet3d_torch.serve.upload``.

A card reads host memory at full rate only from pinned pages, so frames
in the caller's pageable memory are first copied on the host.  Each
device keeps one :class:`Stager` in the process, whichever engine or
wrapper uploads to it (pinned memory is the host's, so one buffer a card,
not one an engine or a graph): one persistent staging buffer (pinned
for a card), sized to the largest upload seen and grown on demand, into
which a one-thread C++ routine with non-temporal stores
(``kernels/csrc/host_stage.cpp``) copies the frames a chunk of whole
frames at a time (:func:`chunk_plan`: about :data:`CHUNK_BYTES` a chunk,
one chunk for an upload no larger).  As soon as a chunk is staged its copy
to the destination is enqueued on the current stream, so the card copies
chunk k while the host stages chunk k+1.  An event recorded after the last
chunk's copy is waited on before the buffer is written again (``waits``
counts the uploads that found it still running).  Without ``g++`` the
routine is ATen's copy; the bytes are the same.  The CPU runs the same
path with an unpinned buffer, so the CPU tests see what a card runs.
"""

import ctypes
import os.path as osp
import subprocess
import threading

import numpy as np
import torch

from ..native import build_library
from ..utils.profiling import annotate

__all__ = ['upload', 'chunk_plan', 'Stager', 'stager', 'upload_counts',
           'CHUNK_BYTES']

# about 4 frames of 720p (11.06 MB); the routine keeps its whole-buffer
# rate at chunks of one frame and up (PERF.md, section 6)
CHUNK_BYTES = 12 << 20

_SRC = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), 'kernels',
                'csrc', 'host_stage.cpp')

_lib = None
_stagers = {}
_stagers_lock = threading.Lock()


def _load():
    """The C++ routine, or False where it cannot be built (no ``g++``, or
    a compiler that refuses it) or loaded."""
    global _lib
    if _lib is None:
        try:
            lib = build_library(_SRC, 'host_stage')
            lib.host_stage_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_size_t]
            lib.host_stage_copy.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = False
    return _lib


def stage_copy(dst, src):
    """Host bytes ``src`` → host bytes ``dst`` (flat uint8 tensors of one
    length), by the C++ routine, else ATen's copy."""
    lib = _load()
    if lib:
        lib.host_stage_copy(dst.data_ptr(), src.data_ptr(), src.numel())
    else:
        dst.copy_(src)


def chunk_plan(n, item_bytes, chunk_bytes):
    """``[(i0, i1), ...]``: ``n`` items of ``item_bytes`` each in chunks of
    whole items, each at most ``chunk_bytes`` (at least one item), covering
    ``0..n`` once in order; one chunk where all fit."""
    per = max(1, chunk_bytes // max(item_bytes, 1))
    return [(i, min(i + per, n)) for i in range(0, n, per)]


def upload_counts():
    """A fresh ``upload_stats`` dict: uploads, chunks, bytes, and the
    uploads that waited for the previous one's copy."""
    return {'calls': 0, 'chunks': 0, 'bytes': 0, 'waits': 0}


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


class Stager:
    """The staged upload to one device (see the module's docstring)."""

    def __init__(self, device):
        self.device = device
        self.buffer = None
        self.event = torch.cuda.Event() if device.type == 'cuda' else None
        self._lock = threading.Lock()

    def _room(self, nbytes):
        if self.buffer is None or self.buffer.numel() < nbytes:
            self.buffer = None      # the old block goes before the new
            self.buffer = torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=self.event is not None)
        return self.buffer

    def copy(self, src, out, stats):
        """Contiguous host tensor ``src`` → ``out`` (its shape and dtype on
        this device), chunk by chunk; returns ``out`` without waiting for
        the card's copies.  Counts into ``stats``."""
        n = src.shape[0] if src.dim() else 1
        nbytes = src.numel() * src.element_size()
        if not out.is_contiguous() or \
                out.numel() * out.element_size() != nbytes:
            raise ValueError(f'upload: out must be contiguous and hold the '
                             f'{nbytes} bytes of the frames')
        unit = nbytes // n if n else 0
        plan = chunk_plan(n, unit, CHUNK_BYTES) if nbytes else []
        s, d = _bytes(src), _bytes(out)
        with self._lock:
            if self.event is not None and not self.event.query():
                stats['waits'] += 1
                self.event.synchronize()
            buf = self._room(nbytes)
            for i0, i1 in plan:
                b0, b1 = i0 * unit, i1 * unit
                stage_copy(buf[b0:b1], s[b0:b1])
                d[b0:b1].copy_(buf[b0:b1], non_blocking=True)
            if self.event is not None:
                self.event.record(torch.cuda.current_stream(self.device))
        stats['calls'] += 1
        stats['chunks'] += len(plan)
        stats['bytes'] += nbytes
        return out


def canonical(device):
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def stager(device):
    """The one :class:`Stager` of ``device``."""
    device = canonical(device)
    with _stagers_lock:
        st = _stagers.get(device)
        if st is None:
            st = _stagers[device] = Stager(device)
    return st


def upload(frames, device, out=None, stats=None):
    """Host frames (an array or a CPU tensor) → a tensor on ``device``
    (``out`` where given: its shape and dtype), staged chunk by chunk and
    without waiting for the card's copies; the span
    ``tpudet3d_torch.serve.upload``.  ``stats`` (an ``upload_stats``
    dict) counts it."""
    with annotate('tpudet3d_torch.serve.upload'):
        src = torch.as_tensor(np.ascontiguousarray(frames))
        if out is None:
            out = torch.empty(src.shape, dtype=src.dtype, device=device)
        return stager(device).copy(
            src, out, upload_counts() if stats is None else stats)
