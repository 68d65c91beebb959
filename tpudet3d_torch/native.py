"""ctypes bindings for the C++ host helpers of the tracker (copy of
``tpudet3d/native/__init__.py``): LAPJV linear assignment and the GIoU cost
matrix, from the repository's ``native/tpudet3d_native.cpp``.

The library is built with ``g++`` on first use into the port's own build
directory (``tpudet3d_torch/kernels/_build/``, keyed by a hash of the
source, the flags and the machine), never over the JAX package's
``native/*.so``; :func:`build_library` builds the port's other host C++
(``kernels/csrc/host_stage.cpp``) the same way.  On a host without a
compiler both functions take their scipy / numpy route;
:func:`native_available` says which route runs.
"""

import ctypes
import hashlib
import os
import os.path as osp
import platform
import subprocess
import tempfile

import numpy as np

__all__ = ['linear_assignment', 'giou_cost_matrix', 'native_available',
           'build_library']

_SRC = osp.abspath(osp.join(osp.dirname(__file__), '..', 'native',
                            'tpudet3d_native.cpp'))
_BUILD = osp.join(osp.dirname(osp.abspath(__file__)), 'kernels', '_build')

_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_lib = None


def _lib_path(src=_SRC, name='native'):
    with open(src, 'rb') as f:
        key = f.read() + ' '.join(_FLAGS + [platform.machine()]).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return osp.join(_BUILD, f'{name}-{digest}', f'lib{name}.so')


def _build(src, path):
    """Compile into a temporary name and rename, so that processes building
    at once never load a half-written library."""
    os.makedirs(osp.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=osp.dirname(path))
    os.close(fd)
    try:
        subprocess.run(['g++', *_FLAGS, '-o', tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.unlink(tmp)


def build_library(src, name):
    """The C++ source ``src`` as a ``ctypes.CDLL``, built with ``g++`` on
    first use into ``kernels/_build/<name>-<hash>/``; raises where it
    cannot be built or loaded."""
    path = _lib_path(src, name)
    if not osp.exists(path):
        _build(src, path)
    return ctypes.CDLL(path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = build_library(_SRC, 'native')
        lib.linear_assignment.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.giou_cost_matrix.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
    except Exception:
        _lib = False
    return _lib


def native_available():
    return bool(_load())


def linear_assignment(cost):
    """cost [R,C] → (row_idx, col_idx) of the min-cost assignment."""
    cost = np.ascontiguousarray(cost, np.float64)
    r, c = cost.shape
    if r == 0 or c == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    lib = _load()
    if lib:
        out = np.full(r, -1, np.int32)
        lib.linear_assignment(
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), r, c,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        rows = np.nonzero(out >= 0)[0]
        return rows.astype(np.int64), out[rows].astype(np.int64)
    from scipy.optimize import linear_sum_assignment
    return linear_sum_assignment(cost)


def giou_cost_matrix(detections, track_boxes):
    """detections [N,4], track_boxes [M,4] → 0.5*(1-GIoU) cost [N,M]."""
    det = np.ascontiguousarray(detections, np.float64).reshape(-1, 4)
    trk = np.ascontiguousarray(track_boxes, np.float64).reshape(-1, 4)
    n, m = det.shape[0], trk.shape[0]
    lib = _load()
    if lib and n and m:
        cost = np.empty((n, m), np.float64)
        lib.giou_cost_matrix(
            det.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            trk.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m,
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return cost
    if not (n and m):
        return np.zeros((n, m), np.float64)
    a1 = np.clip(det[:, 2] - det[:, 0], 0, None) \
        * np.clip(det[:, 3] - det[:, 1], 0, None)
    a2 = np.clip(trk[:, 2] - trk[:, 0], 0, None) \
        * np.clip(trk[:, 3] - trk[:, 1], 0, None)
    lt = np.maximum(det[:, None, :2], trk[None, :, :2])
    rb = np.minimum(det[:, None, 2:], trk[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    elt = np.minimum(det[:, None, :2], trk[None, :, :2])
    erb = np.maximum(det[:, None, 2:], trk[None, :, 2:])
    enclose = np.clip(erb - elt, 0, None).prod(-1)
    union = a1[:, None] + a2[None, :] - inter
    iou = np.where(union > 0, inter / union, 0.0)
    giou = np.where(enclose > 0, iou - (enclose - union) / enclose, -1.0)
    return 0.5 * (1.0 - giou)
