"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) into an object for ``sm_90a``, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``kernels/_build/<hash of sources and flags>/``, which
``.gitignore`` lists, the first time a kernel wrapper runs on a CUDA tensor;
later calls in the same checkout reuse it.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ['build', 'library', 'check', 'stream_args', 'BUILD_ROOT', 'CSRC',
           'NVCC_FLAGS']

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parent / '_build'
LIB_NAME = 'libtpudet3d_kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: pointers and the stream as c_void_p, so no pointer is cut;
# every entry ends with (device index, stream)
SIGNATURES = {
    'tpd_resize_bilinear_u8': (_P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _F,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    'tpd_crop_resize_u8': (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                           _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    'tpd_decode_nms': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _I, _I, _I, _P),
    'tpd_head_epilogue': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _F,
                          _F, _F, _F, _F, _F, _I, _P),
    'tpd_box3d_iou': (_P, _P, _P, _I, _I, _P),
    'tpd_quantize_input': (_P, _P) + (_I,) * 18 + (_F,) + (_I,) * 6 + (_P,),
    'tpd_int8_rescale': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    'tpd_window_attention': (_P, _P, _P) + (_I,) * 8 + (_F, _I, _P),
}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (looked on PATH and in '
                       f'{cuda_home}/bin): the CUDA kernels cannot be built')


def _digest(sources):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if this checkout has no library for the current
    sources yet.  Returns ``(path, seconds, log)``: seconds is 0.0 and log
    the stored compiler output when the library already existed."""
    sources = sorted(CSRC.glob('*.cu'))
    headers = sorted(CSRC.glob('*.cuh'))
    out_dir = BUILD_ROOT / _digest(sources + headers)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0, (out_dir / 'build.log').read_text()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_ROOT / f'tmp-{os.getpid()}-{out_dir.name}'
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    objs = [tmp / f'{src.stem}.o' for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', str(src), '-o',
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = ''.join(f'== {src.name}\n{out}' for src, out in zip(sources, logs))
    failed = [src.name for src, p in zip(sources, procs) if p.returncode]
    if failed:
        raise RuntimeError(f'nvcc failed on {failed}:\n{log}')
    link = subprocess.run([nvcc, '-shared', *NVCC_FLAGS[:2], '-o',
                           str(tmp / LIB_NAME), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    log += f'== link\n{link.stdout}'
    if link.returncode:
        raise RuntimeError(f'nvcc link failed:\n{log}')
    (tmp / 'build.log').write_text(log)
    try:
        os.rename(tmp, out_dir)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib, time.perf_counter() - t0, log


@functools.cache
def library():
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpd_error_string.argtypes = (ctypes.c_int,)
    lib.tpd_error_string.restype = ctypes.c_char_p
    return lib


def stream_args(t):
    """The trailing (device index, stream) arguments for a launch on the
    device of tensor ``t``, on PyTorch's current stream there."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(err, name):
    if err != 0:
        msg = library().tpd_error_string(err).decode()
        raise RuntimeError(f'{name}: CUDA error {err} ({msg})')
