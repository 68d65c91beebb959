"""tpudet3d_torch — the PyTorch/CUDA port of tpudet3d for NVIDIA Hopper.

The package mirrors the layout of ``tpudet3d`` (``detect/nms.py`` is the
counterpart of ``tpudet3d/detect/nms.py``) and imports only ``torch`` and
``numpy``.  Public functions keep the JAX package's NHWC layout: frames are
``[N,H,W,3]`` uint8, crops ``[K,h,w,3]``, boxes xyxy in pixels.  Inside the
models the tensors are NCHW views in ``channels_last`` memory, so the NHWC
outputs of the kernels feed the convolutions without a transpose.

Importing the package builds nothing: the CUDA kernels
(``tpudet3d_torch/kernels/csrc``) are compiled with ``nvcc`` the first time
a kernel wrapper is called on a CUDA tensor.
"""

__version__ = '0.1.0'

__all__ = ['__version__']
