"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), built with nvcc at
first use and loaded with ctypes (``build.py``).  The wrappers live beside
their plain PyTorch versions: K1 and K2 in ``ops/image.py``, K3 in
``detect/nms.py``, K4 in ``infer/epilogue.py`` and K5 in ``ops/box3d.py``."""
