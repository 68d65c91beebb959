"""Device selection for the port's entry points."""

import torch

__all__ = ['resolve_device']


def resolve_device(device=None):
    """``None`` means the card: raise when CUDA is missing instead of
    carrying on quietly on the CPU.  Pass ``'cpu'`` to run the plain
    PyTorch versions of the kernels on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run on the CPU')
        return torch.device('cuda')
    return torch.device(device)
