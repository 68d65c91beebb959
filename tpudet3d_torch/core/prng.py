"""Host seeding (counterpart of ``tpudet3d/core/prng.py``).

The JAX package seeds numpy and ``random`` and returns the root PRNG key.
The port seeds the same host generators and returns the seed itself: the
caller makes its own ``torch.Generator`` from it (the trainer's on the
card), so torch's global generator is never a side channel.
"""

import os
import random

import numpy as np

__all__ = ['set_random_seed']


def set_random_seed(seed):
    """Seed numpy's and ``random``'s global generators; returns ``seed``."""
    seed = int(seed)
    np.random.seed(seed)
    random.seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
    return seed
