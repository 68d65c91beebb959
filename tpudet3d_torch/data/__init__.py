"""Host-side data: datasets, the threaded loader, the host and device
augmentations (counterpart of ``tpudet3d/data``), and the Objectron
record reader (``converter/proto.py``)."""
from .dataset import Objectron, SyntheticObjectron
from .loader import BatchLoader, build_loader
from .transforms import TRANSFORMS_REGISTRY, build_augmentations

__all__ = ['Objectron', 'SyntheticObjectron', 'BatchLoader', 'build_loader',
           'build_augmentations', 'TRANSFORMS_REGISTRY']
