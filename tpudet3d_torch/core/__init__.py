from .config import AttrDict, read_py_config, check_isfile, merge_cli_overrides
from .device import resolve_device
from .logging import Logger, mkdir_if_missing
from .meters import AverageMeter, TextTable
from .prng import set_random_seed

# the regressor's class order (copy of tpudet3d/core/__init__.py:7)
OBJECTRON_CLASSES = ('bike', 'book', 'bottle', 'cereal_box', 'camera',
                     'chair', 'cup', 'laptop', 'shoe')
# the detector's class order, camera and cereal_box swapped (copy of
# tpudet3d/core/__init__.py:13-16)
DETECTOR_CLASSES = ('bike', 'book', 'bottle', 'camera', 'cereal_box',
                    'chair', 'cup', 'laptop', 'shoe')
DETECTOR_TO_REGRESSOR_CLS = tuple(OBJECTRON_CLASSES.index(c)
                                  for c in DETECTOR_CLASSES)

__all__ = ['AttrDict', 'read_py_config', 'check_isfile', 'merge_cli_overrides',
           'resolve_device', 'Logger', 'mkdir_if_missing', 'AverageMeter',
           'TextTable', 'set_random_seed', 'OBJECTRON_CLASSES',
           'DETECTOR_CLASSES', 'DETECTOR_TO_REGRESSOR_CLS']
