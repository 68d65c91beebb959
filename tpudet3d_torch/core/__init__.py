from .config import AttrDict, read_py_config, check_isfile
from .device import resolve_device
from .logging import mkdir_if_missing

# the regressor's class order (copy of tpudet3d/core/__init__.py:7)
OBJECTRON_CLASSES = ('bike', 'book', 'bottle', 'cereal_box', 'camera',
                     'chair', 'cup', 'laptop', 'shoe')

__all__ = ['AttrDict', 'read_py_config', 'check_isfile', 'resolve_device',
           'mkdir_if_missing', 'OBJECTRON_CLASSES']
