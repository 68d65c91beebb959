from .config import AttrDict, read_py_config, check_isfile
from .device import resolve_device

__all__ = ['AttrDict', 'read_py_config', 'check_isfile', 'resolve_device']
