"""Python-file config system (copy of ``tpudet3d/core/config.py``).

:class:`AttrDict` gives recursive attribute access, and a missing key
resolves to an empty, falsy AttrDict (``if cfg.model.resume: ...`` works
when ``resume`` was never set).  ``read_py_config`` imports a ``.py`` file
through an importlib spec and wraps its globals.
"""

import copy
import importlib.util
import os.path as osp
import warnings

__all__ = ['AttrDict', 'read_py_config', 'check_isfile', 'merge_cli_overrides']


class AttrDict(dict):
    """Recursive attribute dict; missing keys yield empty (falsy) AttrDicts."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            for k, v in dict(arg).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @classmethod
    def _convert(cls, value):
        if isinstance(value, AttrDict):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._convert(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._convert(value))

    __setattr__ = __setitem__

    def __getattr__(self, key):
        if key.startswith('__'):
            raise AttributeError(key)
        return self[key]

    def __missing__(self, key):
        # not stored: repeated reads of an unset key stay falsy
        return AttrDict()

    def __delattr__(self, key):
        del self[key]

    def __deepcopy__(self, memo):
        out = AttrDict()
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, AttrDict):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = type(v)(i.to_dict() if isinstance(i, AttrDict) else i
                            for i in v)
            out[k] = v
        return out


def check_isfile(fpath):
    """True if ``fpath`` is a file; warns otherwise."""
    isfile = osp.isfile(fpath)
    if not isfile:
        warnings.warn(f'No file found at "{fpath}"')
    return isfile


def read_py_config(filename):
    """Import a ``.py`` config file and return its globals as an AttrDict."""
    filename = osp.abspath(osp.expanduser(filename))
    if not check_isfile(filename):
        raise RuntimeError('config not found')
    if not filename.endswith('.py'):
        raise ValueError(f'config must be a .py file: {filename}')
    module_name = osp.basename(filename)[:-3]
    spec = importlib.util.spec_from_file_location(module_name, filename)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return AttrDict({
        name: value for name, value in vars(mod).items()
        if not name.startswith('__')
    })


def merge_cli_overrides(cfg, args):
    """``--root`` and ``--output_dir`` of the training CLI override the
    config's ``data.root`` and ``output_dir`` when given."""
    if getattr(args, 'root', ''):
        cfg.data.root = args.root
    if getattr(args, 'output_dir', ''):
        cfg.output_dir = args.output_dir
    return cfg
