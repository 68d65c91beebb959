"""Filesystem helper of the evaluation CLI (copy of ``mkdir_if_missing``
from ``tpudet3d/core/logging.py``)."""

import errno
import os
import os.path as osp

__all__ = ['mkdir_if_missing']


def mkdir_if_missing(dirname):
    """Creates dirname if it is missing."""
    if dirname and not osp.exists(dirname):
        try:
            os.makedirs(dirname)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise
