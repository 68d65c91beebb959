"""Filesystem and console helpers (copy of ``tpudet3d/core/logging.py``):
``mkdir_if_missing`` and ``Logger``, the stdout tee of the training CLI."""

import errno
import os
import os.path as osp
import sys

__all__ = ['Logger', 'mkdir_if_missing']


def mkdir_if_missing(dirname):
    """Creates dirname if it is missing."""
    if dirname and not osp.exists(dirname):
        try:
            os.makedirs(dirname)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise


class Logger:
    """Writes console output to an external text file as well."""

    def __init__(self, fpath=None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(osp.dirname(fpath))
            self.file = open(fpath, 'w')

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None
