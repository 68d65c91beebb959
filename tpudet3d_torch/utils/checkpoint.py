"""Snapshots for serving (counterpart of the serving half of
``tpudet3d/utils/checkpoint.py``).

The JAX package writes each training snapshot as an orbax directory
``snap_{epoch}/``.  The port reads a **converted snapshot** instead: one
file ``snap_{epoch}.pt`` beside that directory, written by
``scripts/snapshot_to_torch.py``, holding a plain dict

    {'format': 'tpudet3d_torch/1', 'kind': 'detector' | 'regressor',
     'epoch': int, 'params': state_dict, 'ema_params': state_dict or None}

where each ``state_dict`` (``utils/convert.py`` keys) carries the batch
statistics too.  Which of the two weight sets to serve is decided at load
time (``detect/load.py``, ``infer/build.py``).
"""

import os
import os.path as osp
import re

import torch

__all__ = ['FORMAT', 'snapshot_path', 'converted_path', 'save_converted',
           'load_converted', 'resolve_converted', 'latest_snapshot']

FORMAT = 'tpudet3d_torch/1'
KINDS = ('detector', 'regressor')
_SNAP = re.compile(r'snap_(\d+)(\.pt)?$')


def snapshot_path(log_path, epoch):
    """The orbax directory of epoch ``epoch``'s snapshot in ``log_path``."""
    return osp.abspath(osp.join(log_path, f'snap_{epoch}'))


def converted_path(snap_dir):
    """The converted file that belongs beside an orbax snapshot."""
    return osp.normpath(snap_dir) + '.pt'


def _convert_command(snap_dir):
    return f'python scripts/snapshot_to_torch.py {snap_dir}'


def save_converted(path, kind, epoch, params, ema_params=None):
    if kind not in KINDS:
        raise ValueError(f'kind must be one of {KINDS}, not {kind!r}')
    torch.save({'format': FORMAT, 'kind': kind, 'epoch': int(epoch),
                'params': params, 'ema_params': ema_params or None}, path)
    return path


def load_converted(path, kind=None):
    """The dict of a converted snapshot (``torch.load(weights_only=True)``);
    raises on an unreadable file, another format or another ``kind``."""
    try:
        snap = torch.load(path, map_location='cpu', weights_only=True)
    except Exception as e:
        raise ValueError(f'{path}: not a readable converted snapshot '
                         f'({type(e).__name__}: {e})') from e
    if not isinstance(snap, dict) or snap.get('format') != FORMAT:
        raise ValueError(f'{path}: not a converted snapshot of format '
                         f'{FORMAT}')
    if snap.get('kind') not in KINDS or (kind and snap['kind'] != kind):
        raise ValueError(f'{path}: a {snap.get("kind")} snapshot, expected '
                         f'a {kind or " or ".join(KINDS)}')
    for key in ('params', 'ema_params'):
        sd = snap.get(key)
        if (sd is None and key == 'ema_params') or (
                isinstance(sd, dict) and sd and all(
                    isinstance(v, torch.Tensor) for v in sd.values())):
            continue
        raise ValueError(f'{path}: {key} is not a state_dict')
    return snap


def resolve_converted(path):
    """A checkpoint argument → the converted file to load: a ``.pt`` file
    as given, an orbax ``snap_N`` directory → the ``snap_N.pt`` beside it.
    Raises with the converting command when that file is missing."""
    if osp.isdir(path):
        pt = converted_path(path)
        if not osp.isfile(pt):
            raise FileNotFoundError(
                f'{path} is an orbax snapshot without its converted file '
                f'{pt}; write it with: {_convert_command(path)}')
        return pt
    if not osp.isfile(path):
        raise FileNotFoundError(f'no snapshot at {path}')
    return path


def latest_snapshot(log_path):
    """The converted file of the newest ``snap_{epoch}`` in ``log_path``
    (by epoch number, so ``snap_10`` is newer than ``snap_9``), or None when
    there is no snapshot.  Raises, with the converting command, when the
    newest orbax snapshot has no converted file: an older one is never
    served in its place."""
    if not osp.isdir(log_path):
        return None
    epochs = {}
    for name in os.listdir(log_path):
        m = _SNAP.match(name)
        if m:
            epochs.setdefault(int(m.group(1)), set()).add(bool(m.group(2)))
    if not epochs:
        return None
    newest = max(epochs)
    snap_dir = snapshot_path(log_path, newest)
    if True not in epochs[newest]:
        raise FileNotFoundError(
            f'the newest snapshot {snap_dir} has no converted file; write '
            f'it with: {_convert_command(snap_dir)}')
    return converted_path(snap_dir)
