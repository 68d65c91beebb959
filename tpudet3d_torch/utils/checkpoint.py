"""Snapshots (counterpart of ``tpudet3d/utils/checkpoint.py``).

The JAX package writes each training snapshot as an orbax directory
``snap_{epoch}/``.  The port's snapshot is one file ``snap_{epoch}.pt``,
written by the port's trainer (:func:`save_snap`) or, beside an orbax
directory, by ``scripts/snapshot_to_torch.py``: a plain dict

    {'format': 'tpudet3d_torch/1', 'kind': 'detector' | 'regressor',
     'epoch': int, 'params': state_dict, 'ema_params': state_dict or None}

where each ``state_dict`` (``utils/convert.py`` keys) carries the batch
statistics too.  A training snapshot adds what resuming needs:
``optimizer`` (the optimizer's ``state_dict``: Adam's moments, SGD's
momentum buffers), ``step``, and ``alwa`` (the regressor's ALWA state,
name → tensor) or ``balance`` (the detector's loss-balancing pair).  Every value is a tensor or a Python
primitive, so ``torch.load(weights_only=True)`` reads it.  Which of the
two weight sets to serve is decided at load time (``detect/load.py``,
``infer/build.py``).

:func:`resume_from` restores a training snapshot fully; a snapshot
without the training fields (converted from the JAX package) or of
another shape restores tolerantly (:func:`merge_matching`).
"""

import dataclasses
import os
import os.path as osp
import re

import torch

__all__ = ['FORMAT', 'snapshot_path', 'converted_path', 'save_converted',
           'load_converted', 'resolve_converted', 'latest_snapshot',
           'save_snap', 'resume_from', 'load_pretrained_weights',
           'merge_matching']

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


def save_converted(path, kind, epoch, params, ema_params=None, **training):
    """Write a snapshot; ``training`` adds the resume fields."""
    if kind not in KINDS:
        raise ValueError(f'kind must be one of {KINDS}, not {kind!r}')
    torch.save({'format': FORMAT, 'kind': kind, 'epoch': int(epoch),
                'params': params, 'ema_params': ema_params or None,
                **training}, path)
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
    as given, an orbax ``snap_N`` directory (or a ``snap_N`` that only the
    port's trainer wrote) → the ``snap_N.pt`` beside it.  Raises with the
    converting command when that file is missing."""
    if not osp.exists(path) and osp.isfile(converted_path(path)):
        return converted_path(path)
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


# --- training snapshots -------------------------------------------------

def _cpu(tree):
    """A copy of ``tree`` with every tensor detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _model_weights(model):
    """The model's weights and batch statistics in ``utils/convert.py``
    keys (no ``num_batches_tracked``)."""
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith('num_batches_tracked')}


def _kind(state):
    """A detector train state (``detect/train.py``) carries the balance
    pair, a regressor's (``train/state.py``) the ALWA state."""
    return 'detector' if hasattr(state, 'balance') else 'regressor'


def save_snap(state, epoch, log_path):
    """Write ``snap_{epoch}.pt`` in ``log_path``: the weights, the EMA
    (with the same batch statistics), the optimizer, step, and ALWA (a
    regressor's state) or the balance pair (a detector's)."""
    path = converted_path(snapshot_path(log_path, epoch))
    print(f'==> saving checkpoint to {path}')
    params = _cpu(_model_weights(state.model))
    ema = None
    if state.ema_params is not None:
        ema = dict(params, **_cpu(state.ema_params))
    kind = _kind(state)
    if kind == 'detector':
        extra = {'balance': {k: _cpu(v) for k, v in state.balance.items()}}
    else:
        extra = {'alwa': {f.name: _cpu(getattr(state.alwa, f.name))
                          for f in dataclasses.fields(state.alwa)}}
    os.makedirs(log_path, exist_ok=True)
    return save_converted(path, kind, epoch, params, ema,
                          optimizer=_cpu(state.optimizer.state_dict()),
                          step=_cpu(state.step), **extra)


def merge_matching(target, source):
    """``target`` (name → tensor) with each tensor whose name and shape
    ``source`` matches replaced by the source's, cast to the target's dtype
    and device; reports what was skipped, and raises when nothing
    matched."""
    matched, discarded, merged = [], [], {}
    for key, t in target.items():
        s = source.get(key)
        if s is not None and tuple(s.shape) == tuple(t.shape):
            matched.append(key)
            merged[key] = s.to(dtype=t.dtype, device=t.device)
        else:
            discarded.append(key)
            merged[key] = t
    if not matched:
        raise RuntimeError('The pretrained weights cannot be loaded — '
                           'no matching layers')
    if discarded:
        print(f'** skipped {len(discarded)} unmatched leaves '
              f'(first few: {discarded[:5]})')
    print(f'Successfully loaded {len(matched)} matching leaves')
    return merged


def load_pretrained_weights(state, file_path):
    """Tolerant restore of a snapshot's weights and batch statistics into
    ``state``'s model (the EMA, optimizer and ALWA stay as they are)."""
    snap = load_converted(resolve_converted(file_path), kind='regressor')
    state.model.load_state_dict(
        merge_matching(_model_weights(state.model), snap['params']),
        strict=False)
    return state


def _restore_full(state, snap):
    """Every field of a training snapshot whose weights match the model
    exactly; raises (KeyError, ValueError, RuntimeError) otherwise."""
    from .convert import load_state_dict_strict
    if 'optimizer' not in snap:
        raise KeyError('no optimizer state: not a training snapshot')
    load_state_dict_strict(state.model, snap['params'])
    state.optimizer.load_state_dict(snap['optimizer'])
    dev = state.step.device
    with torch.no_grad():
        if _kind(state) == 'detector':
            for name, value in snap['balance'].items():
                state.balance[name].copy_(value.to(dev))
        else:
            for name, value in snap['alwa'].items():
                getattr(state.alwa, name).copy_(value.to(dev))
    state.step.copy_(snap['step'].to(dev))
    toggled = (state.ema_params is None) != (snap['ema_params'] is None)
    if state.ema_params is not None:
        source = snap['ema_params'] or snap['params']
        with torch.no_grad():
            for k, e in state.ema_params.items():
                e.copy_(source[k])
    return toggled


def resume_from(state, chkpt_path):
    """Restore ``state`` in place from a snapshot; returns ``(state,
    start_epoch)`` with ``start_epoch`` the saved epoch + 1.

    A training snapshot of the same model restores fully: weights,
    statistics, optimizer, step, EMA, and ALWA (a regressor) or the
    balance pair (a detector).  Where the config keeps an EMA and the
    snapshot has none, the average starts from the restored weights; where
    the snapshot has one and the config none, it is dropped.  Anything
    else (a snapshot converted from the JAX package, another head)
    restores tolerantly: weights, statistics and EMA by name and shape,
    the optimizer and ALWA or balance left fresh, both reported.  A
    snapshot of the other kind (a regressor's into a detector's state, or
    the reverse) is refused."""
    path = resolve_converted(chkpt_path)
    print(f'Loading checkpoint from "{path}"')
    kind = _kind(state)
    snap = load_converted(path, kind=kind)
    start_epoch = int(snap.get('epoch', -1)) + 1
    try:
        toggled = _restore_full(state, snap)
    except (KeyError, ValueError, RuntimeError) as e:
        fresh = 'balance' if kind == 'detector' else 'ALWA'
        print(f'Full state restore failed ({type(e).__name__}); falling '
              f'back to weight+stats restore (optimizer and {fresh} state '
              f'not restored)')
    else:
        print('Loaded full train state' + (
            ' (ema_params toggled to match the config)' if toggled else '')
            + f'; last epoch = {start_epoch}')
        return state, start_epoch
    weights = merge_matching(_model_weights(state.model), snap['params'])
    state.model.load_state_dict(weights, strict=False)
    if state.ema_params is not None:
        params = dict(state.model.named_parameters())
        source = (merge_matching(state.ema_params, snap['ema_params'])
                  if snap['ema_params'] else params)
        with torch.no_grad():
            for k, e in state.ema_params.items():
                e.copy_(source[k])
    return state, start_epoch
