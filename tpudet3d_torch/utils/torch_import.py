"""Load published torch checkpoints (ImageNet backbones) into the port's
models (counterpart of ``tpudet3d/utils/torch_import.py``).

The reference checkpoints' layouts are not the port's (timm, d-li14 and
lukemelas names and module orders), so, as in the JAX package, tensors
are matched by *ordered shape matching within parameter kinds*: the
checkpoint's tensors of each kind form a FIFO queue in the file's order,
and the model's tensors, taken in construction order, each consume the
head of their kind's queue when its shape matches (else keep their
values).  Unmatched or shape-mismatched tensors are reported, as the
reference's tolerant loader does; with a pinned contract
(``utils/pretrained_contract.py``) anything left over raises.

The result puts the same tensor in the same place as the JAX package's
matcher followed by ``utils/convert.py``, because each step is the JAX
one:

* the model's tensors are named by their Flax paths (the port's module
  names mirror the Flax tree: ``ConvBN_0.Conv_0.weight`` is
  ``['ConvBN_0']['Conv_0']['kernel']``), the parameters then the batch
  statistics, each sorted by the digit-aware natural key of that path
  (Flax flattens dicts lexicographically, which would put ``blocks_10``
  before ``blocks_2``);
* kinds follow ``_torch_kind`` / ``_flax_kind``: batch-norm biases and
  dense biases are separate queues (inside an SE block the orders differ);
* shapes are compared in the Flax layouts (convs ``[kh,kw,I,O]``, dense
  ``[I,O]``; timm's SE 1×1 convs and ``conv_head`` squeezed to dense),
  and a matched tensor goes back to the port's layout by the rules of
  ``utils/convert.py``: a conv keeps ``[O,I,kh,kw]``, a dense kernel
  lands in an ``nn.Linear`` weight as ``[O,I]``.
"""

import re

import numpy as np
import torch
from torch import nn

__all__ = ['load_torch_checkpoint_into', 'read_checkpoint',
           'resolve_pretrained_path']

#: timm efficientnet-family modules that are 1×1 convs in the checkpoint but
#: dense layers in the port's trunks (SE on pooled features; the post-pool
#: head conv): squeezed [O,I,1,1] → [O,I] into the dense queues.
_TIMM_DENSE_SUFFIXES = ('.se.conv_reduce.weight', '.se.conv_expand.weight')


def _is_timm_layout(keys):
    """timm state_dicts have ``conv_stem.weight`` and ``conv_head.weight``;
    the lukemelas lite layout (``_conv_stem``) keeps its head conv, a real
    conv before the pool."""
    ks = set(keys)
    return 'conv_stem.weight' in ks and 'conv_head.weight' in ks


def _to_jax_layout(arr):
    if arr.ndim == 4:           # conv: OIHW → HWIO
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2:           # linear: OI → IO
        return arr.T
    return arr


def _from_jax_layout(arr, is_kernel):
    """``utils/convert.py``'s rule: a kernel back to the port's layout,
    anything else unchanged."""
    if is_kernel and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if is_kernel and arr.ndim == 2:
        return arr.T
    return arr


def _checkpoint_arrays(state_dict):
    """``{name: array in the JAX layout}``, ``num_batches_tracked`` left
    out."""
    timm = _is_timm_layout(state_dict.keys())
    out = {}
    for k, v in state_dict.items():
        if k.endswith('num_batches_tracked'):
            continue
        arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v))
        if timm and arr.ndim == 4 and arr.shape[2:] == (1, 1) \
                and (k == 'conv_head.weight'
                     or k.endswith(_TIMM_DENSE_SUFFIXES)):
            arr = arr[:, :, 0, 0]
        out[k] = _to_jax_layout(arr)
    return out


def _torch_kind(name, arr, raw_keys):
    """The kind of a checkpoint tensor.  A module that owns running
    statistics is a batch norm: names alone cannot tell a batch-norm bias
    from a dense one."""
    if name.endswith('running_mean'):
        return 'bn_mean'
    if name.endswith('running_var'):
        return 'bn_var'
    if arr.ndim == 4:
        return 'conv'
    if arr.ndim == 2:
        return 'dense'
    prefix = name.rsplit('.', 1)[0]
    is_bn = f'{prefix}.running_mean' in raw_keys
    if name.endswith('weight'):
        return 'bn_scale' if is_bn else 'other'
    if name.endswith('bias'):
        return 'bn_bias' if is_bn else 'dense_bias'
    return 'other'


def _flax_kind(path_str, ndim):
    """The kind of a model tensor from its Flax path and rank (the JAX
    package's rules, on the same strings)."""
    p = path_str.lower()
    if ndim == 4:
        return 'conv'
    if ndim == 2:
        return 'dense'
    if 'mean' in p:
        return 'bn_mean'
    if 'var' in p:
        return 'bn_var'
    if 'scale' in p:
        return 'bn_scale'
    is_bn = 'batchnorm' in p or 'bn' in p
    if ndim == 1 and 'bias' in p:
        return 'bn_bias' if is_bn else 'dense_bias'
    return 'other'


def _natural_key(path_str):
    """Digit-aware sort key: blocks_2 < blocks_10."""
    return [int(t) if t.isdigit() else t
            for t in re.split(r'(\d+)', path_str)]


_BN = (nn.BatchNorm1d, nn.BatchNorm2d)
_BN_LEAF = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
            'running_mean': ('batch_stats', 'mean'),
            'running_var': ('batch_stats', 'var')}


def _port_tensors(module):
    """``[(collection, flax path string, state_dict key, tensor,
    is_kernel)]`` of ``module``'s parameters and batch statistics: the Flax
    name of each (``'params'`` or ``'batch_stats'``; ``['a']['b']['kernel']``)
    and whether it is a conv or dense kernel."""
    owners = dict(module.named_modules())
    out = []
    for key, t in module.state_dict(keep_vars=True).items():
        if key.endswith('num_batches_tracked'):
            continue
        owner, _, leaf = key.rpartition('.')
        m = owners[owner]
        kernel = False
        if isinstance(m, _BN):
            collection, name = _BN_LEAF[leaf]
        elif isinstance(m, (nn.Conv2d, nn.Linear)) and leaf == 'weight':
            collection, name, kernel = 'params', 'kernel', True
        else:
            collection, name = 'params', leaf
        path = (owner.split('.') if owner else []) + [name]
        out.append((collection, ''.join(f"['{p}']" for p in path), key, t,
                    kernel))
    return out


def _jax_shape(t, kernel):
    shape = tuple(t.shape)
    if kernel and len(shape) == 4:
        return shape[2:] + shape[1::-1]     # [O,I,kh,kw] → [kh,kw,I,O]
    if kernel and len(shape) == 2:
        return shape[::-1]
    return shape


def resolve_pretrained_path(model_name, pretrained):
    """``cfg.model.pretrained`` → a local checkpoint path or None: an
    explicit path, or with ``True`` ``$TPUDET3D_PRETRAINED_DIR`` then
    ``./pretrained/`` for ``{model_name}.pth``."""
    import os
    if isinstance(pretrained, str) and pretrained:
        return pretrained if os.path.isfile(pretrained) else None
    if not pretrained:
        return None
    candidates = []
    root = os.environ.get('TPUDET3D_PRETRAINED_DIR')
    if root:
        candidates.append(os.path.join(root, f'{model_name}.pth'))
    candidates.append(os.path.join('pretrained', f'{model_name}.pth'))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def read_checkpoint(path):
    """A torch checkpoint's state_dict, loaded with ``weights_only=True``
    (the files are third-party downloads: an unrestricted unpickle would run
    the file's code before any check), unwrapped from ``state_dict`` or
    ``model``."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    for wrapper_key in ('state_dict', 'model'):
        if wrapper_key in ckpt and hasattr(ckpt[wrapper_key], 'items'):
            return ckpt[wrapper_key]
    return ckpt


@torch.no_grad()
def load_torch_checkpoint_into(module, checkpoint_path, verbose=True,
                               contract=None, allow_unused=(), report=None):
    """Ordered-shape-matching merge of a torch checkpoint into ``module``'s
    parameters and batch statistics, in place; returns ``module``.
    Unmatched model tensors keep their values; unmatched checkpoint tensors
    are reported and dropped.

    ``contract``: an optional pinned ``[(key, shape), ...]``
    (``utils/pretrained_contract.py``) that the checkpoint must equal
    exactly: keys, shapes and order.  With a contract, a checkpoint tensor
    left over whose name matches no ``allow_unused`` pattern raises.
    ``report``: an optional dict given ``matched``, ``skipped`` and
    ``leftovers``."""
    ckpt = read_checkpoint(checkpoint_path)
    if contract is not None:
        from .pretrained_contract import verify_state_dict
        rep = verify_state_dict(ckpt, contract)
        if not rep['ok']:
            raise RuntimeError(
                'checkpoint does not match the pinned contract: '
                f'missing={rep["missing"][:5]} extra={rep["extra"][:5]} '
                f'shape_mismatch={rep["shape_mismatch"][:5]} '
                f'order_ok={rep["order_ok"]}')
    raw_keys = set(ckpt.keys())
    by_kind = {}
    for name, arr in _checkpoint_arrays(ckpt).items():
        by_kind.setdefault(_torch_kind(name, arr, raw_keys), []).append(
            (name, arr))
    used = {k: 0 for k in by_kind}
    matched = skipped = 0
    entries = _port_tensors(module)
    for collection in ('params', 'batch_stats'):
        group = sorted((e for e in entries if e[0] == collection),
                       key=lambda e: _natural_key(e[1]))
        for _, path, _key, t, kernel in group:
            kind = _flax_kind(path, t.dim())
            queue = by_kind.get(kind, [])
            i = used.get(kind, 0)
            if i < len(queue) and queue[i][1].shape == _jax_shape(t, kernel):
                used[kind] = i + 1
                matched += 1
                arr = _from_jax_layout(queue[i][1], kernel)
                t.copy_(torch.from_numpy(np.ascontiguousarray(
                    arr.astype(np.float32))).to(t.dtype))
            else:
                skipped += 1
    leftovers = [q[i][0] for k, q in by_kind.items()
                 for i in range(used.get(k, 0), len(q))]
    if verbose:
        print(f'torch import: matched {matched} tensors, skipped {skipped}'
              + (f'; unused torch tensors: {leftovers[:8]}'
                 f'{"..." if len(leftovers) > 8 else ""}' if leftovers else ''))
    if report is not None:
        report.update(matched=matched, skipped=skipped, leftovers=leftovers)
    if matched == 0:
        raise RuntimeError('no torch tensors could be matched')
    if contract is not None:
        bad = [n for n in leftovers
               if not any(re.fullmatch(p, n) for p in allow_unused)]
        if bad:
            raise RuntimeError(
                'contracted import left torch tensors unconsumed (FIFO '
                f'desync or architecture gap): {bad[:8]}'
                f'{"..." if len(bad) > 8 else ""}')
    return module
