"""Weight bridge: JAX variables → the port's ``state_dict``.

Takes the Flax variables of a ``tpudet3d`` model as numpy trees
(``{'params': ..., 'batch_stats': ...}``, e.g. from ``jax.device_get``) and
returns tensors keyed by the port's module paths.  The port names its
submodules like the Flax tree (``backbone._MBConv_3.ConvBN_1.Conv_0``,
``cls_heads_0``, ``blocks_3``), so the key is the Flax path joined with
dots and the leaf renamed.  Matching is by path, never by flatten order.

Layouts:
  conv kernel  [kh,kw,I/g,O] → weight [O,I/g,kh,kw]  (depthwise [kh,kw,1,C]
                                                     → [C,1,kh,kw])
  dense kernel [I,O]         → weight [O,I]
  BatchNorm    scale/bias/mean/var → weight/bias/running_mean/running_var
  head_kernel [9,C,18], head_bias [9,18], biases: unchanged
"""

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ['jax_to_state_dict', 'load_jax_variables', 'load_state_dict_strict',
           'load_jax_detector_state']

_LEAF = {
    ('params', 'scale'): 'weight',
    ('params', 'bias'): 'bias',
    ('params', 'head_kernel'): 'head_kernel',
    ('params', 'head_bias'): 'head_bias',
    ('batch_stats', 'mean'): 'running_mean',
    ('batch_stats', 'var'): 'running_var',
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert(collection, path, arr):
    leaf = path[-1]
    if (collection, leaf) == ('params', 'kernel'):
        if arr.ndim == 4:
            return 'weight', arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return 'weight', arr.T
        raise ValueError(f'unexpected kernel rank {arr.ndim} at {path}')
    name = _LEAF.get((collection, leaf))
    if name is None:
        raise ValueError(f'no port counterpart for {collection}/'
                         f'{"/".join(path)}')
    return name, arr


def jax_to_state_dict(variables):
    """``{'params', 'batch_stats'}`` numpy trees → ``{key: tensor}``."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ('params', 'batch_stats'):
            raise ValueError(f'unexpected variable collection {collection}')
        for path, leaf in _flatten(tree):
            name, arr = _convert(collection, path,
                                 np.asarray(leaf, dtype=np.float32))
            key = '.'.join(path[:-1] + (name,))
            out[key] = torch.tensor(arr)
    return out


def load_state_dict_strict(module, sd):
    """Load ``sd`` into ``module``.  Raises on any key left unmatched on
    either side (BatchNorm's ``num_batches_tracked`` has no JAX counterpart
    and is left as it is) and on any shape mismatch."""
    own = module.state_dict()
    expected = {k for k in own if not k.endswith('num_batches_tracked')}
    missing = sorted(expected - sd.keys())
    unexpected = sorted(sd.keys() - expected)
    if missing or unexpected:
        raise KeyError(f'unmatched keys: missing in JAX variables '
                       f'{missing[:8]}, without a port module '
                       f'{unexpected[:8]}')
    bad = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in sd.items()
           if v.shape != own[k].shape]
    if bad:
        raise ValueError(f'shape mismatch (key, JAX, port): {bad[:8]}')
    module.load_state_dict(sd, strict=False)
    return module


def load_jax_variables(module, variables):
    """Load converted JAX variables into ``module`` strictly
    (:func:`load_state_dict_strict`)."""
    return load_state_dict_strict(module, jax_to_state_dict(variables))


def _sgd_trace(opt_state):
    """The ``trace`` tree of optax's momentum inside a (possibly nested,
    possibly hyperparameter-injected) optimizer state, or None."""
    trace = getattr(opt_state, 'trace', None)
    if isinstance(trace, Mapping):       # optax's TraceState, not ndarray's
        return trace
    children = (opt_state if isinstance(opt_state, (tuple, list))
                else [getattr(opt_state, 'inner_state', None)])
    for child in children:
        if child is not None:
            found = _sgd_trace(child)
            if found is not None:
                return found
    return None


def load_jax_detector_state(state, jax_state):
    """Carry a JAX ``DetTrainState`` (its leaves on the host, e.g. through
    ``jax.device_get``) into the port's ``DetTrainState`` in place: the
    weights and batch statistics by the key mapping above, ``balance``,
    the SGD momentum (optax's ``trace``) as each parameter's
    ``momentum_buffer``, ``step`` and, where both keep one, the EMA."""
    load_jax_variables(state.model, {'params': jax_state.params,
                                     'batch_stats': jax_state.batch_stats})
    dev = state.step.device
    with torch.no_grad():
        for k, p in state.balance.items():
            p.copy_(torch.tensor(np.asarray(jax_state.balance[k],
                                            np.float32)))
        state.step.fill_(int(np.asarray(jax_state.step)))
        trace = _sgd_trace(jax_state.opt_state)
        if trace is not None:
            buffers = jax_to_state_dict({'params': trace['model']})
            for k, p in state.model.named_parameters():
                state.optimizer.state[p]['momentum_buffer'] = \
                    buffers[k].to(p)
            for k, p in state.balance.items():
                state.optimizer.state[p]['momentum_buffer'] = torch.tensor(
                    np.asarray(trace['balance'][k], np.float32)).to(p)
        ema = getattr(jax_state, 'ema_params', None)
        if ema is not None and state.ema_params is not None:
            for k, v in jax_to_state_dict({'params': ema}).items():
                state.ema_params[k].copy_(v)
    return state
