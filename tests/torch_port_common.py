"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

The same numpy weights and inputs go to the JAX package and to the port.
Weights come from ``flax.init`` and are perturbed with a numpy seed (batch
norm statistics and every bias), so that the conversion of each leaf kind
is exercised; the port loads them through ``utils/convert.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import unfreeze

from tpudet3d_torch.utils.convert import load_jax_variables

_PERTURB = {
    'scale': lambda rng, s: rng.uniform(0.5, 1.5, s),
    'bias': lambda rng, s: rng.normal(0.0, 0.1, s),
    'head_bias': lambda rng, s: rng.normal(0.0, 0.1, s),
    'mean': lambda rng, s: rng.normal(0.0, 0.1, s),
    'var': lambda rng, s: rng.uniform(0.5, 1.5, s),
}


def flax_init(model, *args, rngs=None):
    """Variables of ``model`` as numpy trees (jitted init: fast on CPU)."""
    rngs = rngs if rngs is not None else jax.random.PRNGKey(0)
    variables = jax.jit(model.init)(rngs, *args)
    return jax.tree_util.tree_map(np.asarray, unfreeze(variables))


def perturb(variables, seed=0):
    """Random batch-norm statistics, scales and biases (numpy seed)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _PERTURB:
                out[k] = _PERTURB[k](rng, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(variables)


def to_jax(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def port_of(module, variables):
    """``module`` (f32, eval, CPU) with the JAX variables loaded."""
    return load_jax_variables(module.float().eval(), variables)


def np_out(t):
    return t.detach().float().cpu().numpy()


def set_no_tf32():
    """f32 comparisons run without TF32 anywhere."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def one_cpu_thread():
    """PyTorch's CPU elementwise ops compute a chunk's tail without SIMD,
    and where the chunks fall depends on the thread count, so a result can
    move by an ulp with it (an exact score tie can split).  One thread
    fixes the chunks, and keeps test workers from oversubscribing cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
