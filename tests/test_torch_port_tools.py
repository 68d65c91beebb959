"""The port's tools against the JAX package's: the HPO study
(``utils/hpo.py``), the complexity CLI (``tools/get_complexity.py``), the
profiling hooks (``utils/profiling.py``) and the sweep CLI
(``tools/optuna_optim.py``), on the CPU."""

import json
import math
import os
import random

import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from torch_port_common import REPO, config_file

from tpudet3d.models import build_model as jax_build_model
from tpudet3d.train import param_count as jax_param_count
from tpudet3d.utils import hpo as jax_hpo
from tpudet3d_torch.core import read_py_config
from tpudet3d_torch.models import build_model
from tpudet3d_torch.tools import get_complexity, optuna_optim
from tpudet3d_torch.utils import hpo, profiling

# XLA's cost analysis counts the elementwise work too (batch norm,
# activations, pooling, the sigmoid) but counts its convolutions its own
# way, so its flops/2 and the port's multiply-accumulates part by a few
# percent: at 64², 1.009 (MNv3-large-21k) and 0.986 (el0) of them
XLA_GAP = 0.05


def _sweep(module, seed):
    """A study of 6 trials with every suggestion kind; the objective
    reports 3 steps and prunes by the median rule."""
    study = module.create_study(direction='minimize', prefer_optuna=False,
                                seed=seed)

    def objective(trial):
        x = trial.suggest_float('x', 0.01, 3)
        lr = trial.suggest_float('lr', 1e-4, 1e-1, log=True)
        n = trial.suggest_int('n', 1, 4)
        act = trial.suggest_categorical('act', ['relu', 'hswish'])
        value = 0.0
        for step in range(3):
            value = (x - 1) ** 2 + n * lr + (act == 'relu') + 0.1 * step
            trial.report(value, step)
            if trial.should_prune():
                raise module.TrialPruned()
        return value

    study.optimize(objective, n_trials=6)
    return ([(t.params, t.state, t.value) for t in study.trials],
            study.best_trial.params)


@pytest.mark.parametrize('seed', [0, 7])
def test_hpo_proposes_and_prunes_as_jax(seed):
    state = random.getstate()
    try:
        ours = _sweep(hpo, seed)
        ref = _sweep(jax_hpo, seed)
    finally:
        random.setstate(state)
    assert ours == ref
    assert {s for _, s, _ in ours[0]} >= {'COMPLETE'}


def _analytic_macs(model, x):
    """Multiply-accumulates of every convolution (seen through the
    models' conv hook: output pixels × kernel volume), every linear layer
    (each applied once to the pooled rows) and the heads' product."""
    from tpudet3d_torch.models import layers
    convs = []

    def count(inp, layer):
        h, w = inp.shape[2:]
        (kh, kw), (sh, sw), (ph, pw) = (layer.kernel_size, layer.stride,
                                        layer.padding)
        oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
        convs.append(inp.shape[0] * oh * ow * layer.out_channels
                     * layer.weight[0].numel())

    layers.conv_hook.fn = count
    try:
        with torch.no_grad():
            model(x)
    finally:
        layers.conv_hook.fn = None
    dense = sum(m.in_features * m.out_features for m in model.modules()
                if isinstance(m, nn.Linear))
    c, k, p = model.head_kernel.shape
    return sum(convs) + x.shape[0] * (dense + k * c * p)


@pytest.mark.parametrize('config', ['scene_regressor.py',
                                    'scene_regressor_el0.py'])
def test_complexity_matches_jax(config, capsys):
    path = os.path.join(REPO, 'configs', config)
    res = get_complexity.main(['--config', path, '--device', 'cpu'])
    text = capsys.readouterr().out
    assert 'FlopCounterMode' in text and f'{res["params"]:,}' in text
    cfg = read_py_config(path)
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    shape = (1, *cfg.data.resize, 3)
    key = jax.random.PRNGKey(0)
    v = jax.eval_shape(jmodel.init, {'params': key, 'dropout': key},
                       jnp.zeros(shape), jnp.zeros((1,), jnp.int32))
    assert res['params'] == jax_param_count(v['params'])
    model = build_model(cfg, dtype=torch.float32)
    assert res['macs'] == _analytic_macs(model, torch.zeros(shape))


@pytest.mark.parametrize('config', ['scene_regressor.py',
                                    'scene_regressor_el0.py'])
def test_complexity_gap_under_xla(config):
    """At 64² (a small compile): XLA's flops/2 against the port's MACs."""
    cfg = read_py_config(os.path.join(REPO, 'configs', config))
    cfg.data.resize = (64, 64)
    res = get_complexity.complexity(cfg, 'cpu')
    jmodel = jax_build_model(cfg, dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3))
    key = jax.random.PRNGKey(0)
    v = jax.jit(jmodel.init)({'params': key, 'dropout': key}, x,
                             jnp.zeros((1,), jnp.int32))
    cost = jax.jit(lambda img: jmodel.apply(v, img, export=True)) \
        .lower(x).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    ratio = cost['flops'] / 2 / res['macs']
    assert abs(ratio - 1.0) <= XLA_GAP, ratio


def test_profiling_on_cpu(tmp_path):
    lin = nn.Linear(16, 8)
    x = torch.randn(4, 16)
    assert profiling.flops_of(lin, x) == 2 * 4 * 16 * 8
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate('port-step'):
            lin(x).relu().sum()
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get('name') for e in events['traceEvents']}
    assert 'port-step' in names and any('addmm' in str(n) for n in names)
    assert prof.key_averages()


def test_optuna_optim_runs_two_trials(tmp_path, capsys):
    cfg = config_file(
        tmp_path / 'sweep.py', 'default_config.py',
        "data.update(resize=(32, 32), train_batch_size=8, val_batch_size=8, "
        "synthetic=True, synthetic_length=32, num_workers=2)",
        "model.update(name='mobilenetv3_small', pretrained=False, "
        "bf16=False)",
        "loss['names'] = ['wing', 'cross_entropy']",
        "loss['coeffs'] = ([1.], [1.])",
        f"output_dir = {str(tmp_path / 'out')!r}")
    study = optuna_optim.main(['--config', cfg, '-e', '1', '--n_trials', '2',
                               '--n_training_iterations', '0.5',
                               '--n_validate_iterations', '0.5',
                               '--device', 'cpu'])
    text = capsys.readouterr().out
    assert len(study.trials) == 2 and 'Best trial:' in text
    for t in study.trials:
        assert t.state == 'COMPLETE' and math.isfinite(t.value)
        assert set(t.params) == {'eps', 'w'}
    assert any(f.startswith('optuna.log-')
               for f in os.listdir(tmp_path / 'out'))
