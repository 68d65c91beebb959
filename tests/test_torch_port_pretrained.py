"""Reference checkpoint import of the port (``utils/torch_import.py``,
``utils/pretrained_contract.py``, ``tools/check_pretrained.py``) against
the JAX package: a seeded checkpoint laid out to each pinned contract
loads into the port bit for bit as it loads into the JAX package's model
through ``utils/convert.py``; drift is refused; loading without a
contract stays tolerant; the checker's verdicts equal
``scripts/check_pretrained.py``'s; ``setup_training`` with
``pretrained=True`` loads the file."""

import importlib.util
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import REPO, config_file

from tpudet3d.models import build_backbone as jax_backbone
from tpudet3d.utils import pretrained_contract as jax_pc
from tpudet3d.utils.torch_import import \
    load_torch_checkpoint_into as jax_load
from tpudet3d_torch.models import build_backbone
from tpudet3d_torch.tools import check_pretrained
from tpudet3d_torch.utils import pretrained_contract as pc
from tpudet3d_torch.utils.convert import jax_to_state_dict, load_jax_variables
from tpudet3d_torch.utils.torch_import import load_torch_checkpoint_into

# (model, contract kind, classes): every pinned contract
CASES = (('mobilenetv3_large_21k', 'timm', 11221),
         ('mobilenetv3_large_21k', 'timm', 1000),
         ('mobilenetv3_large', 'dli14', None),
         ('mobilenetv3_small', 'dli14', None),
         ('efficientnet-lite0', 'lite', None),
         ('efficientnet-lite1', 'lite', None),
         ('efficientnet-lite2', 'lite', None))


def fake_state_dict(contract, seed=0):
    """Seeded random tensors with exactly the contract's layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, shape in contract:
        if key.endswith('num_batches_tracked'):
            sd[key] = torch.tensor(10, dtype=torch.int64)
        elif key.endswith('running_var'):
            sd[key] = torch.rand(shape, generator=g) + 0.5
        else:
            sd[key] = torch.randn(shape, generator=g) * 0.05
    return sd


def _save(sd, path):
    torch.save({'state_dict': sd}, path)
    return str(path)


def _zero_variables(name):
    """The JAX backbone's variables, zeros, from shapes alone (no
    compilation), so the tensors the import leaves alone agree too."""
    shapes = jax.eval_shape(jax_backbone(name).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  dict(shapes))


def test_contract_copies_and_checksums():
    assert pc.contract_param_count(pc.timm_mobilenetv3_large_100()) == \
        pc.PARAM_COUNTS['timm_mobilenetv3_large_100'] == 5_483_032
    assert pc.contract_param_count(pc.efficientnet_lite('efficientnet-lite0')) \
        == pc.PARAM_COUNTS['efficientnet-lite0'] == 4_652_008
    for model, kind, nc in CASES:
        assert check_pretrained.get_contract(model, kind, nc) == \
            jax_pc_contract(model, kind, nc)


def jax_pc_contract(model, kind, nc):
    if kind == 'dli14':
        return jax_pc.dli14_mobilenetv3(model.rsplit('_', 1)[-1])
    if kind == 'timm':
        return jax_pc.timm_mobilenetv3_large_100(nc)
    return jax_pc.efficientnet_lite(model)


@pytest.mark.parametrize('model,kind,nc', CASES,
                         ids=[f'{m}-{k}{n or ""}' for m, k, n in CASES])
def test_contract_checkpoint_loads_like_jax(tmp_path, model, kind, nc):
    contract = check_pretrained.get_contract(model, kind, nc)
    path = _save(fake_state_dict(contract, seed=len(contract)),
                 tmp_path / 'ckpt.pth')
    allow = check_pretrained.ALLOW_UNUSED[kind]
    v = _zero_variables(model)
    jrep, rep = {}, {}
    params, stats = jax_load(v['params'], v['batch_stats'], path,
                             verbose=False, contract=contract,
                             allow_unused=allow, report=jrep)
    ref = jax_to_state_dict({'params': jax.device_get(params),
                             'batch_stats': jax.device_get(stats)})
    port = load_jax_variables(build_backbone(model), v)
    load_torch_checkpoint_into(port, path, verbose=False, contract=contract,
                               allow_unused=allow, report=rep)
    assert rep == jrep
    sd = port.state_dict()
    for k, r in ref.items():
        assert torch.equal(sd[k], r), k
    assert rep['matched'] > 0.9 * len(ref)


def test_drift_is_refused(tmp_path):
    contract = pc.dli14_mobilenetv3('small')
    sd = fake_state_dict(contract)
    key = 'features.3.conv.0.weight'
    sd[key] = torch.zeros(sd[key].shape[0] + 8, *sd[key].shape[1:])
    path = _save(sd, tmp_path / 'drift.pth')
    port = build_backbone('mobilenetv3_small')
    with pytest.raises(RuntimeError, match='contract'):
        load_torch_checkpoint_into(port, path, contract=contract,
                                   allow_unused=('classifier',))
    # order drift too
    sd = fake_state_dict(contract)
    items = list(sd.items())
    items[0], items[5] = items[5], items[0]
    path = _save(dict(items), tmp_path / 'order.pth')
    with pytest.raises(RuntimeError, match='order_ok=False'):
        load_torch_checkpoint_into(port, path, contract=contract)
    # a contracted load that leaves a tensor unused and not allowed
    path = _save(fake_state_dict(contract), tmp_path / 'ok.pth')
    with pytest.raises(RuntimeError, match='unconsumed'):
        load_torch_checkpoint_into(port, path, contract=contract)


def test_without_contract_is_tolerant(tmp_path, capsys):
    contract = pc.dli14_mobilenetv3('small')
    sd = fake_state_dict(contract)
    sd['extra.head.weight'] = torch.ones(3, 5)
    sd['features.1.conv.0.weight'] = torch.ones(7, 1, 3, 3)   # wrong shape
    path = _save(sd, tmp_path / 'loose.pth')
    v = _zero_variables('mobilenetv3_small')
    jrep, rep = {}, {}
    params, stats = jax_load(v['params'], v['batch_stats'], path,
                             verbose=False, report=jrep)
    port = load_jax_variables(build_backbone('mobilenetv3_small'), v)
    load_torch_checkpoint_into(port, path, report=rep)
    assert 'unused torch tensors' in capsys.readouterr().out
    assert rep == jrep and 'extra.head.weight' in rep['leftovers']
    ref = jax_to_state_dict({'params': jax.device_get(params),
                             'batch_stats': jax.device_get(stats)})
    for k, r in ref.items():
        assert torch.equal(port.state_dict()[k], r), k
    with pytest.raises(RuntimeError, match='no torch tensors'):
        load_torch_checkpoint_into(port, _save({'x': torch.ones(2)},
                                               tmp_path / 'none.pth'))


def _jax_check_pretrained(monkeypatch, *args):
    spec = importlib.util.spec_from_file_location(
        'jax_check_pretrained', osp.join(REPO, 'scripts', 'check_pretrained.py'))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, 'argv', ['check_pretrained.py', *args])
    try:
        return script.main()
    except RuntimeError:
        return 'raised'


def _port_check_pretrained(*args):
    try:
        return check_pretrained.main([*args, '--device', 'cpu'])
    except RuntimeError:
        return 'raised'


def test_check_pretrained_verdicts_match_jax(tmp_path, monkeypatch, capsys):
    contract = pc.dli14_mobilenetv3('small')
    good = _save(fake_state_dict(contract), tmp_path / 'good.pth')
    sd = fake_state_dict(contract)
    sd['conv.0.weight'] = torch.zeros(8, 96, 1, 1)
    drifted = _save(sd, tmp_path / 'drifted.pth')
    prefixed = _save({f'module.{k}': v for k, v in
                      fake_state_dict(contract).items()},
                     tmp_path / 'prefixed.pth')
    cases = (('--ckpt', good), ('--ckpt', drifted),
             ('--ckpt', prefixed), ('--ckpt', prefixed, '--strip_prefix',
                                    'module.'))
    verdicts = []
    for case in cases:
        args = ('--model', 'mobilenetv3_small', *case)
        verdicts.append((_port_check_pretrained(*args),
                         _jax_check_pretrained(monkeypatch, *args)))
    assert verdicts == [(0, 0), (1, 1), (1, 1), (0, 0)], verdicts
    assert 'strict import: OK' in capsys.readouterr().out


def test_setup_training_loads_the_pretrained_file(tmp_path, monkeypatch,
                                                  capsys):
    from tpudet3d_torch.core import read_py_config
    from tpudet3d_torch.train.pipeline import setup_training
    contract = pc.dli14_mobilenetv3('small')
    sd = fake_state_dict(contract, seed=3)
    _save(sd, tmp_path / 'mobilenetv3_small.pth')
    monkeypatch.setenv('TPUDET3D_PRETRAINED_DIR', str(tmp_path))
    cfg = read_py_config(config_file(
        tmp_path / 'cfg.py', 'default_config.py',
        "model.update(name='mobilenetv3_small', pretrained=True, bf16=False)",
        "optim['ema_decay'] = 0.9", "data['resize'] = (32, 32)"))
    pipe = setup_training(cfg, device='cpu', with_loaders=False)
    assert 'torch import: matched' in capsys.readouterr().out
    model = pipe.state.model
    assert torch.equal(model.backbone.blocks_0.Conv_0.weight,
                       sd['features.0.0.weight'])
    # the same tensors as a direct import into a fresh backbone
    ref = build_backbone('mobilenetv3_small')
    load_torch_checkpoint_into(ref, str(tmp_path / 'mobilenetv3_small.pth'),
                               verbose=False)
    own = model.backbone.state_dict()
    for k, v in ref.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(own[k], v), k
    # the EMA restarts from the loaded weights
    for k, p in model.named_parameters():
        assert torch.equal(pipe.state.ema_params[k], p), k
