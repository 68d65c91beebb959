"""Serving from trained snapshots: the JAX package writes orbax snapshots
(``utils/checkpoint.py`` ``save_snap``), ``scripts/snapshot_to_torch.py``
converts them, and the port serves them (CPU, float32).

- Detector (SSD width 0.25, cascade off and on, with and without an EMA
  that differs from the raw weights): the port's ``load_detector`` finds
  the JAX loader's cascade flag and width, and its logits and deltas match
  the JAX ``load_detector`` + ``apply`` within rtol = atol = 1e-4 (the
  models' tolerance in tests/test_torch_port_models.py).
- Regressor (EfficientNet-lite0 at 64² crops): for a config with EMA on
  and off, crossed with a snapshot with and without EMA, the state_dict
  that ``build_engine`` serves equals exactly ``jax_to_state_dict`` of
  ``eval_params(resume_from(...))`` and the snapshot's batch statistics,
  which ``scripts/demo.py`` serves.
- A truncated file, a snapshot under another backbone's config, and an
  orbax snapshot without its converted file raise; ``latest_snapshot``
  orders epochs by number.
"""

import os
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudet3d.core import read_py_config as jax_read_py_config
from tpudet3d.detect import SSDDetector as JaxSSD
from tpudet3d.detect import load_detector as jax_load_detector
from tpudet3d.detect.train import create_detector_state
from tpudet3d.train.pipeline import setup_training
from tpudet3d.train.state import eval_params
from tpudet3d.utils.checkpoint import resume_from, save_snap

from tpudet3d_torch.detect import load_detector
from tpudet3d_torch.infer import build_engine
from tpudet3d_torch.utils.checkpoint import (latest_snapshot, load_converted,
                                             resolve_converted,
                                             save_converted)
from tpudet3d_torch.utils.convert import jax_to_state_dict
from torch_port_common import (REPO, config_file, np_out, one_cpu_thread,
                               set_no_tf32)

sys.path.insert(0, osp.join(REPO, 'scripts'))
import snapshot_to_torch  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


def _shifted(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, scale, np.shape(x))
        .astype(np.float32), jax.device_get(tree))


def _stats(tree, rng):
    """Random batch statistics: means around 0, variances in [0.5, 1.5]."""
    def one(path, x):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
        return rng.normal(0, 0.1, np.shape(x)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, jax.device_get(tree))


def _trained(state, seed, ema):
    """``state`` with its weights, batch statistics and (with ``ema``) an
    average that differs from the weights, all moved off their init."""
    rng = np.random.RandomState(seed)
    params = _shifted(state.params, rng, 0.02)
    return state.replace(
        params=params, batch_stats=_stats(state.batch_stats, rng),
        ema_params=_shifted(params, rng, 0.02) if ema else None)


def _served(module):
    return {k: v for k, v in module.state_dict().items()
            if not k.endswith('num_batches_tracked')}


# --- the detector --------------------------------------------------------

DET_CASES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize('cascade,ema', DET_CASES,
                         ids=[f'{"cascade" if c else "plain"}-'
                              f'{"ema" if e else "noema"}'
                              for c, e in DET_CASES])
def test_detector_snapshot_roundtrip(tmp_path, cascade, ema):
    model = JaxSSD(num_classes=9, width_mult=0.25, cascade=cascade)
    state = create_detector_state(model, optax.sgd(0.1),
                                  jax.random.PRNGKey(0),
                                  ema_decay=0.9 if ema else 0.0)
    save_snap(_trained(state, 3 + 2 * cascade + ema, ema), 4, str(tmp_path))
    snap = str(tmp_path / 'snap_4')
    with pytest.raises(FileNotFoundError, match='snapshot_to_torch.py'):
        load_detector(snap, dtype=torch.float32, device='cpu')
    out, = snapshot_to_torch.main([snap])
    assert out == snap + '.pt'
    conv = load_converted(out, kind='detector')
    assert conv['epoch'] == 4 and (conv['ema_params'] is not None) == ema

    ref_model, ref_vars = jax_load_detector(snap, dtype=jnp.float32)
    port = load_detector(snap, dtype=torch.float32, device='cpu')
    assert port.cascade == ref_model.cascade == cascade
    assert port.width_mult == ref_model.width_mult == 0.25
    x = np.random.RandomState(5).uniform(0, 1, (2, 300, 300, 3)) \
        .astype(np.float32)
    ref_logits, ref_deltas = ref_model.apply(ref_vars, jnp.asarray(x))
    with torch.no_grad():
        logits, deltas = port(torch.from_numpy(x))
    np.testing.assert_allclose(np_out(logits), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(np_out(deltas), np.asarray(ref_deltas), **TOL)
    # the engine serves the same weights (the EMA when there is one)
    engine = build_engine(det_checkpoint=out, device='cpu')
    want = jax_to_state_dict(jax.device_get(ref_vars))
    got = _served(engine.det_model)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k


# --- the regressor -------------------------------------------------------

def _config(tmp_path, name, ema, backbone='scene_regressor_el0.py'):
    """``configs/<backbone>`` at 64² crops and batch 2, with
    ``optim.ema_decay`` 0.99 or 0 and its output under ``tmp_path``."""
    return config_file(
        tmp_path / f'{name}.py', backbone, "data['resize'] = (64, 64)",
        "data['train_batch_size'] = 2",
        f"optim['ema_decay'] = {0.99 if ema else 0.0}",
        f'output_dir = {str(tmp_path / ("out_" + name))!r}')


@pytest.fixture(scope='module')
def regressor_snaps(tmp_path_factory):
    """Configs with EMA on and off, their JAX template states, and one
    converted el0 snapshot per config (each under its own output_dir)."""
    root = tmp_path_factory.mktemp('reg')
    out = {}
    for ema in (True, False):
        cfg_path = _config(root, f'ema{int(ema)}', ema)
        cfg = jax_read_py_config(cfg_path)
        state = setup_training(cfg, with_loaders=False).state
        assert (state.ema_params is not None) == ema
        save_snap(_trained(state, 7 + ema, ema), 3, cfg.output_dir)
        snapshot_to_torch.main(['--all', cfg.output_dir])
        out[ema] = (cfg_path, state, osp.join(cfg.output_dir, 'snap_3'))
    return out


REG_CASES = [(c, s) for c in (True, False) for s in (True, False)]


@pytest.mark.parametrize('cfg_ema,snap_ema', REG_CASES,
                         ids=[f'config{"EMA" if c else "Plain"}-'
                              f'snapshot{"EMA" if s else "Plain"}'
                              for c, s in REG_CASES])
def test_regressor_ema_policy_matches_jax(regressor_snaps, cfg_ema,
                                          snap_ema):
    cfg_path, template, _ = regressor_snaps[cfg_ema]
    snap = regressor_snaps[snap_ema][2]
    restored, _ = resume_from(template, snap)
    want = jax_to_state_dict({
        'params': jax.device_get(eval_params(restored)),
        'batch_stats': jax.device_get(restored.batch_stats)})
    engine = build_engine(cfg_path, reg_checkpoint=snap, device='cpu')
    assert type(engine.reg_model.backbone).__name__ == 'EfficientNetLite'
    assert engine.cfg.crop_size == (64, 64)
    got = _served(engine.reg_model)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if cfg_ema == snap_ema:
        # without a reg_checkpoint: the newest snapshot of output_dir
        again = build_engine(cfg_path, device='cpu')
        for k in want:
            assert torch.equal(again.reg_model.state_dict()[k], want[k]), k


def test_regressor_snapshot_mismatch_raises(regressor_snaps, tmp_path):
    snap = regressor_snaps[True][2]
    other = _config(tmp_path, 'mnv3', False, 'scene_regressor.py')
    with pytest.raises(ValueError, match='does not match'):
        build_engine(other, reg_checkpoint=snap, device='cpu')
    with pytest.raises(ValueError, match='regressor snapshot, expected a '
                       'detector'):
        load_detector(snap, device='cpu')
    data = open(snap + '.pt', 'rb').read()
    bad = tmp_path / 'snap_5.pt'
    bad.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match='not a readable'):
        load_converted(str(bad))
    with pytest.raises(ValueError, match='not a readable'):
        build_engine(regressor_snaps[True][0], reg_checkpoint=str(bad),
                     device='cpu')


def test_latest_snapshot_selection(tmp_path):
    """Epochs by number; the newest orbax snapshot unconverted raises with
    the command that converts it; no snapshot gives None."""
    sd = {'w': torch.zeros(1)}
    assert latest_snapshot(str(tmp_path / 'missing')) is None
    assert latest_snapshot(str(tmp_path)) is None
    for epoch in (2, 9, 10):
        os.mkdir(tmp_path / f'snap_{epoch}')
        save_converted(str(tmp_path / f'snap_{epoch}.pt'), 'regressor',
                       epoch, sd)
    os.mkdir(tmp_path / 'snap_x')
    assert latest_snapshot(str(tmp_path)) == str(tmp_path / 'snap_10.pt')
    assert resolve_converted(str(tmp_path / 'snap_9')) == \
        str(tmp_path / 'snap_9.pt')
    os.mkdir(tmp_path / 'snap_11')
    cmd = f'python scripts/snapshot_to_torch.py {tmp_path / "snap_11"}'
    with pytest.raises(FileNotFoundError) as info:
        latest_snapshot(str(tmp_path))
    assert cmd in str(info.value)
    with pytest.raises(FileNotFoundError) as info:
        resolve_converted(str(tmp_path / 'snap_11'))
    assert cmd in str(info.value)
    cfg = tmp_path / 'cfg.py'
    cfg.write_text("model = dict(name='mobilenetv3_small', num_classes=9)\n"
                   f'output_dir = {str(tmp_path)!r}\n')
    with pytest.raises(FileNotFoundError, match='snapshot_to_torch.py'):
        build_engine(str(cfg), device='cpu')


def test_snapshot_kind():
    assert snapshot_to_torch.snapshot_kind({'head_kernel': 0}) == 'regressor'
    assert snapshot_to_torch.snapshot_kind({'cls_heads_0': 0}) == 'detector'
    with pytest.raises(ValueError, match='neither'):
        snapshot_to_torch.snapshot_kind({'backbone': 0})
    with pytest.raises(ValueError, match='kind'):
        save_converted('unused.pt', 'tracker', 0, {})
