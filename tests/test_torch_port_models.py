"""Parity of the port's models with the JAX package (f32, CPU).

Each model gets the same flax-initialised, perturbed weights through the
weight bridge and the same numpy inputs.  Tolerance: rtol = atol = 1e-4 on
every output, an f32 reordering margin for nets of this depth."""

import glob
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet3d.core import AttrDict
from tpudet3d.core import read_py_config as jax_read_py_config
from tpudet3d.detect import SSDDetector as JaxSSD
from tpudet3d.models import build_model as jax_build_model
from tpudet3d.models.mobilenetv2 import MobileNetV2 as JaxMNv2

from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.infer import build_engine
from tpudet3d_torch.models import MobileNetV2, build_model
from tpudet3d_torch.utils.convert import jax_to_state_dict, load_jax_variables
from torch_port_common import (flax_init, np_out, one_cpu_thread, perturb,
                               port_of, set_no_tf32, to_jax)

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = sorted(glob.glob(osp.join(osp.dirname(osp.dirname(
    osp.abspath(__file__))), 'configs', 'scene_regressor*.py')))
REGRESSORS = ['mobilenetv3_large', 'mobilenetv3_small',
              'mobilenetv3_large_21k']
# backbones of the port alone: class name and feature width
PORT_ONLY = {'swin_tiny_patch4_window7_224': ('SwinTransformer', 768)}
# EfficientNet-lite at an even and (lite0) an odd input size, where the
# stride-2 5x5 depthwise convs' symmetric padding shows
LITE_CASES = [('efficientnet-lite0', 64), ('efficientnet-lite0', 65),
              ('efficientnet-lite1', 64), ('efficientnet-lite2', 64)]


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


def _reg_cfg(name):
    return AttrDict(model=dict(name=name, pretrained=False, num_classes=9,
                               bf16=False))


@pytest.fixture(scope='module')
def regressors():
    """name → (flax module, perturbed numpy variables), built once."""
    out = {}
    key = jax.random.PRNGKey(0)
    for i, name in enumerate(REGRESSORS):
        model = jax_build_model(_reg_cfg(name))
        v = flax_init(model, jnp.zeros((1, 64, 64, 3), jnp.float32),
                      jnp.zeros((1,), jnp.int32),
                      rngs={'params': key, 'dropout': key})
        out[name] = (model, perturb(v, seed=i))
    return out


def test_mnv2_trunk():
    model = JaxMNv2(width_mult=0.25, out_stages=(4, 6))
    x = np.random.RandomState(0).uniform(0, 1, (2, 128, 128, 3)) \
        .astype(np.float32)
    v = perturb(flax_init(model, jnp.asarray(x[:1])))
    ref = model.apply(to_jax(v), jnp.asarray(x))
    port = port_of(MobileNetV2(width_mult=0.25, out_stages=(4, 6)), v)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [o.shape[1] for o in out] == [24, 80]
    for r, o in zip(ref, out):
        np.testing.assert_allclose(np_out(o.permute(0, 2, 3, 1)),
                                   np.asarray(r), **TOL)


@pytest.mark.parametrize('cascade', [False, True], ids=['plain', 'cascade'])
def test_ssd(cascade):
    model = JaxSSD(num_classes=9, width_mult=0.25, cascade=cascade)
    x = np.random.RandomState(1).uniform(0, 1, (2, 300, 300, 3)) \
        .astype(np.float32)
    v = perturb(flax_init(model, jnp.asarray(x[:1])), seed=1)
    ref_logits, ref_deltas = model.apply(to_jax(v), jnp.asarray(x))
    port = port_of(SSDDetector(num_classes=9, width_mult=0.25,
                               cascade=cascade), v)
    with torch.no_grad():
        logits, deltas = port(torch.from_numpy(x))
    assert logits.shape == (2, 2044, 10) and deltas.shape == (2, 2044, 4)
    np.testing.assert_allclose(np_out(logits), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(np_out(deltas), np.asarray(ref_deltas), **TOL)


@pytest.mark.parametrize('name', REGRESSORS)
def test_mnv3_backbone(regressors, name):
    model, v = regressors[name]
    sub = {c: v[c]['backbone'] for c in v}
    x = np.random.RandomState(2).standard_normal((2, 64, 64, 3)) \
        .astype(np.float32)
    ref = model.backbone.apply(to_jax(sub), jnp.asarray(x))
    port = port_of(build_model(_reg_cfg(name)).backbone, sub)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(np_out(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize('name', REGRESSORS)
def test_regressor_export(regressors, name):
    model, v = regressors[name]
    x = np.random.RandomState(3).standard_normal((3, 64, 64, 3)) \
        .astype(np.float32)
    ref_kp, ref_logits = model.apply(to_jax(v), jnp.asarray(x), export=True)
    port = port_of(build_model(_reg_cfg(name)), v)
    with torch.no_grad():
        kp, logits = port(torch.from_numpy(x))
    assert kp.shape == (9, 3, 9, 2) and logits.shape == (3, 9)
    np.testing.assert_allclose(np_out(kp), np.asarray(ref_kp), **TOL)
    np.testing.assert_allclose(np_out(logits), np.asarray(ref_logits), **TOL)


def test_convert_layouts(regressors):
    """Layouts of each leaf kind, by path."""
    _, v = regressors['mobilenetv3_large']
    sd = jax_to_state_dict(v)
    p = v['params']['backbone']
    k = p['blocks_4']['ConvBN_1']['Conv_0']['kernel']              # dw 5x5
    np.testing.assert_array_equal(
        sd['backbone.blocks_4.ConvBN_1.Conv_0.weight'].numpy(),
        k.transpose(3, 2, 0, 1))
    assert sd['backbone.blocks_4.ConvBN_1.Conv_0.weight'].shape[1] == 1
    d = p['blocks_4']['SqueezeExcite_0']['Dense_0']['kernel']
    np.testing.assert_array_equal(
        sd['backbone.blocks_4.SqueezeExcite_0.Dense_0.weight'].numpy(), d.T)
    bs = v['batch_stats']['backbone']['head_bn']
    np.testing.assert_array_equal(sd['backbone.head_bn.running_var'].numpy(),
                                  bs['var'])
    np.testing.assert_array_equal(sd['backbone.head_bn.weight'].numpy(),
                                  p['head_bn']['scale'])
    np.testing.assert_array_equal(sd['head_kernel'].numpy(),
                                  v['params']['head_kernel'])


def test_convert_rejects_unmatched_keys(regressors):
    """A key left over on either side fails the load."""
    _, v = regressors['mobilenetv3_small']
    port = build_model(_reg_cfg('mobilenetv3_small'))
    extra = {c: dict(v[c]) for c in v}
    extra['params']['stray'] = {'kernel': np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match='stray'):
        load_jax_variables(port, extra)
    missing = {c: dict(v[c]) for c in v}
    del missing['params']['cls_fc']
    with pytest.raises(KeyError, match='cls_fc'):
        load_jax_variables(port, missing)
    wrong = {c: dict(v[c]) for c in v}
    wrong['params']['head_bias'] = np.zeros((9, 17), np.float32)
    with pytest.raises(ValueError, match='head_bias'):
        load_jax_variables(port, wrong)


@pytest.mark.parametrize('name,size', LITE_CASES,
                         ids=[f'{n[-5:]}-{s}' for n, s in LITE_CASES])
def test_efficientnet_lite(name, size):
    """The whole regressor on an EfficientNet-lite backbone: export outputs
    against ``flax.apply``, with the weights loaded by the strict key match
    (every Flax leaf has a port key and the reverse)."""
    model = jax_build_model(_reg_cfg(name))
    key = jax.random.PRNGKey(0)
    v = perturb(flax_init(model, jnp.zeros((1, size, size, 3), jnp.float32),
                          jnp.zeros((1,), jnp.int32),
                          rngs={'params': key, 'dropout': key}), seed=5)
    x = np.random.RandomState(4).standard_normal((2, size, size, 3)) \
        .astype(np.float32)
    ref_kp, ref_logits = model.apply(to_jax(v), jnp.asarray(x), export=True)
    port = build_model(_reg_cfg(name))
    assert port.backbone.feature_dim == 1280
    sd = jax_to_state_dict(v)
    own = {k for k in port.state_dict() if not k.endswith(
        'num_batches_tracked')}
    assert own == set(sd), sorted(own ^ set(sd))[:8]
    port_of(port, v)
    with torch.no_grad():
        kp, logits = port(torch.from_numpy(x))
    np.testing.assert_allclose(np_out(kp), np.asarray(ref_kp), **TOL)
    np.testing.assert_allclose(np_out(logits), np.asarray(ref_logits), **TOL)


@pytest.mark.parametrize('path', CONFIGS, ids=[osp.basename(p)[:-3]
                                               for p in CONFIGS])
def test_build_engine_accepts_every_regressor_config(path, tmp_path,
                                                     monkeypatch):
    """Every regressor config builds its engine (random weights: run where
    the configs' output directories do not exist) with the config's
    backbone and crop size, as the JAX package's builder does; a backbone
    of the port's own (Swin-T), which the JAX package lacks, as the
    port's builder names it."""
    monkeypatch.chdir(tmp_path)
    engine = build_engine(path, device='cpu')
    cfg = jax_read_py_config(path)
    if cfg.model.name in PORT_ONLY:
        assert type(engine.reg_model.backbone).__name__ == \
            PORT_ONLY[cfg.model.name][0]
        assert engine.reg_model.backbone.feature_dim == \
            PORT_ONLY[cfg.model.name][1]
    else:
        jax_backbone = jax_build_model(cfg).backbone
        assert type(engine.reg_model.backbone).__name__ == \
            type(jax_backbone).__name__
        assert engine.reg_model.backbone.feature_dim == 1280
    assert engine.cfg.crop_size == tuple(cfg.data.resize)
    assert engine.reg_model.dtype == torch.bfloat16
