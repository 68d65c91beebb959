"""The port's serving engine against the JAX ``TwoStageEngine`` (CPU, f32).

Both engines get the same frames and the same weights: an SSD at width 0.25
and the MNv3-large-21k regressor (EfficientNet-lite0 in the ``el0`` case) at
64² crops, max_detections 4.  The JAX
engine preprocesses in bf16 whatever the model dtype; for this f32
comparison its two preprocessing calls run with their f32 compute dtype
(``resize_bilinear(dtype=f32)``, ``crop_and_resize(compute_dtype=f32)``),
and the bf16 behaviour of each is held by tests/test_torch_port_ops.py.

Random-init detector scores sit near 0.1 for all classes, where float noise
reorders top-k and flips NMS.  The shared numpy weights therefore scale
the detector's class heads by 2 (with the perturbed batch norm of these
weights that spreads the kept scores over 0.6-0.7; larger factors saturate
them at 1.0) and the regressor's ``cls_fc`` by 20, and the test asserts
that kept scores and the top-2 class logits are more than 1e-3 apart
before it compares.
Tolerances on packed rows with score > 0: boxes 1e-2 px, scores 1e-5,
labels exact, keypoints 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudet3d.infer.engine as jax_engine_mod
from tpudet3d.core import AttrDict
from tpudet3d.detect import SSDDetector as JaxSSD
from tpudet3d.infer import EngineConfig as JaxEngineConfig
from tpudet3d.infer import TwoStageEngine as JaxEngine
from tpudet3d.models import build_model as jax_build_model
from tpudet3d.ops import image as jax_image

from tpudet3d_torch.core import AttrDict as PortAttrDict
from tpudet3d_torch.detect import SSDDetector, decode_detections
from tpudet3d_torch.infer import (EngineConfig, TwoStageEngine, refine_boxes,
                                  tta_flip_average)
from tpudet3d_torch.models import build_model
from tpudet3d_torch.ops import crop_and_resize, resize_bilinear
from torch_port_common import (flax_init, one_cpu_thread, perturb, port_of,
                               set_no_tf32)

DET_SCALE, REG_SCALE = 2.0, 20.0
CONFIGS = {
    'default': dict(),
    'soft_vote_refine_tta': dict(soft_nms_sigma=0.5, box_vote_iou=0.6,
                                 crop_margin_px=10.0, refine_passes=1,
                                 tta_flip=True),
    'el0': dict(),
}
# the regressor of each config; the default is the MNv3-large-21k of
# ``weights``
REGRESSOR = {'el0': 'efficientnet-lite0'}
BASE = dict(det_conf=0.0, max_detections=4, crop_size=(64, 64))


@pytest.fixture(scope='module')
def weights():
    det = JaxSSD(num_classes=9, width_mult=0.25)
    dv = perturb(flax_init(det, jnp.zeros((1, 300, 300, 3))), seed=11)
    for i in range(2):
        head = dv['params'][f'cls_heads_{i}']['Conv_0']
        head['kernel'] = head['kernel'] * DET_SCALE
        head['bias'] = head['bias'] * DET_SCALE
    return (det, dv) + regressor_weights('mobilenetv3_large_21k')


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


@pytest.fixture
def f32_jax_preprocess(monkeypatch):
    resize, crop = jax_image.resize_bilinear, jax_image.crop_and_resize
    monkeypatch.setattr(jax_engine_mod, 'resize_bilinear',
                        lambda img, hw, dtype=None: resize(img, hw,
                                                           jnp.float32))
    monkeypatch.setattr(jax_engine_mod, 'crop_and_resize',
                        lambda img, boxes, hw: crop(img, boxes, hw,
                                                    compute_dtype=jnp.float32))


def regressor_weights(name, seed=12):
    """Flax module and perturbed numpy variables of the regressor ``name``
    at 64² crops, ``cls_fc`` scaled by REG_SCALE."""
    key = jax.random.PRNGKey(0)
    cfg = AttrDict(model=dict(name=name, pretrained=False, num_classes=9,
                              bf16=False))
    reg = jax_build_model(cfg)
    rv = perturb(flax_init(reg, jnp.zeros((1, 64, 64, 3), jnp.float32),
                           jnp.zeros((1,), jnp.int32),
                           rngs={'params': key, 'dropout': key}), seed=seed)
    rv['params']['cls_fc']['kernel'] = (rv['params']['cls_fc']['kernel']
                                       * REG_SCALE)
    return reg, rv


@pytest.fixture(scope='module')
def el0_engines(weights):
    """The el0 engines, built once: the JAX engine keeps the programs it
    compiles (the slow part) across the tests of this module."""
    det, dv, _, _ = weights
    return _engines((det, dv) + regressor_weights('efficientnet-lite0',
                                                  seed=13), 'el0')


def _engines(weights, config):
    det, dv, reg, rv = weights
    kw = dict(BASE, **CONFIGS[config])
    jax_eng = JaxEngine(det, jax.tree_util.tree_map(jnp.asarray, dv), reg,
                        jax.tree_util.tree_map(jnp.asarray, rv),
                        JaxEngineConfig(**kw))
    port_det = port_of(SSDDetector(num_classes=9, width_mult=0.25), dv)
    port_reg = port_of(build_model(PortAttrDict(model=dict(
        name=REGRESSOR.get(config, 'mobilenetv3_large_21k'), num_classes=9,
        bf16=False))), rv)
    port_eng = TwoStageEngine(port_det, port_reg, EngineConfig(**kw),
                              device='cpu')
    return jax_eng, port_eng


def _capture_logits(engine, k, tta):
    """The class logits of the regressor's last call (TTA-averaged)."""
    seen = {}

    def hook(_, __, out):
        logits = out[1]
        seen['logits'] = (0.5 * (logits[:k] + logits[k:]) if tta
                          else logits).numpy()

    return seen, engine.reg_model.register_forward_hook(hook)


def _assert_separated(results, logits):
    for r in results:
        s = np.sort(r['scores'])
        assert len(s) > 0 and np.all(np.diff(s) > 1e-3), s
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3)


def _assert_results_match(out, ref):
    assert out['scores'].shape == ref['scores'].shape
    np.testing.assert_allclose(out['scores'], ref['scores'], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out['boxes'], ref['boxes'], rtol=0, atol=1e-2)
    np.testing.assert_array_equal(out['det_labels'], ref['det_labels'])
    np.testing.assert_array_equal(out['labels'], ref['labels'])
    np.testing.assert_allclose(out['kp'], ref['kp'], rtol=0, atol=1e-4)


@pytest.mark.parametrize('api', ['call', 'infer_batch'])
@pytest.mark.parametrize('config', list(CONFIGS))
def test_engine_matches_jax(request, weights, f32_jax_preprocess, config,
                            api):
    jax_eng, port_eng = (request.getfixturevalue('el0_engines')
                         if config == 'el0' else _engines(weights, config))
    frames = np.random.RandomState(7).randint(0, 256, (2, 360, 640, 3)) \
        .astype(np.uint8)
    counts = [resize_bilinear.launches, crop_and_resize.launches,
              decode_detections.launches]
    n = 1 if api == 'call' else 2
    seen, handle = _capture_logits(port_eng, n * 4, port_eng.cfg.tta_flip)
    if api == 'call':
        ref, out = [jax_eng(frames[0])], [port_eng(frames[0])]
    else:
        ref, out = jax_eng.infer_batch(frames), port_eng.infer_batch(frames)
    handle.remove()
    _assert_separated(ref, seen['logits'])
    for o, r in zip(out, ref):
        _assert_results_match(o, r)
    # on the CPU the wrappers run their plain versions and count nothing
    assert counts == [resize_bilinear.launches, crop_and_resize.launches,
                      decode_detections.launches]


def test_async_fifo_and_downscale(weights):
    """run_async/wait_and_grab keep FIFO order, and host_downscale keeps
    boxes in source pixels (the margin is scaled down with the frame)."""
    _, port_eng = _engines(weights, 'default')
    frames = np.random.RandomState(8).randint(0, 256, (2, 360, 640, 3)) \
        .astype(np.uint8)
    port_eng.run_async(frames[0])
    port_eng.run_async(frames[1])
    first, second = port_eng.wait_and_grab(), port_eng.wait_and_grab()
    for got, f in ((first, frames[0]), (second, frames[1])):
        _assert_results_match(got, port_eng(f))
    with pytest.raises(RuntimeError):
        port_eng.wait_and_grab()
    port_eng.cfg.host_downscale = 2
    out = port_eng(frames[0])
    assert np.all(out['boxes'][:, [0, 2]] <= 640 + 1e-3)
    assert np.all(out['boxes'][:, [1, 3]] <= 360 + 1e-3)
    assert np.all((out['kp'] >= 0) & (out['kp'] <= 1))


def test_refine_and_tta_units_match_jax():
    rng = np.random.RandomState(9)
    kp = rng.uniform(0, 1, (5, 9, 2)).astype(np.float32)
    kp[0, 0] = (0.0, 0.3)
    kp[1, 1] = (0.9, 1.0)
    boxes = np.sort(rng.uniform(0, 400, (5, 2, 2)), axis=1) \
        .transpose(0, 2, 1).reshape(5, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    ref = jax_engine_mod.refine_boxes(jnp.asarray(kp), jnp.asarray(boxes),
                                      (640, 480), 10.0, 0.2)
    out = refine_boxes(torch.from_numpy(kp), torch.from_numpy(boxes),
                       (640, 480), 10.0, 0.2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    all_kp = rng.uniform(0, 1, (9, 6, 9, 2)).astype(np.float32)
    logits = rng.standard_normal((6, 9)).astype(np.float32)
    ref = jax_engine_mod.tta_flip_average(jnp.asarray(all_kp),
                                          jnp.asarray(logits), 3, 64)
    out = tta_flip_average(torch.from_numpy(all_kp), torch.from_numpy(logits),
                           3, 64)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_unported_options_raise(weights):
    """``shard`` is not ported and raises; int8 scales are served (an empty
    dict, as in JAX, changes nothing: tests/test_torch_port_quant.py holds
    the int8 path itself)."""
    _, port_eng = _engines(weights, 'default')
    with pytest.raises(NotImplementedError):
        port_eng.shard(None)
    frame = np.random.RandomState(10).randint(0, 256, (64, 96, 3)) \
        .astype(np.uint8)
    ref = port_eng(frame)
    port_eng.cfg.det_int8_scales = {}
    port_eng.cfg.reg_int8_scales = {}
    out = port_eng(frame)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
