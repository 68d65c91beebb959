"""int8 post-training quantization of the port against the JAX package
(CPU, float32).

The port's ``infer/quant.py`` and the plain versions of K6 and K7
(``ops/quant.py``) against ``tpudet3d/infer/quant.py``, on the same numpy
weights (``utils/convert.py``) and inputs:

- ``calibrate``: the same keys (every dense conv, the SSD heads' 1×1 convs
  included) on the detector, the cascade detector, MNv3-large-21k and
  EfficientNet-lite0 (two batches: the running max); absmax within 1e-6
  relative (the float32 forwards differ by an ulp before the max); p999
  on a small net the same way.
- K6's and K7's plain versions against the interceptor's expressions
  (``:158-160``, ``:171-177``) run op by op, bit for bit at float32 and
  bfloat16; K6's inputs hold exact rounding ties and values past the
  clip, K7's sums past 2^24.
- One conv (the stem's 3×3 stride 2 at an odd size, a 1×1 whose depth is
  padded, a 1×1 with a bias) against the JAX interceptor, bit for bit.
- Whole models: every conv that JAX quantizes, given the input it got in
  JAX's forward, gives JAX's output bit for bit (the same convs, in the
  same order).  The two forwards end to end are int8 noise apart: an
  input that the float32 layers between the int8 convs (depthwise convs,
  batch norm) put an ulp apart can round to the neighbouring int8 step,
  and the step travels on.  JAX's own jitted and op-by-op forwards of the
  detector differ the same way (0.077 in a logit).  So the bound is
  relative to the int8 error itself: mean |port − JAX| ≤ NOISE_MEAN ×
  mean |int8 − float32| and max |port − JAX| ≤ max |int8 − float32|;
  measured ratios 0.11–0.30 and 0.28–0.86 (CHANGES.md).
- The convs quantized are the JAX interceptor's: the SSD heads stay
  float32 though they have scales, zero or missing scales fall through,
  ``{}`` and None change nothing (the output bit for bit); partial scales
  on MNv3 within QUANT_ATOL of JAX; a weight swap is quantized again.
- The engine and ``objectron_eval --int8`` against one run of the JAX
  CLI's ``--int8`` (its int8 engine compiled once).  The port's engine on
  that run's scales: the same number of rows per frame, sorted scores
  within ENGINE_SCORE_ATOL, at least half the rows of each frame and
  three quarters in all on a JAX row's box (IoU > 0.9), and on those the
  same labels and keypoints within ENGINE_KP_ATOL (measured 0.0070, 84%,
  4.0e-5: the detector's int8 noise moves scores and so which boxes
  NMS keeps).  The port CLI with its own calibration: as many
  calibration frames and the same keys, values within SCALE_RTOL (its
  crops are K2's, an ulp from JAX's: measured 3.7e-6), reports within
  REPORT_ATOL (measured 0.0030).
"""

import contextlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import tpudet3d.infer.quant as jax_quant
import tpudet3d.ops.image as jax_image
from tpudet3d.detect import SSDDetector as JaxSSD
from tpudet3d.models.layers import ConvBN as JaxConvBN

from tpudet3d_torch.core import AttrDict as PortAttrDict
from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.infer import EngineConfig, TwoStageEngine
from tpudet3d_torch.infer import quant
from tpudet3d_torch.models import build_model
from tpudet3d_torch.models.layers import ConvBN
from tpudet3d_torch.ops import quant as qops
from tpudet3d_torch.tools import objectron_eval as port_cli
from test_torch_port_engine import regressor_weights, weights  # noqa: F401
from test_torch_port_eval import (  # noqa: F401
    CLASSES, _config, _f32_jax_preprocess, _jax_cli, _RecordingJaxEngine,
    shards)
from torch_port_common import (flax_init, one_cpu_thread, perturb, port_of,
                               set_no_tf32, to_jax)

NOISE_MEAN = 0.5
QUANT_ATOL = 1e-4
ENGINE_SCORE_ATOL = 0.02
ENGINE_KP_ATOL = 1e-3
SCALE_RTOL = 1e-4
REPORT_ATOL = 0.02


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


# --- the models ------------------------------------------------------------

MODELS = ('det', 'det_cascade', 'mnv3', 'el0')


@pytest.fixture(scope='module')
def models(weights):  # noqa: F811
    """name → (Flax module, numpy variables, port module, input, JAX
    forward keywords): the detectors at 300², the regressors at 64²."""
    det, dv, reg, rv = weights
    rng = np.random.RandomState(21)
    det_x = rng.uniform(0, 1, (2, 300, 300, 3)).astype(np.float32)
    reg_x = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    out = {}

    def add(name):
        if name == 'det':
            jm, jv, pm = det, dv, SSDDetector(num_classes=9, width_mult=0.25)
        elif name == 'det_cascade':
            jm = JaxSSD(num_classes=9, width_mult=0.25, cascade=True)
            jv = perturb(flax_init(jm, jnp.zeros((1, 300, 300, 3))), seed=17)
            pm = SSDDetector(num_classes=9, width_mult=0.25, cascade=True)
        else:
            arch = ('mobilenetv3_large_21k' if name == 'mnv3'
                    else 'efficientnet-lite0')
            jm, jv = (reg, rv) if name == 'mnv3' else \
                regressor_weights(arch, seed=13)
            pm = build_model(PortAttrDict(model=dict(
                name=arch, num_classes=9, bf16=False)))
        x, kw = ((det_x, dict(train=False)) if name.startswith('det')
                 else (reg_x, dict(export=True)))
        out[name] = (jm, jv, port_of(pm, jv), x, kw)
        return out[name]

    return lambda name: out.get(name) or add(name)


def _np(outs):
    return [np.asarray(o, np.float32) for o in outs]


def _jax_quantized(jm, jv, x, scales, kw):
    """The JAX ``quantized_apply`` of ``jm``, jitted."""
    fn = jax.jit(lambda v, x: jax_quant.quantized_apply(
        jm, v, x, act_scales=scales, **kw))
    return _np(fn(to_jax(jv), jnp.asarray(x)))


@contextlib.contextmanager
def int8_calls():
    """The paths of the convs that take the int8 path, in call order."""
    calls, conv = [], quant.int8_conv

    def spy(x, layer, s_x):
        calls.append(layer)
        return conv(x, layer, s_x)

    quant.int8_conv = spy
    try:
        yield calls
    finally:
        quant.int8_conv = conv


# --- calibration -----------------------------------------------------------

@pytest.mark.parametrize('name', MODELS)
def test_calibrate_matches_jax(models, name):
    jm, jv, pm, x, kw = models(name)
    batches = [x, 2.0 * x[:1]]
    ref = jax_quant.calibrate(jm, to_jax(jv), [(jnp.asarray(b),)
                                                for b in batches], **kw)
    got = quant.calibrate(pm, [(torch.from_numpy(b),) for b in batches])
    assert set(got) == set(ref)
    assert set(got) == set(quant.dense_conv_paths(pm).values())
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-6 * v, (k, got[k], v)


class _JaxNet(fnn.Module):
    """conv → depthwise conv → conv, ConvBN-style (tests/test_quant.py)."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = JaxConvBN(16, 3, 1, act=None)(x, train)
        x = JaxConvBN(16, 3, 1, groups=16, act=None)(x, train)
        return JaxConvBN(8, 1, 1, act=None)(x, train)


class _Net(torch.nn.Module):

    def __init__(self):
        super().__init__()
        self.ConvBN_0 = ConvBN(4, 16, 3, act=None)
        self.ConvBN_1 = ConvBN(16, 16, 3, groups=16, act=None)
        self.ConvBN_2 = ConvBN(16, 8, 1, act=None)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        return self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x))) \
            .permute(0, 2, 3, 1)


def _small_net():
    x = np.random.RandomState(22).standard_normal((2, 16, 16, 4)) \
        .astype(np.float32)
    jv = perturb(flax_init(_JaxNet(), jnp.asarray(x)), seed=23)
    return _JaxNet(), jv, port_of(_Net(), jv), x


def test_calibrate_p999_matches_jax():
    jm, jv, pm, x = _small_net()
    batches = [x, 3.0 * x[1:]]
    ref = jax_quant.calibrate(jm, to_jax(jv), [(jnp.asarray(b),)
                                                for b in batches],
                              method='p999')
    got = quant.calibrate(pm, [(torch.from_numpy(b),) for b in batches],
                          method='p999')
    assert set(got) == set(ref) == {'ConvBN_0/Conv_0', 'ConvBN_2/Conv_0'}
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-6 * v, (k, got[k], v)
    with pytest.raises(ValueError, match='method'):
        quant.calibrate(pm, [], method='minmax')


# --- calibration of bf16 models: the stem on the input before its cast ----

# JAX's recorder sees each conv's argument before Flax casts it to the
# module's dtype: the stem records the float32 model input, every later
# conv a bf16 activation.  The port's bf16 forward rounds like JAX's up to
# the order of its sums, so a later conv's absmax (or 99.9th percentile)
# may move by a few bf16 ulps of the activations it is taken over
BF16_STAT_RTOL = 2 ** -5


@pytest.fixture(scope='module')
def bf16_models(models):
    """``(JAX module, variables, port module)`` of the width-0.25 detector
    and of MNv3-large-21k at 64², both computing in bf16."""
    from tpudet3d.models import build_model as jax_build_model
    from tpudet3d.core import AttrDict as JaxAttrDict
    _, dv, _, _, _ = models('det')
    _, rv, _, _, _ = models('mnv3')
    det = (JaxSSD(num_classes=9, width_mult=0.25, dtype=jnp.bfloat16), dv,
           port_of(SSDDetector(num_classes=9, width_mult=0.25,
                               dtype=torch.bfloat16), dv))
    name = 'mobilenetv3_large_21k'
    reg = (jax_build_model(JaxAttrDict(model=dict(
        name=name, pretrained=False, num_classes=9, bf16=False)),
        dtype=jnp.bfloat16), rv,
        port_of(build_model(PortAttrDict(model=dict(
            name=name, num_classes=9, bf16=False)), dtype=torch.bfloat16),
            rv))
    return dict(det=det, reg=reg)


def _stem(pm):
    """The path of the conv that consumes the model's input."""
    (path,) = [p for m, p in quant.dense_conv_paths(pm).items()
               if m.in_channels == 3]
    return path


def _assert_bf16_stats(got, ref, stem):
    assert set(got) == set(ref) and stem in ref
    for k, v in ref.items():
        tol = 1e-6 if k == stem else BF16_STAT_RTOL
        assert abs(got[k] - v) <= tol * v, (k, got[k], v)


@pytest.mark.parametrize('method', ['absmax', 'p999'])
@pytest.mark.parametrize('name', ['det', 'reg'])
def test_calibrate_bf16_stem_on_float32_input(models, bf16_models, name,
                                              method):
    """``calibrate`` of a bf16 model on a float32 batch: the stem's
    statistic is JAX's (the float32 input's), the other convs within
    BF16_STAT_RTOL; a bf16 batch gives the stem the same statistic
    rounded as the input was."""
    jm, jv, pm = bf16_models[name]
    _, _, _, x, kw = models('det' if name == 'det' else 'mnv3')
    batches = [x, 2.0 * x[:1]]
    ref = jax_quant.calibrate(jm, to_jax(jv), [(jnp.asarray(b),)
                                                for b in batches],
                              method=method, **kw)
    got = quant.calibrate(pm, [(torch.from_numpy(b),) for b in batches],
                          method=method)
    _assert_bf16_stats(got, ref, _stem(pm))
    rounded = quant.calibrate(
        pm, [(torch.from_numpy(b).bfloat16(),) for b in batches],
        method=method)
    want = max(float(np.percentile(np.abs(np.asarray(
        jnp.asarray(b).astype(jnp.bfloat16), np.float32)), 99.9))
        if method == 'p999' else float(np.abs(np.asarray(
            jnp.asarray(b).astype(jnp.bfloat16), np.float32)).max())
        for b in batches)
    assert rounded[_stem(pm)] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize('method', ['absmax', 'p999'])
def test_calibrate_engine_bf16_stems_match_jax(bf16_models, method,
                                               monkeypatch):
    """``calibrate_engine`` of a bf16 engine on two small frames against
    JAX's, with JAX's crops in float32 as the port crops and the port
    cropping JAX's detections: both stems' statistics JAX's within 1e-6
    relative, every other conv within BF16_STAT_RTOL."""
    from tpudet3d.infer import EngineConfig as JaxEngineConfig
    from tpudet3d.infer import TwoStageEngine as JaxEngine
    import tpudet3d.detect as jax_detect
    jdet, dv, pdet = bf16_models['det']
    jreg, rv, preg = bf16_models['reg']
    frames = np.random.RandomState(28).randint(
        0, 256, (2, 96, 128, 3)).astype(np.uint8)
    kw = dict(crop_size=(64, 64), det_conf=0.0, max_detections=4)
    jeng = JaxEngine(jdet, to_jax(dv), jreg, to_jax(rv),
                     JaxEngineConfig(**kw))
    decode, crop = jax_detect.decode_detections, jax_image.crop_and_resize
    seen = []

    def recording(*args, **kwargs):
        seen.append(np.asarray(decode(*args, **kwargs), np.float32))
        return seen[-1]

    monkeypatch.setattr(jax_detect, 'decode_detections', recording)
    monkeypatch.setattr(jax_image, 'crop_and_resize', lambda img, b, hw: crop(
        img, b, hw, compute_dtype=jnp.float32))
    ref = jax_quant.calibrate_engine(jeng, frames, method=method)
    peng = TwoStageEngine(pdet, preg, EngineConfig(**kw), device='cpu')
    got = quant.calibrate_engine(peng, frames, method=method, dets=seen)
    for g, r, pm in zip(got, ref, (pdet, preg)):
        _assert_bf16_stats(g, r, _stem(pm))


# --- K6 and K7 plain versions -------------------------------------------

def _jax_quantize(x_nhwc, s_x):
    """The interceptor's ``:158-160``, op by op."""
    inv_sx = np.float32(127.0 / max(s_x, 1e-12))
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x_nhwc).astype(
        jnp.float32) * inv_sx), -127, 127).astype(jnp.int8))


def _im2col(q, k, stride, pad):
    """int8 NHWC → the conv's rows ``[N·Ho·Wo, k·k·C]``, taps in ``[ky, kx,
    c]`` order (numpy)."""
    n, h, w, c = q.shape
    q = np.pad(q, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    taps = [q[:, ky:ky + stride * (ho - 1) + 1:stride,
              kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    return np.concatenate(taps, -1).reshape(n * ho * wo, k * k * c)


K6_CASES = {'1x1': (24, 1, 1, 0), 'stem': (3, 3, 2, 1),
            '3x3': (16, 3, 1, 1), '5x5s2': (8, 5, 2, 2)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', list(K6_CASES))
def test_k6_plain_matches_jax(case, dtype):
    c, k, stride, pad = K6_CASES[case]
    rng = np.random.RandomState(24)
    s_x = 127.0                       # 127/s_x = 1: halves are exact ties
    x = rng.uniform(-160, 160, (2, 9, 11, c)).astype(np.float32)
    x.reshape(-1)[:40] = np.arange(-20, 20) + 0.5            # ties
    x.reshape(-1)[40:44] = [127.5, -127.5, 1e9, -1e9]        # past the clip
    x = np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    ref = _im2col(_jax_quantize(x, s_x), k, stride, pad)
    t = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = qops.quantize_input_plain(t, s_x, k, stride, pad)
    kp = -(-ref.shape[1] // 16) * 16
    assert got.dtype == torch.int8 and got.shape == (ref.shape[0], kp)
    np.testing.assert_array_equal(got[:, :ref.shape[1]].numpy(), ref)
    assert not got[:, ref.shape[1]:].any()
    # another scale, rounded on the host as JAX does; any layout
    x2 = rng.standard_normal((1, 7, 5, c)).astype(np.float32)
    t2 = torch.from_numpy(x2).permute(0, 3, 1, 2).contiguous()
    np.testing.assert_array_equal(
        qops.quantize_input_plain(t2, 2.345678, k, stride,
                                  pad)[:, :ref.shape[1]].numpy(),
        _im2col(_jax_quantize(x2, 2.345678), k, stride, pad))


@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_k7_plain_matches_jax(dtype, bias):
    rng = np.random.RandomState(25)
    n, n_pad = 20, 24
    y = rng.randint(-2 ** 21, 2 ** 21, (33, n_pad)).astype(np.int32)
    y[0, :4] = [2 ** 24 + 1, -(2 ** 24 + 3), 0, 257]   # f32 and bf16 ties
    s_w = rng.uniform(0.01, 2.0, n).astype(np.float32)
    s_x = 3.7
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    jdt = getattr(jnp, dtype)
    scale = (jnp.asarray(s_w) * np.float32(s_x / (127.0 * 127.0))) \
        .astype(jdt)
    ref = jnp.asarray(y[:, :n]).astype(jdt) * scale
    if bias:
        ref = ref + jnp.asarray(b).astype(jdt)
    p_scale = torch.from_numpy(s_w) * torch.tensor(
        np.float32(s_x / (127.0 * 127.0)))
    got = qops.rescale_plain(torch.from_numpy(y), p_scale,
                             None if b is None else torch.from_numpy(b),
                             getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (33, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


# --- one conv ---------------------------------------------------------------

class _JaxConv(fnn.Module):
    """One conv with explicit padding, as ``ConvBN`` passes it."""
    features: int
    k: int
    stride: int
    bias: bool

    @fnn.compact
    def __call__(self, x):
        p = (self.k - 1) // 2
        return fnn.Conv(self.features, (self.k, self.k),
                        strides=(self.stride, self.stride),
                        padding=[(p, p), (p, p)], use_bias=self.bias)(x)


CONV_CASES = {'stem': (3, 16, 3, 2, False, 33), '1x1': (24, 40, 1, 1, False,
                                                          12),
              '1x1_bias': (40, 24, 1, 1, True, 10)}


@pytest.mark.parametrize('case', list(CONV_CASES))
def test_one_conv_matches_jax_interceptor(case):
    cin, cout, k, stride, bias, size = CONV_CASES[case]
    rng = np.random.RandomState(26)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    jm = _JaxConv(cout, k, stride, bias)
    jv = perturb(flax_init(jm, jnp.asarray(x)), seed=27)
    s_x = float(np.abs(x).max()) * 0.9                 # some inputs clip
    ref = np.asarray(jax_quant.quantized_apply(
        jm, to_jax(jv), jnp.asarray(x), act_scales={'Conv_0': s_x}))
    layer = torch.nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=bias)
    port_of(torch.nn.ModuleDict({'Conv_0': layer}), jv)
    got = qops.int8_conv(torch.from_numpy(x).permute(0, 3, 1, 2), layer,
                         s_x)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


# --- whole models -----------------------------------------------------------

def _jax_conv_io(jm, jv, x, scales, kw):
    """``[(path, input, output)]`` of every conv that the JAX interceptor
    quantizes in one jitted forward of ``jm``, in call order."""
    paths = []

    def run(v, x):
        seen = []
        inner = jax_quant.quant_interceptor(scales)

        def record(next_fun, args, kwargs, ctx):
            out = inner(next_fun, args, kwargs, ctx)
            path = jax_quant._conv_path(ctx)
            if path is not None and scales.get(path) and isinstance(
                    ctx.module.padding, (list, tuple)):
                paths.append(path)
                seen.append((args[0], out))
            return out

        with fnn.intercept_methods(record):
            jm.apply(v, x, **kw)
        return seen

    io = jax.jit(run)(to_jax(jv), jnp.asarray(x))
    return [(p, np.asarray(a), np.asarray(b)) for p, (a, b) in zip(paths, io)]


@pytest.mark.parametrize('name', MODELS)
def test_quantized_apply_matches_jax(models, name):
    """Every quantized conv, given the input it got in JAX's forward, gives
    JAX's output bit for bit; the whole forward is within the int8 noise
    bounds of the module docstring."""
    jm, jv, pm, x, kw = models(name)
    scales = jax_quant.calibrate(jm, to_jax(jv), [(jnp.asarray(x),)], **kw)
    convs = dict(pm.named_modules())
    io = _jax_conv_io(jm, jv, x, scales, kw)
    assert [p for p, _, _ in io] == [
        quant.quantized_conv_paths(pm)[c] for c in _port_int8_order(pm, x,
                                                                    scales)]
    for path, conv_in, conv_out in io:
        got = qops.int8_conv(torch.from_numpy(conv_in).permute(0, 3, 1, 2),
                             convs[path.replace('/', '.')], scales[path])
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      conv_out, err_msg=path)
    ref = _jax_quantized(jm, jv, x, scales, kw)
    got = quant.quantized_apply(pm, torch.from_numpy(x), act_scales=scales)
    plain = _np(jm.apply(to_jax(jv), jnp.asarray(x), **kw))
    for g, r, p in zip(got, ref, plain):
        d, q = np.abs(g.numpy() - r), np.abs(r - p)
        print(f'{name}: |port - JAX| max {d.max():.3g} mean {d.mean():.3g};'
              f' |int8 - float32| max {q.max():.3g} mean {q.mean():.3g}')
        assert d.mean() <= NOISE_MEAN * q.mean() and d.max() <= q.max()


def _port_int8_order(pm, x, scales):
    with int8_calls() as calls:
        quant.quantized_apply(pm, torch.from_numpy(x), act_scales=scales)
    return calls


def _jax_int8_convs(jm, jv, x, scales, kw):
    """How many convs the JAX interceptor sends to the int8 conv, counted
    while the quantized forward is traced."""
    seen, conv = [], jax.lax.conv_general_dilated

    def count(*a, **k):
        if k.get('preferred_element_type') == jnp.int32:
            seen.append(a[1].shape)
        return conv(*a, **k)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.lax, 'conv_general_dilated', count)
        jax.jit(lambda v, x: jax_quant.quantized_apply(
            jm, v, x, act_scales=scales, **kw)).lower(to_jax(jv),
                                                      jnp.asarray(x))
    return len(seen)


def test_heads_stay_unquantized_and_scales_fall_through(models):
    jm, jv, pm, x, kw = models('det')
    scales = quant.calibrate(pm, [(torch.from_numpy(x),)])
    heads = {k for k in scales if '_heads_' in k and k.endswith('/Conv_0')
             and 'ConvBN' not in k}
    assert len(heads) == 4                       # cls and box, two levels
    t = torch.from_numpy(x[:1])
    paths = quant.dense_conv_paths(pm)
    # every scale given: the heads' 1×1 convs stay float32, as in JAX
    # (their padding is 'SAME', not an explicit list)
    with int8_calls() as calls:
        quant.quantized_apply(pm, t, act_scales=scales)
    assert {paths[c] for c in calls} == set(scales) - heads
    assert len(calls) == len(scales) - len(heads) \
        == _jax_int8_convs(jm, jv, x[:1], scales, kw)
    # a zero scale falls through (JAX tests ``not s_x``)
    some = dict(list(scales.items())[:5])
    zero = dict(some, **{next(iter(some)): 0.0})
    with int8_calls() as calls:
        quant.quantized_apply(pm, t, act_scales=zero)
    assert {paths[c] for c in calls} == set(some) - heads - {
        next(iter(some))}
    assert len(calls) == _jax_int8_convs(jm, jv, x[:1], zero, kw)
    # {} and None change nothing
    with torch.no_grad():
        plain = pm(t)
    for empty in ({}, None):
        with int8_calls() as calls:
            out = quant.quantized_apply(pm, t, act_scales=empty)
        assert calls == []
        for o, p in zip(out, plain):
            assert torch.equal(o, p)


def test_partial_scales_fall_through(models):
    """A scale for some convs only: the others run float32, and the output
    is JAX's (jitted) within QUANT_ATOL."""
    jm, jv, pm, x, kw = models('mnv3')
    scales = jax_quant.calibrate(jm, to_jax(jv), [(jnp.asarray(x),)], **kw)
    some = dict(list(scales.items())[::3])
    paths = quant.dense_conv_paths(pm)
    with int8_calls() as calls:
        out = quant.quantized_apply(pm, torch.from_numpy(x), act_scales=some)
    assert {paths[c] for c in calls} == set(some)
    for o, r in zip(out, _jax_quantized(jm, jv, x, some, kw)):
        assert np.abs(o.numpy() - r).max() <= QUANT_ATOL


def test_weight_swap_requantizes():
    rng = np.random.RandomState(28)
    layer = ConvBN(8, 16, 1).Conv_0
    x = torch.from_numpy(rng.standard_normal((1, 8, 6, 6)).astype(np.float32))
    first = qops.int8_conv(x, layer, 3.0)
    w_old = layer.weight.detach().clone()
    w_new = torch.from_numpy(rng.standard_normal((16, 8, 1, 1))
                             .astype(np.float32))
    fresh = torch.nn.Conv2d(8, 16, 1, bias=False)
    with torch.no_grad():
        fresh.weight.copy_(w_new)
    want = qops.int8_conv(x, fresh, 3.0)
    assert not torch.equal(first, want)
    layer.load_state_dict({'weight': w_new})            # in place
    assert torch.equal(qops.int8_conv(x, layer, 3.0), want)
    layer.weight = torch.nn.Parameter(w_old)            # a new tensor
    assert torch.equal(qops.int8_conv(x, layer, 3.0), first)
    with torch.no_grad():
        layer.weight.mul_(-1.0)                         # in place again
    assert torch.equal(qops.int8_conv(x, layer, 3.0), -first)


def test_int8_conv_refuses_what_it_cannot_take():
    x = torch.zeros((1, 8, 6, 6))
    for layer in (torch.nn.Conv2d(8, 8, 3, groups=8),
                  torch.nn.Conv2d(8, 8, 3, dilation=2),
                  torch.nn.Conv2d(8, 8, 3, padding='same')):
        with pytest.raises(ValueError):
            qops.int8_conv(x, layer, 1.0)
    for bad in (x.double(), x[0]):
        with pytest.raises(ValueError):
            qops.quantize_input(bad.to('meta'), 1.0)


# --- the engine and the CLI, on one JAX --int8 run --------------------------

@pytest.fixture(scope='module')
def jax_int8_run(weights, shards, tmp_path_factory):  # noqa: F811
    """``scripts/objectron_eval.py --int8 --det_tresh 0`` on the small test
    engine (float32 preprocessing, calibration crops in float32 as the
    port's): its reports, the engine's results, the frames it served in
    order, and the scales it calibrated."""
    det, dv, reg, rv = weights
    demo, jax_cli = _jax_cli()
    out = tmp_path_factory.mktemp('jax_int8')
    results, frames, scales = [], [], []

    class Recording(_RecordingJaxEngine):
        def infer_batch(self, batch):
            frames.append(np.asarray(batch))
            return super().infer_batch(batch)

        def __call__(self, frame):
            frames.append(np.asarray(frame)[None])
            return super().__call__(frame)

    def jax_engine(*a, **kw):
        engine = Recording(det, to_jax(dv), reg, to_jax(rv),
                           jax_cli_config(**_config(kw)))
        engine.results = results
        return engine

    calibrate_engine = jax_quant.calibrate_engine

    def recording_calibrate(engine, calib, *a, **kw):
        scales.append((len(calib),) + calibrate_engine(engine, calib, *a,
                                                        **kw))
        return scales[-1][1:]

    crop = jax_image.crop_and_resize
    with pytest.MonkeyPatch.context() as m:
        _f32_jax_preprocess(m)
        m.setattr(jax_image, 'crop_and_resize', lambda *a, **kw: crop(
            *a, **dict(kw, compute_dtype=jnp.float32)))
        m.setattr(demo, 'build_engine', jax_engine)
        m.setattr(jax_quant, 'calibrate_engine', recording_calibrate)
        m.setattr(sys, 'argv', [
            'objectron_eval.py', '--eval_data', str(shards), '--classes',
            *CLASSES, '--batch', '4', '--det_tresh', '0', '--int8',
            '--report_dir', str(out)])
        jax_cli.main()
    reports = [(out / f'report_{c}.txt').read_text() for c in CLASSES]
    n_calib, det_scales, reg_scales = scales[0]
    return dict(reports=reports, results=results, frames=frames,
                n_calib=n_calib, det_scales=det_scales,
                reg_scales=reg_scales)


def jax_cli_config(**kw):
    from tpudet3d.infer import EngineConfig as JaxEngineConfig
    return JaxEngineConfig(**kw)


def _port_engine(dv, rv, **cfg):
    return TwoStageEngine(
        port_of(SSDDetector(num_classes=9, width_mult=0.25), dv),
        port_of(build_model(PortAttrDict(model=dict(
            name='mobilenetv3_large_21k', num_classes=9, bf16=False))), rv),
        EngineConfig(**cfg), device='cpu')


def _box_iou(a, b):
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def test_engine_int8_matches_jax(weights, jax_int8_run):  # noqa: F811
    """The port's engine on the JAX run's scales against the JAX int8
    engine's rows on the frames that run served."""
    _, dv, _, rv = weights
    run = jax_int8_run
    assert len(run['det_scales']) == 38 and len(run['reg_scales']) > 0
    engine = _port_engine(
        dv, rv, **_config(dict(det_conf=0.0, refine_passes=0,
                               refine_margin_px=10.0, score_thr=0.0,
                               soft_nms_sigma=0.0, soft_nms_dup_iou=0.75,
                               box_vote_iou=0.0, host_downscale=1,
                               tta_flip=False)),
        det_int8_scales=run['det_scales'],
        reg_int8_scales=run['reg_scales'])
    n_rows = n_matched = 0
    with int8_calls() as calls:
        for batch, ref in zip(run['frames'], run['results']):
            for o, r in zip(engine.infer_batch(batch), ref):
                assert o['scores'].shape == r['scores'].shape
                np.testing.assert_allclose(np.sort(o['scores']),
                                           np.sort(r['scores']), rtol=0,
                                           atol=ENGINE_SCORE_ATOL)
                iou = _box_iou(o['boxes'], r['boxes'])
                j, m = iou.argmax(1), iou.max(1) > 0.9
                assert 2 * m.sum() >= len(m)
                for k in ('det_labels', 'labels'):
                    np.testing.assert_array_equal(o[k][m], r[k][j[m]])
                np.testing.assert_allclose(o['kp'][m], r['kp'][j[m]],
                                           rtol=0, atol=ENGINE_KP_ATOL)
                n_rows += len(m)
                n_matched += m.sum()
    assert n_rows > 0 and 4 * n_matched >= 3 * n_rows
    assert len(calls) == len(run['frames']) * (
        len(quant.quantized_conv_paths(engine.det_model))
        + len(quant.quantized_conv_paths(engine.reg_model)))


def test_cli_int8_matches_jax(weights, shards,  # noqa: F811
                              jax_int8_run, tmp_path, monkeypatch):
    """The port CLI's ``--int8`` calibrates as many convs on as many
    frames as the JAX CLI's, with the same keys and values within 1e-6
    relative, and writes its reports within REPORT_ATOL."""
    _, dv, _, rv = weights
    run = jax_int8_run
    engines, printed = [], []

    def port_engine(*a, **kw):
        assert kw['device'] == 'cpu'
        engines.append(_port_engine(dv, rv, **_config(kw)))
        return engines[-1]

    serve = port_cli.serve_int8
    monkeypatch.setattr(port_cli, 'build_engine', port_engine)
    monkeypatch.setattr(port_cli, 'serve_int8', lambda engine, frames:
                        printed.append(len(frames)) or serve(engine, frames))
    port_cli.main(['--eval_data', str(shards), '--classes', *CLASSES,
                   '--batch', '4', '--det_tresh', '0', '--int8',
                   '--report_dir', str(tmp_path), '--device', 'cpu'])
    cfg = engines[0].cfg
    assert printed == [run['n_calib']]
    for got, ref in ((cfg.det_int8_scales, run['det_scales']),
                     (cfg.reg_int8_scales, run['reg_scales'])):
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert abs(got[k] - v) <= SCALE_RTOL * v, (k, got[k], v)
    for c, ref in zip(CLASSES, run['reports']):
        text = (tmp_path / f'report_{c}.txt').read_text()
        lines, ref_lines = text.splitlines(), ref.splitlines()
        assert lines[0] == ref_lines[0]                 # matched n/m
        assert len(lines) == len(ref_lines)
        for line, ref_line in zip(lines[1:], ref_lines[1:]):
            vals, ref_vals = _numbers(line), _numbers(ref_line)
            assert len(vals) == len(ref_vals), line
            np.testing.assert_allclose(vals, ref_vals, rtol=0,
                                       atol=REPORT_ATOL, err_msg=line)


def _numbers(line):
    if ': ' not in line:
        return []
    return [float(v) for v in re.split(r'[,\s]+', line.split(': ', 1)[1])
            if v]
