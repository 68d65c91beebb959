"""K6's launch plan (``tpudet3d_torch/ops/quant.py`` ``quantize_plan``),
pure Python, no CUDA: the route and geometry that the kernel's
``make_layout`` (``kernels/csrc/quant.cu``) mirrors and its C entry
checks, so no CPU run could see them otherwise.

- Every int8 conv of the detector (MNv2-SSD-300, batch 16 at 300²) and of
  the MNv3-large-21k, EfficientNet-lite0/1/2 regressors (128 crops at
  224², lite0 also at 288²) takes ``rows`` (the 1×1 convs) or ``staged``
  (the stems), in bf16 and f32.  Shapes come from a forward on the meta
  device at those sizes; a small forward on the CPU shows that every such
  input is channels-last, as the card's serving path hands it over
  (``chip_smoke.py`` phase 7 checks the card's own inputs).
- NCHW inputs, depths that are not whole 16-byte vectors and unaligned
  inputs take ``strided``; so does a staged CTA that cannot fit.
- The staged route's bands cover every output row exactly once, stage
  every input row their taps read, fit their shared memory at any
  16-byte misalignment, and stay within 227 KB.
"""

import pytest
import torch

from tpudet3d_torch.core import AttrDict
from tpudet3d_torch.infer import quant
from tpudet3d_torch.infer.build import build_detector
from tpudet3d_torch.models import build_model, layers
from tpudet3d_torch.ops import quant as qops
from tpudet3d_torch.ops.image import SMEM_LIMIT

SMS = qops.H100_SMS
DTYPES = [torch.bfloat16, torch.float32]
# served model: (regressor backbone, or a constructor; serving input NHWC)
SERVED = {
    'detector': (lambda: build_detector(), (16, 300, 300, 3)),
    'mnv3': ('mobilenetv3_large_21k', (128, 224, 224, 3)),
    'el0': ('efficientnet-lite0', (128, 224, 224, 3)),
    'el0_r288': ('efficientnet-lite0', (128, 288, 288, 3)),
    'el1': ('efficientnet-lite1', (128, 224, 224, 3)),
    'el2': ('efficientnet-lite2', (128, 224, 224, 3)),
}


def _model(name):
    build, _ = SERVED[name]
    if callable(build):
        model = build()
    else:
        model = build_model(AttrDict(model=dict(
            name=build, pretrained=False, num_classes=9, bf16=True)))
    return model.to(memory_format=torch.channels_last).eval()


def _record(model, x):
    """``(input, conv)`` of every int8-quantized conv of ``model`` on
    ``x``, the calls left to ``F.conv2d``."""
    convs, calls = quant.quantized_conv_paths(model), []

    def hook(inp, layer):
        if layer in convs:
            calls.append((inp, layer))

    layers.conv_hook.fn = hook
    try:
        with torch.no_grad():
            model(x)
    finally:
        layers.conv_hook.fn = None
    return calls


def _cl_strides(shape):
    n, c, h, w = shape
    return (h * w * c, 1, w * c, c)


@pytest.fixture(scope='module')
def served_convs():
    """Per served model: its quantized convs' ``(NCHW shape, kernel,
    stride, pad)`` at the serving size, and whether each input of a small
    CPU forward was channels-last."""
    out = {}
    for name, (_, nhwc) in SERVED.items():
        model = _model(name)
        small = _record(model, torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
        full = _record(model.to('meta'),
                       torch.empty(nhwc, dtype=torch.uint8, device='meta'))
        out[name] = (
            [(tuple(x.shape), conv.kernel_size, conv.stride, conv.padding)
             for x, conv in full],
            [x.is_contiguous(memory_format=torch.channels_last)
             for x, _ in small])
    return out


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', list(SERVED))
def test_served_convs_take_rows_or_staged(served_convs, name, dtype):
    convs, channels_last = served_convs[name]
    assert len(convs) == len(channels_last) > 0 and all(channels_last)
    n_stems = 0
    for shape, kernel, stride, pad in convs:
        plan = qops.quantize_plan(shape, _cl_strides(shape), dtype, kernel,
                                  stride, pad, 0, SMS)
        if kernel == (1, 1):
            assert plan.route == 'rows', (shape, plan)
            assert 0 < plan.ctas <= SMS * qops.K6_ROWS_CTAS_PER_SM
        else:
            n_stems += 1
            assert (shape[1], kernel, stride) == (3, (3, 3), (2, 2))
            assert plan.route == 'staged', (shape, plan)
            assert plan.smem_bytes <= qops.K6_STAGE_BYTES
            assert 0 < plan.ctas <= SMS * qops.K6_STAGED_CTAS_PER_SM
    assert n_stems == 1


# (name, NCHW shape, kernel, stride, pad, strides or None for
# channels-last, element offset, route in bf16, route in f32)
STRIDED = {
    'nchw_1x1': ((2, 24, 9, 9), 1, 1, 0, 'nchw', 0, 'strided', 'strided'),
    'nchw_stem': ((2, 3, 30, 30), 3, 2, 1, 'nchw', 0, 'strided', 'strided'),
    'c20': ((2, 20, 9, 9), 1, 1, 0, None, 0, 'strided', 'rows'),
    'c13': ((2, 13, 9, 9), 1, 1, 0, None, 0, 'strided', 'strided'),
    'c13_k3': ((2, 13, 9, 9), 3, 1, 1, None, 0, 'staged', 'staged'),
    'odd_offset': ((1, 24, 7, 7), 1, 1, 0, None, 1, 'strided', 'strided'),
    'offset_8': ((1, 24, 7, 7), 1, 1, 0, None, 8, 'rows', 'rows'),
    'offset_4': ((1, 24, 7, 7), 1, 1, 0, None, 4, 'strided', 'rows'),
    'stem_offset': ((2, 3, 30, 30), 3, 2, 1, None, 1, 'staged', 'staged'),
    'stride2_1x1': ((2, 16, 9, 9), 1, 2, 0, None, 0, 'staged', 'staged'),
    # two staged rows of 80,000 bytes exceed any CTA's shared memory
    'too_wide': ((1, 3, 8, 40000), 3, 1, 1, None, 0, 'strided', 'strided'),
}


@pytest.mark.parametrize('case', list(STRIDED))
def test_plan_routes_of_other_inputs(case):
    shape, k, s, p, strides, offset, *routes = STRIDED[case]
    if strides == 'nchw':
        strides = torch.empty(shape).stride()
    for dtype, route in zip(DTYPES, routes):
        ptr = offset * dtype.itemsize
        plan = qops.quantize_plan(shape, strides or _cl_strides(shape),
                                  dtype, k, s, p, ptr, SMS)
        assert plan.route == route, (dtype, plan)
        if route == 'strided':
            m, _, kp, _, _ = qops.conv_geometry(shape, k, s, p)
            assert plan == qops.QuantPlan(
                'strided', -(-m * kp // 16 // qops.K6_THREADS), 0, 0)


def test_channels_last_ignores_unit_dims():
    """A size-1 dimension may have any stride (PyTorch's channels-last
    strides for H = 1 or N = 1 differ between constructors)."""
    shape = (1, 24, 1, 17)
    for strides in ((408, 1, 408, 24), (7, 1, 3, 24)):
        assert qops.quantize_plan(shape, strides, torch.bfloat16, 1, 1, 0,
                                  0, SMS).route == 'rows'
    assert qops.quantize_plan(shape, (408, 1, 408, 23), torch.bfloat16, 1, 1,
                              0, 0, SMS).route == 'strided'


# (NCHW shape, kernel, stride, pad) of channels-last staged convs
STAGED = {'stem300': ((16, 3, 300, 300), 3, 2, 1),
          'stem224': ((128, 3, 224, 224), 3, 2, 1),
          'stem288': ((128, 3, 288, 288), 3, 2, 1),
          'k3edge': ((128, 16, 21, 21), 3, 1, 1),
          'k5s2': ((2, 40, 13, 11), 5, 2, 2),
          'k3s1_small': ((1, 16, 5, 4), 3, 1, 1),
          'k2_nopad': ((4, 8, 17, 9), 2, 2, 0)}


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', list(STAGED))
def test_staged_bands_cover_rows(case, dtype):
    shape, k, s, p = STAGED[case]
    n, c, h, w = shape
    plan = qops.quantize_plan(shape, _cl_strides(shape), dtype, k, s, p, 0,
                              SMS)
    assert plan.route == 'staged' and plan.smem_bytes <= SMEM_LIMIT
    fp = qops.quantize_footprint(shape, dtype.itemsize, k, s, p, plan.band)
    assert fp.smem_bytes == plan.smem_bytes and fp.band == plan.band
    bands = qops.quantize_bands(shape, k, s, p, plan.band)
    _, _, _, ho, wo = qops.conv_geometry(shape, k, s, p)
    assert plan.ctas == min(n * len(bands), SMS * qops.K6_STAGED_CTAS_PER_SM)
    covered = []
    for oy0, rows, first, lo, hi in bands:
        covered += range(oy0, oy0 + rows)
        assert 1 <= rows <= plan.band
        need = {oy * s - p + ky for oy in range(oy0, oy0 + rows)
                for ky in range(k)}
        staged = range(first, first + (rows - 1) * s + k)
        assert need == set(staged) and len(staged) <= fp.rows
        assert (lo, hi) == (max(first, 0), min(first + len(staged), h))
        # the in-frame rows fit one raw stage at any 16-byte misalignment
        n_bytes = (hi - lo) * w * c * dtype.itemsize
        assert -(-(15 + n_bytes) // 16) * 16 <= fp.raw_bytes
        # every tap of the band's last output row lies inside the tile
        pitch = -(-c // 4) * 4
        last = ((rows - 1) * s + k - 1) * fp.tile_width \
            + ((wo - 1) * s + k - 1) * pitch + c - 1
        assert last < fp.rows * fp.tile_width
    assert covered == list(range(ho))
    if case == 'k3edge':
        # a band of fewer rows than the plan's, whose staged rows cross
        # the frame's bottom edge
        oy0, rows, first, lo, hi = bands[-1]
        assert plan.band > 1 and rows < plan.band
        assert first + (rows - 1) * s + k > hi == h


def test_staged_band_prefers_tall_busy_bands():
    """The tallest band within K6_STAGE_BYTES that leaves each SM
    K6_BANDS_PER_SM bands, else bands of one row."""
    cl = _cl_strides
    big = (128, 3, 224, 224)
    plan = qops.quantize_plan(big, cl(big), torch.bfloat16, 3, 2, 1, 0, SMS)
    assert plan.band == 4 and plan.ctas == SMS * qops.K6_STAGED_CTAS_PER_SM
    # a band of 8 would not fit the preferred bytes
    assert qops.quantize_footprint(big, 2, 3, 2, 1, 8).smem_bytes > \
        qops.K6_STAGE_BYTES
    small = (2, 40, 13, 11)
    plan = qops.quantize_plan(small, cl(small), torch.bfloat16, 5, 2, 2, 0,
                              SMS)
    assert (plan.band, plan.ctas) == (1, 2 * 7)
