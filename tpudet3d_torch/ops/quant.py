"""The int8 convolution of int8 serving: kernels K6 and K7 around an int8
matrix product.

It replaces the intercepted dense conv of ``tpudet3d/infer/quant.py``
(``quant_interceptor``, ``:157-177``), which is three steps:

1. K6 ``quantize_input`` (``:158-160`` and the conv's zero padding): the
   input quantized per tensor, symmetric, ``clip(round(x * (127/s_x)),
   -127, 127)`` in float32, rounded half to even, laid out as the rows of
   the product: ``[N·Ho·Wo, Kp]`` int8 with K in the weight's ``[kh, kw,
   Cin]`` order (im2col for a k×k conv), padded with zeros to a multiple
   of 16 (``kernels/csrc/quant.cu``).  :func:`quantize_plan` picks one of
   three routes per call: ``rows`` (a 1×1 conv on aligned channels-last
   rows, read as 16-byte vectors), ``staged`` (a k×k conv on channels-last
   input, a band of input rows staged in shared memory and quantized once)
   or ``strided`` (anything else, read through the strides);
2. the int8 × int8 → int32 product (``:167-170``, a library conv in XLA):
   ``torch._int_mm`` against the weight quantized per output channel and
   cached as ``[Np, Kp]`` int8 (:func:`int8_weight`);
3. K7 ``rescale`` (``:171-177``): the int32 sums cast to the output dtype,
   times the per-channel scale ``s_w · s_x/127²`` cast to it, plus the
   bias cast to it, each step rounded to the output dtype as JAX does
   (``kernels/csrc/quant.cu``).

A wrapper runs the plain version only for a tensor on the CPU; on a CUDA
tensor it launches the kernel or raises.  ``wrapper.launches`` counts the
kernel launches.
"""

import functools
import weakref
from collections import namedtuple

import numpy as np
import torch

from ..kernels.build import check, library, stream_args
from .image import SMEM_LIMIT, _sm_count

__all__ = ['quantize_input', 'quantize_input_plain', 'rescale',
           'rescale_plain', 'int8_weight', 'int8_conv', 'conv_geometry',
           'quantize_plan', 'quantize_footprint', 'quantize_bands',
           'QuantPlan', 'K_ALIGN', 'N_ALIGN', 'K6_THREADS',
           'K6_ROWS_CTAS_PER_SM', 'K6_STAGED_CTAS_PER_SM', 'K6_STAGE_BYTES',
           'H100_SMS']

K_ALIGN = 16     # the product's depth is padded to whole 16-byte rows
# torch._int_mm takes widths that are multiples of 8, but cuBLASLt on the
# H100 refuses some odd multiples of 8 at many rows (72 at 200,704 rows:
# CUBLAS_STATUS_NOT_SUPPORTED; chip_smoke.py phase 7 checks it), so the
# weight's rows are padded to a multiple of 16
N_ALIGN = 16
_IN_DTYPES = (torch.float32, torch.bfloat16)

# K6's launch geometry, mirrored by kernels/csrc/quant.cu make_layout
K6_THREADS = 256           # threads of a CTA on every route
K6_ROWS_CTAS_PER_SM = 4    # the rows grid: at most this many CTAs a SM
K6_STAGED_CTAS_PER_SM = 6  # the staged grid likewise
K6_BANDS = (16, 8, 4, 2, 1)  # the staged route's output rows per band
K6_BANDS_PER_SM = 8        # the staged route's bands a SM at the least
K6_STAGE_BYTES = 36864     # shared bytes a staged CTA takes by preference
H100_SMS = 132
_ROUTES = ('rows', 'staged', 'strided')

QuantPlan = namedtuple('QuantPlan', 'route ctas band smem_bytes')
StagedFootprint = namedtuple('StagedFootprint',
                             'band rows tile_width raw_bytes smem_bytes')


def _round_up(v, m):
    return (v + m - 1) // m * m


def _channels_last(shape, strides):
    """Whether element ``(n, c, y, x)`` lies at ``((n·H + y)·W + x)·C + c``
    (a dimension of size 1 may have any stride)."""
    n, c, h, w = shape
    return all(size == 1 or st == want for size, st, want in zip(
        shape, strides, (h * w * c, 1, w * c, c)))


def quantize_footprint(shape, esize, kernel_size, stride, pad, band):
    """The staged route's shared memory for bands of ``band`` output rows
    of an NCHW input of ``shape`` with ``esize``-byte elements
    (``quant.cu``'s ``make_layout``): two raw stages (the band being
    quantized and the next one in flight), each of a band's input rows,
    ``(band − 1) · sh + kh``, as raw bytes (those inside the frame,
    contiguous in channels-last memory, copied from the 16-byte chunk that
    holds the first: at most one chunk more than their length rounded up
    to 16), then an int8 tile of every row with ``pw`` zero columns each
    side, a pixel every C rounded up to 4 bytes."""
    n, c, h, w = shape
    kh, _ = _pair(kernel_size)
    sh, _ = _pair(stride)
    _, pw = _pair(pad)
    rows = (band - 1) * sh + kh
    raw = _round_up(min(rows, h) * w * c * esize, 16) + 16
    tile_width = (w + 2 * pw) * _round_up(c, 4)
    return StagedFootprint(band, rows, tile_width, raw,
                           2 * raw + rows * tile_width)


def quantize_plan(shape, strides, dtype, kernel_size=1, stride=1, pad=0,
                  data_ptr=0, sms=H100_SMS):
    """K6's route and launch geometry for an NCHW input of ``shape``,
    element ``strides`` and ``dtype`` at address ``data_ptr``, on a card
    of ``sms`` SMs: a :class:`QuantPlan` (route, CTAs, output rows per
    band, dynamic shared bytes).

    * ``rows``: a 1×1, stride 1, pad 0 conv on channels-last input whose
      rows are whole 16-byte vectors (C a multiple of 8 in bf16, of 4 in
      f32) at a 16-byte aligned address; a grid of at most
      :data:`K6_ROWS_CTAS_PER_SM` CTAs a SM strides over the 16-byte
      output chunks.
    * ``staged``: another conv on channels-last input whose rows' 16-byte
      chunks (Kp/16) fit one CTA's threads; at most
      :data:`K6_STAGED_CTAS_PER_SM` CTAs a SM stride over the bands of
      output rows of every image, the tallest band of :data:`K6_BANDS`
      within :data:`K6_STAGE_BYTES` of shared memory that gives each SM
      :data:`K6_BANDS_PER_SM` bands, else bands of one row (within
      :data:`SMEM_LIMIT`).
    * ``strided``: anything else (NCHW or other strides, odd C, unaligned
      rows, a staged CTA that does not fit)."""
    return _plan(tuple(shape), tuple(strides), dtype, _pair(kernel_size),
                 _pair(stride), _pair(pad), data_ptr % 16, sms)


@functools.lru_cache(maxsize=1024)
def _plan(shape, strides, dtype, kernel_size, stride, pad, misalign, sms):
    n, c, h, w = shape
    m, _, kp, ho, wo = conv_geometry(shape, kernel_size, stride, pad)
    esize = dtype.itemsize
    chunks = m * kp // 16
    strided = QuantPlan('strided', -(-chunks // K6_THREADS), 0, 0)
    if not _channels_last(shape, strides) or m * kp >= 2 ** 31:
        return strided
    if (kernel_size, stride, pad) == ((1, 1), (1, 1), (0, 0)):
        if (c * esize) % 16 or misalign:
            return strided
        return QuantPlan('rows', min(-(-chunks // K6_THREADS),
                                     sms * K6_ROWS_CTAS_PER_SM), 0, 0)
    if kp // 16 > K6_THREADS:
        return strided
    fps = [quantize_footprint(shape, esize, kernel_size, stride, pad, b)
           for b in K6_BANDS]
    fp = next((fp for fp in fps if fp.smem_bytes <= K6_STAGE_BYTES
               and n * -(-ho // fp.band) >= K6_BANDS_PER_SM * sms), fps[-1])
    if fp.smem_bytes > SMEM_LIMIT:
        return strided
    return QuantPlan('staged', min(n * -(-ho // fp.band),
                                   sms * K6_STAGED_CTAS_PER_SM), fp.band,
                     fp.smem_bytes)


def quantize_bands(shape, kernel_size, stride, pad, band):
    """The staged route's bands of one image, in order: ``(first output
    row, output rows, first staged input row (may be < 0), first and one
    past the last staged row inside the frame)``; the staged rows outside
    the frame are the tile's zero rows.  Band ``b`` of the launch is band
    ``b % len(bands)`` of image ``b // len(bands)``."""
    _, _, h, _ = shape
    _, _, _, ho, _ = conv_geometry(shape, kernel_size, stride, pad)
    kh, _ = _pair(kernel_size)
    sh, _ = _pair(stride)
    ph, _ = _pair(pad)
    out = []
    for oy0 in range(0, ho, band):
        rows = min(band, ho - oy0)
        first = oy0 * sh - ph
        last = first + (rows - 1) * sh + kh
        out.append((oy0, rows, first, max(first, 0), min(last, h)))
    return out


def _inv_scale(s_x):
    """``127 / max(s_x, 1e-12)`` rounded to float32 on the host, as the JAX
    interceptor computes it."""
    return float(np.float32(127.0 / max(float(s_x), 1e-12)))


def conv_geometry(shape, kernel_size, stride, pad):
    """``(M, K, Kp, Ho, Wo)`` of the quantized rows of an NCHW input of
    ``shape`` for a conv of ``kernel_size`` ``(kh, kw)``, ``stride`` and
    symmetric ``pad``, each an int or a pair."""
    n, c, h, w = shape
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(pad)
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    k = kh * kw * c
    return n * ho * wo, k, _round_up(k, K_ALIGN), ho, wo


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def quantize_input_plain(x, s_x, kernel_size=1, stride=1, pad=0):
    """``x [N,C,H,W]`` (float32 or bfloat16, any layout) → int8 ``[M, Kp]``:
    row ``(n, oy, ox)`` holds the conv's taps ``[ky, kx, c]`` quantized with
    ``127/s_x``, zero outside the frame and in the padded columns."""
    m, k, kp, ho, wo = conv_geometry(x.shape, kernel_size, stride, pad)
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(pad)
    inv = torch.tensor(_inv_scale(s_x), dtype=torch.float32, device=x.device)
    q = torch.round(x.float() * inv).clamp(-127, 127).to(torch.int8)
    q = torch.nn.functional.pad(q.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
    taps = [q[:, ky:ky + sh * (ho - 1) + 1:sh, kx:kx + sw * (wo - 1) + 1:sw]
            for ky in range(kh) for kx in range(kw)]       # [N,Ho,Wo,C] each
    rows = torch.cat(taps, dim=-1).reshape(m, k)
    return torch.nn.functional.pad(rows, (0, kp - k))


def quantize_input(x, s_x, kernel_size=1, stride=1, pad=0):
    """K6: see :func:`quantize_input_plain`.  On the card ``x`` may have any
    strides; :func:`quantize_plan` picks the route (the serving path's
    channels-last inputs take ``rows`` or ``staged``)."""
    if x.device.type == 'cpu':
        return quantize_input_plain(x, s_x, kernel_size, stride, pad)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if x.dim() != 4 or x.dtype not in _IN_DTYPES:
        raise ValueError(f'expected a float32 or bfloat16 [N,C,H,W] tensor, '
                         f'got {x.dtype} {tuple(x.shape)}')
    m, _, kp, ho, wo = conv_geometry(x.shape, kernel_size, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f'no output for input {tuple(x.shape)}, kernel '
                         f'{kernel_size}, stride {stride}, pad {pad}')
    n, c, h, w = x.shape
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(pad)
    out = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    sms = _sm_count(x.device)
    plan = quantize_plan(tuple(x.shape), x.stride(), x.dtype, kernel_size,
                         stride, pad, x.data_ptr(), sms)
    sn, sc, sy, sx = x.stride()
    err = library().tpd_quantize_input(
        x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), n, c,
        h, w, sn, sc, sy, sx, kh, kw, sh, sw, ph, pw, ho, wo, kp,
        _inv_scale(s_x), _ROUTES.index(plan.route), plan.ctas, plan.band,
        plan.smem_bytes, sms, *stream_args(x))
    check(err, 'quantize_input')
    quantize_input.launches += 1
    return out


quantize_input.launches = 0


def rescale_plain(y, scale, bias=None, out_dtype=torch.float32):
    """int32 ``y [M, Np]`` → ``[M, N]`` of ``out_dtype`` (N = scale's
    length): ``y`` cast to it, times ``scale`` cast to it, plus ``bias``
    cast to it, each result rounded to ``out_dtype``."""
    n = scale.shape[0]
    out = y[:, :n].to(out_dtype) * scale.to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


def rescale(y, scale, bias=None, out_dtype=torch.float32):
    """K7: see :func:`rescale_plain`.  On the card ``y`` is a contiguous
    int32 ``[M, Np]`` with Np ≥ N, ``scale`` and ``bias`` contiguous float32
    ``[N]`` on its device; the output is a new contiguous ``[M, N]``."""
    if y.device.type == 'cpu':
        return rescale_plain(y, scale, bias, out_dtype)
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if out_dtype not in _IN_DTYPES:
        raise ValueError(f'output dtype must be one of {_IN_DTYPES}')
    if y.dtype != torch.int32 or y.dim() != 2 or not y.is_contiguous():
        raise ValueError(f'expected a contiguous int32 [M, Np] tensor, got '
                         f'{y.dtype} {tuple(y.shape)}')
    n = scale.shape[0]
    for t in (scale, bias):
        if t is not None and (t.dtype != torch.float32 or t.dim() != 1
                              or t.shape[0] != n or not t.is_contiguous()
                              or t.device != y.device):
            raise ValueError(f'expected contiguous float32 [{n}] scale and '
                             f'bias on {y.device}')
    if not 0 < n <= y.shape[1]:
        raise ValueError(f'{n} channels from {y.shape[1]} columns')
    m = y.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=y.device)
    err = library().tpd_int8_rescale(
        y.data_ptr(), scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, y.shape[1], int(out_dtype == torch.bfloat16),
        *stream_args(y))
    check(err, 'rescale')
    rescale.launches += 1
    return out


rescale.launches = 0

# per conv: (key, int8 weight [Np, Kp], float32 scale [N])
_WEIGHTS = weakref.WeakKeyDictionary()


def int8_weight(layer, s_x):
    """The int8 weight ``[Np, Kp]`` of ``layer`` (an ``nn.Conv2d``) and its
    float32 rescale ``s_w · s_x/127²`` ``[N]``.  The weight is quantized per
    output channel as the JAX interceptor does in-graph: ``s_w = max(max
    |w|, 1e-12)`` over the channel, ``clip(round(w · (127/s_w)), -127,
    127)``; K in ``[kh, kw, Cin]`` order; padded rows and columns 0.  Made
    once per weight and ``s_x`` and kept while the weight tensor, its
    storage and its version stay the same, so a swapped or reloaded weight
    is quantized again."""
    w = layer.weight
    key = (id(w), w._version, w.data_ptr(), str(w.device), float(s_x))
    hit = _WEIGHTS.get(layer)
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    with torch.no_grad():
        k = w.detach().float()
        s_w = k.abs().amax(dim=(1, 2, 3)).clamp(min=1e-12)
        mult = torch.tensor(127.0, device=k.device) / s_w
        q = torch.round(k * mult[:, None, None, None]).clamp(-127, 127)
        n_out = q.shape[0]
        q = q.permute(0, 2, 3, 1).reshape(n_out, -1).to(torch.int8)
        kp = _round_up(q.shape[1], K_ALIGN)
        q = torch.nn.functional.pad(
            q, (0, kp - q.shape[1], 0, _round_up(n_out, N_ALIGN) - n_out))
        scale = s_w * torch.tensor(np.float32(float(s_x) / (127.0 * 127.0)),
                                   device=k.device)
    _WEIGHTS[layer] = (key, q, scale)
    return q, scale


def int8_conv(x, layer, s_x):
    """``layer`` (an ``nn.Conv2d`` with groups 1) on ``x [N,C,H,W]`` through
    the int8 path: K6, ``torch._int_mm``, K7.  Returns ``[N,Cout,Ho,Wo]`` of
    ``x``'s dtype as a channels-last view of the ``[N·Ho·Wo, Cout]`` rows."""
    if layer.groups != 1 or layer.dilation != (1, 1) \
            or isinstance(layer.padding, str):
        raise ValueError('int8_conv takes dense convs with numeric padding '
                         'and no dilation')
    m, _, _, ho, wo = conv_geometry(x.shape, layer.kernel_size, layer.stride,
                                    layer.padding)
    if x.device.type == 'cuda' and m <= 16:
        raise ValueError(f'{m} rows: torch._int_mm on the card takes more '
                         'than 16')
    q_w, scale = int8_weight(layer, s_x)
    rows = quantize_input(x, s_x, layer.kernel_size, layer.stride,
                          layer.padding)
    y = torch._int_mm(rows, q_w.t())
    bias = None if layer.bias is None else layer.bias.detach().float()
    out = rescale(y, scale, bias, x.dtype)
    return out.view(x.shape[0], ho, wo, -1).permute(0, 3, 1, 2)
