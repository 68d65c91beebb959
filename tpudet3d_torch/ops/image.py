"""Image ops of the serving path (counterpart of ``tpudet3d/ops/image.py``).

Two kernels live here, each as a plain PyTorch version and a wrapper:

* K1 ``resize_bilinear``: uint8 NHWC frames → antialiased bilinear resize
  (``jax.image.resize(..., 'bilinear')`` semantics), optional channel
  reversal and scale (``kernels/csrc/resize.cu``, one CTA per output tile;
  :func:`resize_plan` sizes its shared memory).
* K2 ``crop_and_resize``: boxes of uint8 NHWC frames → bilinear crops with
  cv2 pixel-centre sampling, border clamp, per-channel ``x*scale - offset``
  and an optional mirrored copy for TTA (``kernels/csrc/crop.cu``, one CTA
  per band of output rows of a crop, staged in passes; :func:`crop_plan`
  sizes its shared memory, :func:`crop_passes` states its passes).

A wrapper runs the plain version only for a tensor on the CPU; on a CUDA
tensor it launches the kernel or raises.  ``wrapper.launches`` counts the
kernel launches.
"""

import functools
from collections import namedtuple

import numpy as np
import torch

from ..kernels.build import check, library, stream_args

__all__ = ['resize_weights', 'resize_bilinear_plain', 'resize_bilinear',
           'resize_windows', 'staged_ranges', 'resize_footprint',
           'resize_plan', 'crop_taps', 'crop_footprint', 'crop_plan',
           'crop_stage_rows', 'crop_passes', 'crop_and_resize_plain',
           'crop_and_resize']

_OUT_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448        # shared bytes a CTA may opt into on the H100
K1_TILE_X = 32
K1_COL_ALIGN = 4           # a tile's first staged column is a multiple of it
K1_TILE_Y = (16, 8, 4, 2, 1)   # tried in this order until the tile fits
K2_RUN = 8                 # output pixels per thread (three 16-byte stores)
K2_BANDS = (16, 8, 4, 2, 1)  # output rows per CTA, tried in this order
K2_STAGE_BYTES = 32768     # a K2 CTA's staged source rows (at least two)


def resize_weights(in_size, out_size, device=None):
    """``[out, in]`` float32 weights of ``jax.image.resize``'s antialiased
    bilinear filter along one axis.

    Output pixel ``o`` samples the input at ``s = (o + 0.5) * in/out - 0.5``.
    The triangle filter ``max(0, 1 - |s - i| / k)`` is widened to
    ``k = max(in/out, 1)`` when downscaling (an average over the footprint
    instead of point sampling), and each row is normalised to sum to 1.
    """
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    grid = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample[:, None] - grid[None, :]).abs() / kernel_scale
    w = (1.0 - x).clamp(min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize_bilinear_plain(frames, out_hw, reverse_channels=False, scale=1.0,
                          dtype=torch.float32):
    """``[N,H,W,C]`` → ``[N,h,w,C]``: the weight matrices of
    :func:`resize_weights` applied per axis in float32, then ``*scale``."""
    x = frames.float()
    if reverse_channels:
        x = x.flip(-1)
    wy = resize_weights(x.shape[1], out_hw[0], x.device)
    wx = resize_weights(x.shape[2], out_hw[1], x.device)
    x = torch.einsum('oh,nhwc->nowc', wy, x)
    x = torch.einsum('pw,nowc->nopc', wx, x)
    return (x * scale).to(dtype)


def resize_windows(n_in, n_out):
    """First and last input index ``(lo, hi)`` of each output's filter
    window along one axis, in float32 as K1 computes them: every weight of
    :func:`resize_weights` outside ``[lo, hi]`` is 0."""
    inv = np.float32(1.0 / (n_out / n_in))
    k = max(inv, np.float32(1.0))
    s = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv
         - np.float32(0.5))
    lo = np.maximum(np.ceil(s - k), 0).astype(np.int64)
    hi = np.minimum(np.floor(s + k), n_in - 1).astype(np.int64)
    return lo, hi


def staged_ranges(n_in, n_out, tile, align=1):
    """First and last input index that K1 stages for each tile of ``tile``
    outputs along one axis: from the first output's window, rounded down to
    a multiple of ``align`` (K1_COL_ALIGN for columns), to the last's."""
    lo, hi = resize_windows(n_in, n_out)
    last = np.minimum(np.arange(tile - 1, n_out + tile - 1, tile), n_out - 1)
    return lo[::tile] // align * align, hi[last]


def _align16(v):
    return (v + 15) // 16 * 16


Footprint = namedtuple('Footprint', 'tile_y tile_x rows cols taps_y taps_x '
                                    'smem_bytes')


def resize_footprint(h, w, oh, ow, tile_y):
    """K1's shared memory for tiles of ``tile_y × K1_TILE_X`` outputs: the
    most input rows and columns a tile stages, the most taps per output along
    each axis, and the bytes of ``resize.cu``'s ``make_layout`` for them
    (an f32 ``[3, tile_y, cols + taps_x4 - 1]`` intermediate, x weights
    padded to whole float4s, ``taps_x4`` per output column, (weight, row
    offset) pairs per output row, a tap count per output row and a first
    float4 per output column, then the staged rows at a 16-byte-aligned
    stride with room for a row's shift and 4-pixel reads past its end)."""
    tile_x = K1_TILE_X
    spans = []
    for n_in, n_out, tile, align in ((h, oh, tile_y, 1),
                                     (w, ow, tile_x, K1_COL_ALIGN)):
        first, last = staged_ranges(n_in, n_out, tile, align)
        lo, hi = resize_windows(n_in, n_out)
        spans += [int((last - first).max()) + 1, int((hi - lo).max()) + 1]
    rows, taps_y, cols, taps_x = spans
    taps_x4 = (taps_x + 6) // 4 * 4
    inter_stride = (cols + taps_x4 + 2) // 4 * 4
    fixed = (4 * 3 * tile_y * inter_stride + 4 * tile_x * taps_x4
             + 8 * tile_y * taps_y + 4 * (tile_y + tile_x))
    return Footprint(tile_y, tile_x, rows, cols, taps_y, taps_x,
                     _align16(fixed) + rows * _align16(cols * 3 + 29))


@functools.lru_cache(maxsize=64)
def resize_plan(h, w, oh, ow):
    """The footprint of the tallest tile in :data:`K1_TILE_Y` that fits in
    :data:`SMEM_LIMIT`; raises ``ValueError`` if a 1-row tile does not."""
    for tile_y in K1_TILE_Y:
        fp = resize_footprint(h, w, oh, ow, tile_y)
        if fp.smem_bytes <= SMEM_LIMIT:
            return fp
    raise ValueError(f'resize {h}x{w} -> {oh}x{ow}: a 1x{K1_TILE_X} tile '
                     f'needs {fp.smem_bytes} bytes of shared memory, more '
                     f'than {SMEM_LIMIT}')


def _check_frames(frames):
    if frames.dtype != torch.uint8 or frames.dim() != 4 \
            or frames.shape[-1] != 3 or not frames.is_contiguous():
        raise ValueError('expected contiguous uint8 frames [N,H,W,3], got '
                         f'{frames.dtype} {tuple(frames.shape)}')


def _check_dtype(dtype):
    if dtype not in _OUT_DTYPES:
        raise ValueError(f'output dtype must be one of {_OUT_DTYPES}')


def _recip(x):
    """1/x rounded to float32."""
    return float(np.float32(1.0) / np.float32(x))


def resize_bilinear(frames, out_hw, reverse_channels=False, scale=1.0,
                    dtype=torch.float32):
    """K1: uint8 ``[N,H,W,3]`` → ``[N,h,w,3]`` of ``dtype`` (f32 or bf16)."""
    if frames.device.type == 'cpu':
        return resize_bilinear_plain(frames, out_hw, reverse_channels, scale,
                                     dtype)
    if frames.device.type != 'cuda':
        raise ValueError(f'unsupported device {frames.device}')
    _check_frames(frames)
    _check_dtype(dtype)
    n, h, w, _ = frames.shape
    oh, ow = out_hw
    plan = resize_plan(h, w, oh, ow)
    out = torch.empty((n, oh, ow, 3), dtype=dtype, device=frames.device)
    err = library().tpd_resize_bilinear_u8(
        frames.data_ptr(), out.data_ptr(), n, h, w, oh, ow,
        1.0 / (oh / h), 1.0 / (ow / w), int(reverse_channels), scale,
        int(dtype == torch.bfloat16), *plan, *stream_args(frames))
    check(err, 'resize_bilinear')
    resize_bilinear.launches += 1
    return out


resize_bilinear.launches = 0


def crop_taps(size_out, side, start, size_in):
    """Source taps of a crop along one axis: for boxes with sides ``side``
    and starts ``start`` (float32 ``[...]``), output ``o`` samples ``s = (o
    + 0.5) * side/size_out - 0.5 + start`` clamped to ``[0, size_in - 1]``
    → (first index ``[..., size_out]``, second index, second's weight).
    XLA's arithmetic, which K2 repeats: side / size_out as a product with
    the f32 reciprocal, and (o + 0.5) * step - 0.5 as one fused
    multiply-add (emulated in float64: the product is exact)."""
    step = side * _recip(size_out)
    dst = torch.arange(size_out, dtype=torch.float32,
                       device=side.device) + 0.5
    s = (dst.double() * step[..., None].double() - 0.5).float()
    s = s + start[..., None]
    s = s.clamp(0.0, size_in - 1.0)
    f = s.floor()
    i0 = f.long()
    return i0, (i0 + 1).clamp(max=size_in - 1), s - f


CropFootprint = namedtuple('CropFootprint', 'band runs stride smem_bytes')


def crop_footprint(w, ow, band):
    """K2's shared memory for CTAs of ``band`` output rows of ``ow`` columns
    from frames ``w`` pixels wide (``crop.cu``'s ``make_layout``): a float2
    tap entry per output column, padded to ``runs`` runs of K2_RUN, and a
    float4 per band row, then the stage: K2_STAGE_BYTES, or two rows of
    ``stride`` bytes where that is more.  ``stride`` is the widest staged
    row: a whole frame row (a box may span it), its shift inside a 16-byte
    chunk and the three words read at its last pixel's taps."""
    runs = -(-ow // K2_RUN)
    stride = _align16(3 * w + 24)
    tables = _align16(8 * K2_RUN * runs + 16 * band)
    return CropFootprint(band, runs, stride,
                         tables + max(K2_STAGE_BYTES, 2 * stride))


@functools.lru_cache(maxsize=64)
def crop_plan(w, oh, ow, crops, sms):
    """The footprint of the tallest band in :data:`K2_BANDS` whose grid
    (``crops`` × bands of ``oh`` rows) gives each of ``sms`` SMs two CTAs,
    else of the shortest; raises ``ValueError`` if it does not fit in
    :data:`SMEM_LIMIT` (two frame rows are too wide to stage)."""
    band = next((b for b in K2_BANDS if crops * -(-oh // b) >= 2 * sms),
                K2_BANDS[-1])
    fp = crop_footprint(w, ow, band)
    if fp.smem_bytes > SMEM_LIMIT:
        raise ValueError(f'crop of frames {w} px wide to {ow} columns: two '
                         f'staged rows of {3 * w} bytes need '
                         f'{fp.smem_bytes} bytes of shared memory, more than '
                         f'SMEM_LIMIT={SMEM_LIMIT}')
    return fp


def crop_stage_rows(fp, c0, c1):
    """The source rows that a pass of K2 stages at once for a box whose
    taps span columns ``c0`` to ``c1``: the stage's bytes over a row of the
    span (``3 * (c1 - c0 + 1)`` bytes, its shift and the read past its
    last pixel), at least two."""
    return (fp.smem_bytes - _align16(8 * K2_RUN * fp.runs + 16 * fp.band)) \
        // _align16(3 * (c1 - c0 + 1) + 24)


def crop_passes(iy0, iy1, band, cap):
    """K2's passes over one crop's output rows, given the rows' taps (numpy,
    from :func:`crop_taps`), bands of ``band`` rows and ``cap`` staged rows
    a pass (:func:`crop_stage_rows`): a list of (first output row, staged
    source rows, staged index of each output row's top row, of its bottom
    row).  A pass takes the band's remaining rows when their rows fit, else
    the most that do; it stages the rows from its first top row to its
    last bottom row when they are at most two per output row, else a top
    and a bottom row per output row."""
    out = []
    for b0 in range(0, len(iy0), band):
        nrow, r0 = min(band, len(iy0) - b0), 0
        while r0 < nrow:
            first = b0 + r0
            lo = int(iy0[first])

            def rows(m):
                return int(iy1[first + m - 1]) - lo + 1

            def need(m):
                return min(rows(m), 2 * m)
            m = nrow - r0
            if need(m) > cap:
                m = 1
                while need(m + 1) <= cap:
                    m += 1
            t0, t1 = iy0[first:first + m], iy1[first:first + m]
            if rows(m) <= 2 * m:
                out.append((first, np.arange(lo, lo + rows(m)), t0 - lo,
                            t1 - lo))
            else:
                idx = 2 * np.arange(m)
                out.append((first, np.stack([t0, t1], 1).reshape(-1), idx,
                            idx + 1))
            r0 += m
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def crop_and_resize_plain(frames, boxes, out_hw=(224, 224),
                          reverse_channels=False, scale=(1.0, 1.0, 1.0),
                          offset=(0.0, 0.0, 0.0), mirror=False,
                          dtype=torch.float32):
    """``frames [N,H,W,C]``, ``boxes [N,K,4]`` xyxy px → crops
    ``[N*K,h,w,C]`` (with ``mirror``: ``[2*N*K,h,w,C]``, all originals then
    their horizontal mirrors).

    Output pixel ``(p, q)`` of a box samples ``y = (p + 0.5) * bh/h - 0.5 +
    y0`` (``bh`` floored at 1 px) with the rounding of the JAX program,
    clamped to ``[0, H-1]``, likewise in x,
    and interpolates the four neighbours bilinearly; then ``x * scale[c] -
    offset[c]`` per output channel."""
    n, h_in, w_in, _ = frames.shape
    k = boxes.shape[1]
    oh, ow = out_hw
    boxes = boxes.float()
    x0, y0, x1, y1 = boxes.unbind(-1)                               # [N,K]
    bw = (x1 - x0).clamp(min=1.0)
    bh = (y1 - y0).clamp(min=1.0)
    dev = frames.device
    iy0, iy1, wy = crop_taps(oh, bh, y0, h_in)                     # [N,K,h]
    ix0, ix1, wx = crop_taps(ow, bw, x0, w_in)                     # [N,K,w]
    img = frames.flip(-1) if reverse_channels else frames
    nidx = torch.arange(n, device=dev)[:, None, None, None]

    def tap(iy, ix):
        return img[nidx, iy[..., :, None], ix[..., None, :]].float()

    wy = wy[..., :, None, None]
    wx = wx[..., None, :, None]
    top = (1.0 - wx) * tap(iy0, ix0) + wx * tap(iy0, ix1)
    bot = (1.0 - wx) * tap(iy1, ix0) + wx * tap(iy1, ix1)
    v = (1.0 - wy) * top + wy * bot                             # [N,K,h,w,C]
    s = torch.tensor(scale, dtype=torch.float32, device=dev)
    o = torch.tensor(offset, dtype=torch.float32, device=dev)
    v = (v * s - o).reshape(n * k, oh, ow, -1)
    if mirror:
        v = torch.cat([v, v.flip(2)])
    return v.to(dtype)


def crop_and_resize(frames, boxes, out_hw=(224, 224), reverse_channels=False,
                    scale=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0),
                    mirror=False, dtype=torch.float32):
    """K2: see :func:`crop_and_resize_plain`.  On the card ``boxes`` must be
    a contiguous float32 ``[N,K,4]`` tensor on the frames' device; it is
    read by the kernel, so the host never waits for it.  Raises where two
    frame rows are too wide to stage (:func:`crop_plan`)."""
    if frames.device.type == 'cpu':
        return crop_and_resize_plain(frames, boxes, out_hw, reverse_channels,
                                     scale, offset, mirror, dtype)
    if frames.device.type != 'cuda':
        raise ValueError(f'unsupported device {frames.device}')
    _check_frames(frames)
    _check_dtype(dtype)
    n, h, w, _ = frames.shape
    if boxes.dtype != torch.float32 or boxes.dim() != 3 \
            or boxes.shape[0] != n or boxes.shape[2] != 4 \
            or not boxes.is_contiguous() or boxes.device != frames.device:
        raise ValueError('expected contiguous float32 boxes [N,K,4] on '
                         f'{frames.device}, got {boxes.dtype} '
                         f'{tuple(boxes.shape)} on {boxes.device}')
    k = boxes.shape[1]
    oh, ow = out_hw
    if not 0 < n * k <= 65535:
        raise ValueError(f'{n * k} boxes: K2 takes 1 to 65535 per call')
    plan = crop_plan(w, oh, ow, n * k, _sm_count(frames.device))
    out = torch.empty(((2 if mirror else 1) * n * k, oh, ow, 3), dtype=dtype,
                      device=frames.device)
    err = library().tpd_crop_resize_u8(
        frames.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, h, w, k, oh,
        ow, _recip(oh), _recip(ow), int(reverse_channels), *scale, *offset,
        int(mirror), int(dtype == torch.bfloat16), *plan,
        *stream_args(frames))
    check(err, 'crop_and_resize')
    crop_and_resize.launches += 1
    return out


crop_and_resize.launches = 0
