"""Shifted-window self-attention of the Swin regressor, kernel K8.

``window_attention_plain`` is the plain PyTorch version of K8
(``kernels/csrc/window_attn.cu``) and ``window_attention`` its wrapper.
Both take the qkv projection's output on the whole token map,
``[B, H, W, 3C]`` (per token ``q``, ``k``, ``v`` of C channels each, head
``h`` at channels ``h·d … h·d + d - 1`` of each, d = C / heads), and
return the attention's output on the same map, ``[B, H, W, C]``, ready for
the output projection.  Per window of ``window × window`` tokens and per
head, on the map cyclically shifted by ``-shift`` in both axes (Liu et
al., arXiv:2103.14030, §3.2):

1. ``s = (q @ kᵀ) · d^-½ + bias + mask`` in float32, ``bias[h, i, j] =
   table[relative_index(window)[i, j], h]`` (:func:`relative_bias`; no
   bias when ``table`` is None) and ``mask`` −100 between tokens from
   different regions of the shifted map (:func:`shift_mask`) when
   ``masked``, which defaults to ``shift > 0`` (no table, and a shift
   without its mask, are the benchmark's planted faults);
2. ``p = softmax(s)`` in float32, rounded to the input's dtype;
3. ``o = p @ v``, accumulated in float32, rounded to the input's dtype
   and written back at each token's unshifted position.

The plain version makes the roll, the window partition, the bias and the
mask as tensors; K8 reads each window's tokens at their shifted positions
in place, gathers the bias from the table and computes the mask from the
window's position, so none of them exists on the card.  The wrapper
takes the plain version for CPU tensors and launches K8 for every CUDA
tensor, raising ``ValueError`` for an input K8 cannot take: another dtype
than bfloat16, a head size other than 32, a window above 8, or a tensor
that needs a gradient (K8 has no backward: the train step calls
``window_attention_plain`` itself, ``models/swin.py``).
``window_attention.launches`` counts the kernel launches.
"""

import functools

import torch

from ..kernels.build import check, library, stream_args

__all__ = ['relative_index', 'relative_bias', 'shift_regions', 'shift_mask',
           'window_attention_plain', 'window_attention', 'MASK_VALUE',
           'K8_HEAD_DIM', 'K8_MAX_WINDOW']

MASK_VALUE = -100.0      # added to the logits of masked pairs
K8_HEAD_DIM = 32
K8_MAX_WINDOW = 8        # K8 pads a window's tokens to 64


@functools.lru_cache(maxsize=None)
def _relative_index(window):
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing='ij')
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def relative_index(window, device=None):
    """``[n, n]`` (n = window²) row of the bias table of each pair of a
    window's tokens, query ``i`` and key ``j`` in row-major order:
    ``(yi - yj + window - 1)·(2·window - 1) + xi - xj + window - 1``."""
    return _relative_index(int(window)).to(device)


def relative_bias(table, window):
    """``[heads, n, n]`` bias of table ``[(2·window - 1)², heads]``."""
    n = window * window
    idx = relative_index(window, table.device).reshape(-1)
    return table[idx].view(n, n, -1).permute(2, 0, 1)


def shift_regions(h, w, window, shift):
    """``[h, w]`` region of each position of the map shifted by ``-shift``:
    rows (and likewise columns) ``[0, h - window)``, ``[h - window,
    h - shift)`` and ``[h - shift, h)`` are regions 0, 1, 2 of their axis,
    the position's region ``3·row region + column region``."""
    def axis(size):
        i = torch.arange(size)
        return (i >= size - window).long() + (i >= size - shift).long()
    return axis(h)[:, None] * 3 + axis(w)[None, :]


def shift_mask(h, w, window, shift, device=None):
    """``[windows, n, n]`` float32: :data:`MASK_VALUE` between two tokens of
    a window of the shifted map that lie in different regions
    (:func:`shift_regions`), else 0; windows in row-major order."""
    r = shift_regions(h, w, window, shift)
    r = r.view(h // window, window, w // window, window).permute(0, 2, 1, 3) \
        .reshape(-1, window * window)
    mask = (r[:, :, None] != r[:, None, :]).float() * MASK_VALUE
    return mask.to(device)


def _check_args(qkv, table, heads, window, shift):
    if qkv.dim() != 4 or qkv.shape[3] % (3 * heads):
        raise ValueError(f'qkv {tuple(qkv.shape)} is not [B, H, W, 3C] with '
                         f'C a multiple of {heads} heads')
    b, h, w, _ = qkv.shape
    if h % window or w % window:
        raise ValueError(f'a {h}x{w} map does not split into {window}x'
                         f'{window} windows')
    if not 0 <= shift < window:
        raise ValueError(f'shift {shift} outside [0, {window})')
    if table is not None and tuple(table.shape) != ((2 * window - 1) ** 2,
                                                    heads):
        raise ValueError(f'bias table {tuple(table.shape)} is not '
                         f'[{(2 * window - 1) ** 2}, {heads}]')


def window_attention_plain(qkv, table, heads, window, shift, masked=None):
    """qkv ``[B, H, W, 3C]`` → ``[B, H, W, C]`` in qkv's dtype; see the
    module's docstring."""
    _check_args(qkv, table, heads, window, shift)
    masked = shift > 0 if masked is None else masked
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    nh, nw, n = h // window, w // window, window * window
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.reshape(b, nh, window, nw, window, 3, heads, d) \
        .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nh * nw, heads, n, d)
    q, k, v = x.float().unbind(0)
    s = (q @ k.transpose(-1, -2)) * d ** -0.5
    if table is not None:
        s = s + relative_bias(table.float(), window)
    if masked:
        s = s + shift_mask(h, w, window, shift, qkv.device)[:, None]
    p = torch.softmax(s, -1).to(qkv.dtype).float()
    o = (p @ v).to(qkv.dtype)                      # [B, windows, heads, n, d]
    o = o.view(b, nh, nw, heads, window, window, d) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def window_attention(qkv, table, heads, window, shift, masked=None):
    """K8: see :func:`window_attention_plain`.  On the card qkv is a
    contiguous bfloat16 tensor with 32 channels a head and the table a
    float32 tensor on its device; the output is a new contiguous tensor
    allocated through PyTorch's caching allocator, and the launch is on
    the current stream, so a CUDA graph may capture it."""
    if qkv.device.type == 'cpu':
        return window_attention_plain(qkv, table, heads, window, shift,
                                      masked)
    if qkv.device.type != 'cuda':
        raise ValueError(f'unsupported device {qkv.device}')
    _check_args(qkv, table, heads, window, shift)
    masked = shift > 0 if masked is None else masked
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f'K8 takes bfloat16 qkv, got {qkv.dtype}')
    if c // heads != K8_HEAD_DIM or window > K8_MAX_WINDOW:
        raise ValueError(f'K8 takes {K8_HEAD_DIM} channels a head and a '
                         f'window of at most {K8_MAX_WINDOW}, got '
                         f'{c // heads} and {window}')
    if torch.is_grad_enabled() and (
            qkv.requires_grad or (table is not None and table.requires_grad)):
        raise ValueError('K8 has no backward: take window_attention_plain '
                         'where a gradient is needed')
    if not qkv.is_contiguous():
        raise ValueError('K8 needs a contiguous qkv')
    if table is not None and (table.dtype != torch.float32
                              or not table.is_contiguous()
                              or table.device != qkv.device):
        raise ValueError(f'K8 needs a contiguous float32 table on '
                         f'{qkv.device}, got {table.dtype} on '
                         f'{table.device}')
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    err = library().tpd_window_attention(
        qkv.data_ptr(), 0 if table is None else table.data_ptr(),
        out.data_ptr(), b, h, w, c, heads, window, int(shift), int(masked),
        float(K8_HEAD_DIM ** -0.5), *stream_args(qkv))
    check(err, 'window_attention')
    window_attention.launches += 1
    return out


window_attention.launches = 0
