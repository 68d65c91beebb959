"""The plain float32 reference of the serving path's image stages: the
detector input (K1: antialiased bilinear resize of uint8 BGR frames, as
``jax.image.resize``) and the regressor's crops (K2: bilinear crops with
pixel-centre sampling and a border clamp, then ``x * scale - offset``).
A frozen copy of the port's plain versions in ``ops/image.py``."""

import numpy as np
import torch


def resize_weights(n_in, n_out, device=None):
    """``[n_out, n_in]`` triangle-filter weights, widened by ``n_in/n_out``
    when downscaling, each row summing to 1."""
    inv = 1.0 / (n_out / n_in)
    k = max(inv, 1.0)
    s = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    grid = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (s[:, None] - grid[None, :]).abs() / k).clamp(min=0.0)
    total = w.sum(1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize(frames, out_hw, reverse_channels=True, scale=1.0):
    """uint8 ``[N,H,W,3]`` → float32 ``[N,h,w,3]``."""
    x = frames.float()
    if reverse_channels:
        x = x.flip(-1)
    x = torch.einsum('oh,nhwc->nowc',
                     resize_weights(x.shape[1], out_hw[0], x.device), x)
    x = torch.einsum('pw,nowc->nopc',
                     resize_weights(x.shape[2], out_hw[1], x.device), x)
    return x * scale


def _recip(x):
    return float(np.float32(1.0) / np.float32(x))


def crop_taps(size_out, side, start, size_in):
    step = side * _recip(size_out)
    dst = torch.arange(size_out, dtype=torch.float32, device=side.device) \
        + 0.5
    s = (dst.double() * step[..., None].double() - 0.5).float()
    s = (s + start[..., None]).clamp(0.0, size_in - 1.0)
    f = s.floor()
    i0 = f.long()
    return i0, (i0 + 1).clamp(max=size_in - 1), s - f


def crop(frames, boxes, out_hw, reverse_channels=True, scale=(1.0,) * 3,
         offset=(0.0,) * 3):
    """uint8 ``[N,H,W,3]`` and xyxy pixel boxes ``[N,K,4]`` → float32 crops
    ``[N*K,h,w,3]``."""
    n, h_in, w_in, _ = frames.shape
    k = boxes.shape[1]
    oh, ow = out_hw
    x0, y0, x1, y1 = boxes.float().unbind(-1)
    bw = (x1 - x0).clamp(min=1.0)
    bh = (y1 - y0).clamp(min=1.0)
    iy0, iy1, wy = crop_taps(oh, bh, y0, h_in)
    ix0, ix1, wx = crop_taps(ow, bw, x0, w_in)
    img = frames.flip(-1) if reverse_channels else frames
    nidx = torch.arange(n, device=frames.device)[:, None, None, None]

    def tap(iy, ix):
        return img[nidx, iy[..., :, None], ix[..., None, :]].float()

    wy = wy[..., :, None, None]
    wx = wx[..., None, :, None]
    top = (1.0 - wx) * tap(iy0, ix0) + wx * tap(iy0, ix1)
    bot = (1.0 - wx) * tap(iy1, ix0) + wx * tap(iy1, ix1)
    v = (1.0 - wy) * top + wy * bot
    s = torch.tensor(scale, dtype=torch.float32, device=frames.device)
    o = torch.tensor(offset, dtype=torch.float32, device=frames.device)
    return (v * s - o).reshape(n * k, oh, ow, -1)
