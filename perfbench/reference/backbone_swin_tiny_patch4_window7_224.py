"""Swin-T (Liu et al., arXiv:2103.14030; ``microsoft/Swin-Transformer``
``configs/swin/swin_tiny_patch4_window7_224.yaml``) as the benchmark's
plain float32 reference of the regressor's backbone: patch 4, embed 96,
depths 2-2-6-2, heads 3-6-12-24 of 32 channels, window 7 with alternate
blocks shifted by 3 (not where the map is one window) and masked at −100
between the regions the shift joined, a relative-position bias over 13×13
offsets, MLP ratio 4 with the exact GELU, qkv bias, pre-norm LayerNorm,
patch merging, a final LayerNorm.

A frozen copy of the repo's reference (``tests/torch_port_swin_reference.py``)
as the benchmark was written, on ``models.conv``, ``linear`` and
``matmul`` (QKᵀ and AV), so that the control rounds every product to
float8 and the yardstick counts it.  Its departures from the published
code are the repo reference's: the map's sides multiples of the window
(224² crops), ``q kᵀ`` scaled after the product, no stochastic depth (the
cell serves).  Parameters are named as the port's ``models/swin.py``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .models import conv, linear, matmul

EMBED, DEPTHS, HEADS, WINDOW, PATCH = 96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 4
HEAD_DIM = 32
MASK_VALUE = -100.0
# the std the harness draws the relative-position tables with: a bias of
# the size of the logits (whose std is about 1 at the drawn weights), so
# that the bias decides part of each attention (a trained Swin-T's tables
# reach several units) and leaving it out shows in the keypoints
TABLE_STD = 1.0


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws):
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing='ij'))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attention_mask(h, w, ws, shift):
    img_mask = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return mask.masked_fill(mask != 0, MASK_VALUE).masked_fill(mask == 0,
                                                               0.0)


def layer_norm(x, ln):
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class WindowAttention(nn.Module):

    def __init__(self, dim, heads, ws):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        d = c // self.heads
        qkv = linear(x, self.qkv).reshape(b_, n, 3, self.heads, d) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = matmul(q, k.transpose(-2, -1)) * d ** -0.5
        idx = relative_position_index(self.ws).view(-1).to(x.device)
        bias = self.relative_position_bias_table[idx].view(n, n, -1) \
            .permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.heads, n, n) \
                + mask[None, :, None]
            attn = attn.view(-1, self.heads, n, n)
        x = matmul(attn.softmax(-1), v).transpose(1, 2).reshape(b_, n, c)
        return linear(x, self.proj)


class Mlp(nn.Module):

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class Block(nn.Module):

    def __init__(self, dim, heads, ws, shift):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        b, h, w, c = x.shape
        # the official rule: no shift where the map is one window
        ws, s = self.ws, self.shift if min(h, w) > self.ws else 0
        shortcut = x
        x = layer_norm(x, self.norm1)
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        windows = window_partition(x, ws).view(-1, ws * ws, c)
        mask = attention_mask(h, w, ws, s).to(x.device) if s > 0 else None
        windows = self.attn(windows, mask).view(-1, ws, ws, c)
        x = window_reverse(windows, ws, h, w)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = shortcut + x
        return x + self.mlp(layer_norm(x, self.norm2))


class PatchMerging(nn.Module):

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return linear(layer_norm(x, self.norm), self.reduction)


class Stage(nn.Module):

    def __init__(self, dim, depth, heads, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(dim, heads, WINDOW, WINDOW // 2 if i % 2 else 0)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):

    def __init__(self):
        super().__init__()
        self.proj = nn.Conv2d(3, EMBED, PATCH, PATCH)
        self.norm = nn.LayerNorm(EMBED)

    def forward(self, x):
        return layer_norm(conv(x, self.proj).permute(0, 2, 3, 1), self.norm)


class Backbone(nn.Module):
    feature_dim = EMBED * 2 ** (len(DEPTHS) - 1)

    def __init__(self):
        super().__init__()
        self.patch_embed = PatchEmbed()
        self.layers = nn.ModuleList(
            Stage(EMBED * 2 ** i, d, nh, i < len(DEPTHS) - 1)
            for i, (d, nh) in enumerate(zip(DEPTHS, HEADS)))
        self.norm = nn.LayerNorm(self.feature_dim)

    def features(self, x, train=False):
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        return layer_norm(x, self.norm).permute(0, 3, 1, 2)

    def head(self, pooled, train=False):
        return pooled


def leaf_std(name, p):
    return TABLE_STD if name.endswith('relative_position_bias_table') \
        else None


def attention_work(rows, crop, itemsize):
    """``(bytes, ops)`` of the shifted-window attention of one forward over
    ``rows`` crops: the least any implementation moves (each token's q, k
    and v read once, its output written once, each block's bias table)
    and its products, 2·(2·49·49·32) a window and head, over the 12
    blocks."""
    n_bytes = n_ops = 0
    side_h, side_w = crop[0] // PATCH, crop[1] // PATCH
    for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        c = EMBED * 2 ** i
        tokens = rows * side_h * side_w
        windows = tokens // (WINDOW * WINDOW)
        n_bytes += depth * (tokens * 4 * c * itemsize
                            + (2 * WINDOW - 1) ** 2 * heads * 4)
        n_ops += depth * windows * heads * 2 * (
            2 * WINDOW ** 4 * HEAD_DIM)
        side_h, side_w = side_h // 2, side_w // 2
    return n_bytes, n_ops


def bounds(rows, crop, itemsize, train):
    """The least time of K8 ``window_attention`` in one call over ``rows``
    crops, at the bf16 tensor cores' peak (the forward's work: the train
    step computes the attention without K8)."""
    from harness.yardstick import PEAK_BF16_FLOPS, bound_s
    n_bytes, n_ops = attention_work(rows, crop, itemsize)
    return {'window_attention': bound_s(n_bytes, n_ops,
                                        peak_ops=PEAK_BF16_FLOPS)}
