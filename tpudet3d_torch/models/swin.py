"""Swin Transformer backbone (Liu et al., arXiv:2103.14030) for the
multi-head regressor; ``swin_tiny_patch4_window7_224`` is Swin-T as the
official ``configs/swin/swin_tiny_patch4_window7_224.yaml`` of
``microsoft/Swin-Transformer`` sets it: a 4×4 patch embedding to 96
channels with LayerNorm, four stages of 2, 2, 6 and 2 blocks at 56², 28²,
14² and 7² (for a 224² crop) with 3, 6, 12 and 24 heads of 32 channels,
7×7 windows, patch merging between stages, and a final LayerNorm.  The
JAX package has no counterpart.

A block is pre-norm: ``x + drop_path(proj(attention(qkv(LN(x)))))``, then
``x + drop_path(fc2(GELU(fc1(LN(x)))))``, MLP ratio 4, the exact GELU
(``F.gelu``, in float32 for bfloat16 input).  Odd blocks attend within
the windows of the map cyclically shifted by ``window // 2``, masked
between the regions the shift joined, except where the map is one window
(:func:`block_shift`).  The attention of all windows and heads is one
call of ``ops/attention.py`` ``window_attention`` on the qkv projection's
output over the whole map: kernel K8 on the card (bfloat16 only), so no
roll, window partition, mask or expanded bias exists there.  K8 has no
backward, so training calls the plain version, ``window_attention_plain``,
on every device.  Stochastic depth grows linearly over the blocks from 0
to ``drop_path_rate`` and draws its masks from the caller's generator in
training (``layers.drop_path``).

Tokens are kept as ``[B, H, W, C]`` maps; ``features`` takes the NCHW
(``channels_last``) view the wrapper hands over and returns the final
map as such a view, ``[B, 768, 7, 7]``; ``head`` is the identity (the
final LayerNorm runs before the pool).  Submodules and parameters are
named as in the official model (``layers.i.blocks.j.attn.qkv``,
``...attn.relative_position_bias_table``, ``layers.i.downsample``), with
no buffers: the relative index and the mask are computed.  The map's
sides must be multiples of the window at every stage (224² crops for
Swin-T); the official code's padding for other sizes is not ported.
Each stage, with the patch embedding before the first, the merging after
it and the final LayerNorm after the last, is a span
``tpudet3d_torch.swin.stage1`` … ``stage4``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import window_attention, window_attention_plain
from ..utils.profiling import annotate
from .layers import conv, drop_path, layer_norm, linear

__all__ = ['SwinTransformer', 'SWIN_PARAMS', 'block_shift']

SWIN_PARAMS = {
    'swin_tiny_patch4_window7_224': dict(embed_dim=96, depths=(2, 2, 6, 2),
                                         heads=(3, 6, 12, 24), window=7),
}


def block_shift(index, resolution, window):
    """The cyclic shift of block ``index`` of a stage whose map's shorter
    side is ``resolution``: ``window // 2`` on odd blocks, 0 on even ones
    and on a map of one window (the official code sets the shift to 0
    where the resolution is at most the window)."""
    return window // 2 if index % 2 and resolution > window else 0


class PatchEmbed(nn.Module):

    def __init__(self, embed_dim, patch=4):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch, patch)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        y = conv(x, self.proj).permute(0, 2, 3, 1).contiguous()
        return layer_norm(y, self.norm)


class WindowAttention(nn.Module):
    """qkv and output projections around ``window_attention``, with the
    learned relative-position bias table ``[(2·window - 1)², heads]``."""

    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    @torch.no_grad()
    def init_own(self, generator):
        # the official init: a normal of std 0.02 truncated at ±2
        nn.init.trunc_normal_(self.relative_position_bias_table, 0.0, 0.02,
                              -2.0, 2.0, generator=generator)

    def forward(self, x, shift, train=False):
        qkv = linear(x, self.qkv)
        # K8 has no backward: training takes the plain version
        attend = window_attention_plain if train else window_attention
        out = attend(qkv, self.relative_position_bias_table, self.heads,
                     self.window, shift)
        return linear(out, self.proj)


class Mlp(nn.Module):

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class SwinBlock(nn.Module):

    def __init__(self, dim, heads, window, index, drop_path_rate,
                 mlp_ratio=4):
        super().__init__()
        self.window, self.index = window, index
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x, train=False, generator=None):
        shift = block_shift(self.index, min(x.shape[1:3]), self.window)
        rate = self.drop_path_rate if train else 0.0
        x = x + drop_path(self.attn(layer_norm(x, self.norm1), shift, train),
                          rate, generator)
        return x + drop_path(self.mlp(layer_norm(x, self.norm2)), rate,
                             generator)


class PatchMerging(nn.Module):
    """Each 2×2 group of tokens concatenated (in the official order:
    (0, 0), (1, 0), (0, 1), (1, 1) as (row, column)), LayerNorm(4C), then
    a bias-free linear 4C → 2C."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return linear(layer_norm(x, self.norm), self.reduction)


class SwinStage(nn.Module):

    def __init__(self, dim, heads, window, rates, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, window, j, r)
                                    for j, r in enumerate(rates))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, train=False, generator=None):
        for blk in self.blocks:
            x = blk(x, train, generator)
        return x if self.downsample is None else self.downsample(x)


class SwinTransformer(nn.Module):

    def __init__(self, embed_dim=96, depths=(2, 2, 6, 2),
                 heads=(3, 6, 12, 24), window=7, drop_path_rate=0.0):
        super().__init__()
        self.drop_path_rate = float(drop_path_rate)
        self.patch_embed = PatchEmbed(embed_dim)
        rates = torch.linspace(0, self.drop_path_rate, sum(depths)).tolist()
        stages, first = [], 0
        for i, (depth, nh) in enumerate(zip(depths, heads)):
            stages.append(SwinStage(embed_dim * 2 ** i, nh, window,
                                    rates[first:first + depth],
                                    downsample=i < len(depths) - 1))
            first += depth
        self.layers = nn.ModuleList(stages)
        self.feature_dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.feature_dim)

    def features(self, x, train=False, generator=None):
        last = len(self.layers) - 1
        for i, stage in enumerate(self.layers):
            with annotate(f'tpudet3d_torch.swin.stage{i + 1}'):
                if i == 0:
                    x = self.patch_embed(x)
                x = stage(x, train, generator)
                if i == last:
                    x = layer_norm(x, self.norm)
        return x.permute(0, 3, 1, 2)

    def head(self, pooled, train=False):
        return pooled        # the final LayerNorm ran before the pool
