"""A plain float32 reference of Swin-T as the port's stage-2 regressor,
written from the paper (Liu et al., arXiv:2103.14030) and the official
``microsoft/Swin-Transformer`` model (``models/swin_transformer.py``,
``configs/swin/swin_tiny_patch4_window7_224.yaml``), for the CPU tests of
``tpudet3d_torch/models/swin.py`` and kernel K8's plain version.  It
imports no JAX and no module of ``tpudet3d_torch``.

The official arithmetic step by step: ``torch.roll`` of the map by
``-shift``, ``window_partition``, the attention of each window with the
relative-position bias gathered through ``relative_position_index`` and
the shift mask built from ``img_mask`` slices, ``window_reverse``, the
roll back.  Parameters are named as the port's (and the official
model's), so one ``state_dict`` loads into both.

Departures from the published code, each noted where it is made:

* no absolute position embedding, no dropout inside the blocks, and the
  map's sides multiples of the window, as the Swin-T config has it (the
  padding for other sizes is left out);
* the attention scales ``q @ kᵀ`` by ``d^-½`` after the product, where the
  official code scales ``q`` before it: the same in exact arithmetic;
* stochastic depth keeps a sample where its uniform draw is below the
  keep probability (the official ``floor(keep + u)`` keeps it at or above
  the rate): the same distribution, and the draw the port makes, so that
  a test can give both the same masks from one seeded generator.  One
  draw ``[B]`` a branch in block order, attention before MLP, none at a
  rate of 0 (the official ``nn.Identity``);
* the 1000-class head is replaced by the port's regressor head: nine
  keypoint heads ``[9, C, 18]`` and a class layer over the pooled
  features, the class layer's input dropped out at 0.5 in training after
  the backbone's draws; its loss is the port's configuration of it
  (``l1 + 0.1·ADD + 0.2·CE`` on the ground-truth class's sigmoid
  keypoints).

``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are switched off on import.
"""

import torch
import torch.nn.functional as F
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MASK_VALUE = -100.0


def window_partition(x, ws):
    """``[B, H, W, C]`` → ``[B·nW, ws, ws, C]``."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    """``[B·nW, ws, ws, C]`` → ``[B, H, W, C]``."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws):
    """The official ``relative_position_index`` ``[ws², ws²]``."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing='ij'))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attention_mask(h, w, ws, shift):
    """The official ``attn_mask`` ``[nW, ws², ws²]`` of a map shifted by
    ``-shift``: ``img_mask`` counts the 3×3 slices, and pairs of windows'
    tokens from different slices get −100."""
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


def drop_path(x, rate, generator):
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],), generator=generator,
                   device=generator.device).to(x.device)
    return torch.where((u < keep).view(-1, 1, 1, 1), x / keep, 0.0)


class WindowAttention(nn.Module):

    def __init__(self, dim, heads, ws):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        """x ``[B·nW, N, C]``; mask ``[nW, N, N]`` or None."""
        b_, n, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).reshape(b_, n, 3, self.heads, d) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * d ** -0.5
        idx = relative_position_index(self.ws).view(-1)
        bias = self.relative_position_bias_table[idx].view(n, n, -1) \
            .permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.heads, n, n) \
                + mask[None, :, None]
            attn = attn.view(-1, self.heads, n, n)
        attn = attn.softmax(-1)
        x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(x)


class Mlp(nn.Module):

    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):

    def __init__(self, dim, heads, ws, shift, drop_path_rate):
        super().__init__()
        self.ws, self.shift, self.rate = ws, shift, drop_path_rate
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, train=False, generator=None):
        b, h, w, c = x.shape
        ws, s = self.ws, self.shift
        rate = self.rate if train else 0.0
        shortcut = x
        x = self.norm1(x)
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        windows = window_partition(x, ws).view(-1, ws * ws, c)
        mask = attention_mask(h, w, ws, s) if s > 0 else None
        windows = self.attn(windows, mask).view(-1, ws, ws, c)
        x = window_reverse(windows, ws, h, w)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = shortcut + drop_path(x, rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


class PatchMerging(nn.Module):

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], -1)))


class BasicLayer(nn.Module):

    def __init__(self, dim, depth, heads, ws, resolution, rates, downsample):
        super().__init__()
        # the official rule: no shift where the map is one window
        shift = 0 if resolution <= ws else ws // 2
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, ws, 0 if i % 2 == 0 else shift,
                                 rates[i]) for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, train=False, generator=None):
        for blk in self.blocks:
            x = blk(x, train, generator)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):

    def __init__(self, embed_dim, patch=4):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch, patch)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class SwinTransformer(nn.Module):
    """The backbone; Swin-T by default at a 224² input."""

    def __init__(self, img_size=224, embed_dim=96, depths=(2, 2, 6, 2),
                 heads=(3, 6, 12, 24), window=7, drop_path_rate=0.0):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        dpr = [x.item() for x in torch.linspace(0, drop_path_rate,
                                                sum(depths))]
        self.layers = nn.ModuleList()
        res = img_size // 4
        for i, depth in enumerate(depths):
            self.layers.append(BasicLayer(
                embed_dim * 2 ** i, depth, heads[i], window, res,
                dpr[sum(depths[:i]):sum(depths[:i + 1])],
                downsample=i < len(depths) - 1))
            res //= 2
        self.feature_dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.feature_dim)
        self.res0 = img_size // 4

    def forward(self, x, train=False, generator=None):
        """NCHW ``[B, 3, H, W]`` → pooled ``[B, feature_dim]``."""
        x = self.patch_embed(x)
        x = x.view(x.shape[0], self.res0, self.res0, -1)
        for layer in self.layers:
            x = layer(x, train, generator)
        return self.norm(x).mean(dim=(1, 2))


class Regressor(nn.Module):
    """Swin under the port's regressor head: NHWC crops → ``[B, 9, 18]``
    pre-activations and class logits; with ``cats`` the ground-truth
    class's sigmoid keypoints ``[B, 9, 2]`` and the logits."""

    def __init__(self, dropout_rate=0.5, **swin):
        super().__init__()
        self.backbone = SwinTransformer(**swin)
        c = self.backbone.feature_dim
        self.dropout_rate = dropout_rate
        self.head_kernel = nn.Parameter(torch.zeros(9, c, 18))
        self.head_bias = nn.Parameter(torch.zeros(9, 18))
        self.cls_fc = nn.Linear(c, 9)

    def forward(self, x, cats=None, train=False, generator=None):
        pooled = self.backbone(x.permute(0, 3, 1, 2).float(), train,
                               generator)
        b = pooled.shape[0]
        all_kp = torch.einsum('bc,hcp->bhp', pooled, self.head_kernel) \
            + self.head_bias
        if cats is None:
            return all_kp, self.cls_fc(pooled)
        kp = torch.sigmoid(all_kp[torch.arange(b), cats]).view(b, 9, 2)
        if train and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            u = torch.rand(pooled.shape, generator=generator,
                           device=generator.device).to(pooled.device)
            pooled = torch.where(u < keep, pooled / keep, 0.0)
        return kp, self.cls_fc(pooled)


def loss(kp, gt_kp, logits, cats):
    """``l1 + 0.1·ADD + 0.2·CE``: the mean absolute keypoint error, the mean
    over the batch of each sample's summed keypoint distances, and the
    softmax cross-entropy."""
    l1 = (kp - gt_kp).abs().mean()
    add = torch.linalg.norm(kp - gt_kp, dim=2).sum(1).mean()
    ce = F.cross_entropy(logits, cats.long())
    return l1 + 0.1 * add + 0.2 * ce
