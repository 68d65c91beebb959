"""Multi-head 3D-vertex regressor (counterpart of
``tpudet3d/models/wrapper.py``), for serving, export and training.

All 9 per-class heads are one ``[9, C, 18]`` tensor, so one matmul computes
every head for every sample.  ``forward(x)`` returns the export convention
of the JAX module's ``export=True``: sigmoid keypoints for all heads as
``[9, B, 9, 2]`` plus class logits ``[B, num_classes]``.  With
``pre_activation=True`` it returns the heads before the sigmoid,
``[B, 9, 18]`` float32 with the bias added, plus the same logits: the
serving engine finishes them with kernel K4 (``infer/epilogue.py``).

``forward(x, cats=cats)`` is the JAX module's training and evaluation
branch: the head of each sample's ground-truth class, ``[B, 9, 2]`` after
the sigmoid, in float32, plus the logits.  ``train=True`` (keyword-only)
adds the training batch norm (``layers.batch_norm``), a Swin backbone's
stochastic depth and the classifier's dropout, whose masks are drawn from
the caller's ``generator``.
"""

import math

import torch
from torch import nn

from ..parallel.sharding import local_rows, world
from .layers import global_pool, linear, model_input

__all__ = ['MultiHeadRegressor', 'MAX_CLASSES', 'dropout']

MAX_CLASSES = 9


def dropout(x, rate, generator):
    """Flax's ``nn.Dropout``: keep each value with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``.  The uniform draws come
    from ``generator`` on its own device, so one seed gives one mask on
    either device."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError('dropout at a rate above 0 needs a generator')
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    # under a process group the mask is drawn for the global batch and
    # this process keeps its rows, as one process over that batch
    u = local_rows(torch.rand((x.shape[0] * world(), *x.shape[1:]),
                              generator=generator, device=generator.device))
    return torch.where(u.to(x.device) < keep, x / keep, 0.0)


class MultiHeadRegressor(nn.Module):
    """``forward(x)``: NHWC crops ``[B,h,w,3]`` → (kp, logits).  ``dtype`` is
    the compute dtype of the backbone and of ``cls_fc``; the head matmul
    runs in float32, as the JAX module's einsum does."""

    def __init__(self, backbone, num_classes=9, num_points=18,
                 pooling_mode='avg', dtype=torch.float32, dropout_rate=0.5):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.num_points = num_points
        self.pooling_mode = pooling_mode
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        feature_dim = backbone.feature_dim
        self.head_kernel = nn.Parameter(
            torch.zeros(MAX_CLASSES, feature_dim, num_points))
        self.head_bias = nn.Parameter(torch.zeros(MAX_CLASSES, num_points))
        self.cls_fc = nn.Linear(feature_dim, num_classes)

    @torch.no_grad()
    def init_heads(self, generator):
        # variance_scaling(1/3, fan_in, uniform) over the [9, C, 18] kernel:
        # fan_in = C * 9, limit = sqrt(3 * (1/3) / fan_in)
        fan_in = self.head_kernel.shape[0] * self.head_kernel.shape[1]
        limit = math.sqrt(1.0 / fan_in)
        self.head_kernel.uniform_(-limit, limit, generator=generator)
        self.head_bias.zero_()

    def forward(self, x, pre_activation=False, *, cats=None, train=False,
                generator=None):
        x = model_input(x, self.dtype)
        # a backbone with stochastic depth draws its masks from the
        # generator, before the classifier's dropout; the others'
        # features(x, train) take no generator
        draws = getattr(self.backbone, 'drop_path_rate', 0.0)
        feats = self.backbone.features(
            x, train, **({'generator': generator} if draws else {}))
        pooled = self.backbone.head(global_pool(feats, self.pooling_mode),
                                    train)
        pooled = pooled.to(self.head_kernel.dtype)   # the heads: float32
        b, c = pooled.shape
        # every head in one matmul with the bias added, straight into the
        # [B, 9, 18] layout (the [9, C, 18] kernel is copied to [C, 9·18])
        all_kp = torch.addmm(
            self.head_bias.reshape(-1), pooled,
            self.head_kernel.permute(1, 0, 2).reshape(c, -1)).view(
            b, MAX_CLASSES, self.num_points)
        if cats is not None:
            return self._select(all_kp, pooled, cats, train, generator)
        if self.num_classes > 1:
            logits = linear(pooled.to(self.dtype), self.cls_fc)
        else:
            logits = torch.zeros((b,), dtype=pooled.dtype, device=x.device)
        if pre_activation:
            return all_kp, logits
        kp = torch.sigmoid(all_kp).transpose(0, 1).reshape(
            MAX_CLASSES, b, self.num_points // 2, 2)
        return kp, logits

    def _select(self, all_kp, pooled, cats, train, generator):
        """The ground-truth class's head, ``[B, 9, 2]`` after the sigmoid,
        and the logits (the categories themselves with one class)."""
        b = pooled.shape[0]
        idx = cats.long().view(b, 1, 1).expand(b, 1, self.num_points)
        sel = all_kp.gather(1, idx)
        kp = torch.sigmoid(sel).view(b, self.num_points // 2, 2)
        if self.num_classes == 1:
            return kp, cats[:, None].to(pooled.dtype)
        if train:
            pooled = dropout(pooled, self.dropout_rate, generator)
        return kp, linear(pooled.to(self.dtype), self.cls_fc)
