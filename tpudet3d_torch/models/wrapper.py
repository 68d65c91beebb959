"""Multi-head 3D-vertex regressor (counterpart of
``tpudet3d/models/wrapper.py``), export mode only.

All 9 per-class heads are one ``[9, C, 18]`` tensor, so one matmul computes
every head for every sample.  ``forward`` returns the export convention of
the JAX module's ``export=True``: sigmoid keypoints for all heads as
``[9, B, 9, 2]`` plus class logits ``[B, num_classes]``.  With
``pre_activation=True`` it returns the heads before the sigmoid,
``[B, 9, 18]`` float32 with the bias added, plus the same logits: the
serving engine finishes them with kernel K4 (``infer/epilogue.py``).  The
training branch (GT-class head selection) belongs to the training slice.
"""

import math

import torch
from torch import nn

from .layers import global_pool, linear

__all__ = ['MultiHeadRegressor', 'MAX_CLASSES']

MAX_CLASSES = 9


class MultiHeadRegressor(nn.Module):
    """``forward(x)``: NHWC crops ``[B,h,w,3]`` → (kp, logits).  ``dtype`` is
    the compute dtype of the backbone and of ``cls_fc``; the head matmul
    runs in float32, as the JAX module's einsum does."""

    def __init__(self, backbone, num_classes=9, num_points=18,
                 pooling_mode='avg', dtype=torch.float32):
        super().__init__()
        self.backbone = backbone
        self.num_classes = num_classes
        self.num_points = num_points
        self.pooling_mode = pooling_mode
        self.dtype = dtype
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

    def forward(self, x, pre_activation=False):
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # channels_last view
        feats = self.backbone.features(x)
        pooled = self.backbone.head(global_pool(feats, self.pooling_mode))
        pooled = pooled.float()
        b, c = pooled.shape
        # every head in one matmul with the bias added, straight into the
        # [B, 9, 18] layout (the [9, C, 18] kernel is copied to [C, 9·18])
        all_kp = torch.addmm(
            self.head_bias.reshape(-1), pooled,
            self.head_kernel.permute(1, 0, 2).reshape(c, -1)).view(
            b, MAX_CLASSES, self.num_points)
        if self.num_classes > 1:
            logits = linear(pooled.to(self.dtype), self.cls_fc)
        else:
            logits = torch.zeros((b,), dtype=pooled.dtype, device=x.device)
        if pre_activation:
            return all_kp, logits
        kp = torch.sigmoid(all_kp).transpose(0, 1).reshape(
            MAX_CLASSES, b, self.num_points // 2, 2)
        return kp, logits
