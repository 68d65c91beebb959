"""MobileNetV2-SSD-300 with 2 heads at inference (counterpart of
``tpudet3d/detect/ssd.py``).

MNv2 trunk features at strides 16/32, depthwise prediction heads (3x3 DW
conv → BN → ReLU → 1x1 conv), clustered anchors, softmax classification
with a background class (index == num_classes).  ``cascade=True`` adds a
second regression head per level whose residual refines the first head's
decoded boxes; the composed box is re-encoded against the original anchors,
so every consumer of ``(logits, deltas)`` gets the refinement unchanged.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import ConvBN, conv
from ..models.mobilenetv2 import MobileNetV2
from .anchors import generate_anchors, num_anchors_per_level
from .coder import CASCADE_STDS, decode_boxes, encode_boxes

__all__ = ['SSDDetector']


class _DepthwiseHead(nn.Module):

    def __init__(self, in_channels, out_per_anchor, num_anchors):
        super().__init__()
        self.out_per_anchor = out_per_anchor
        self.ConvBN_0 = ConvBN(in_channels, in_channels, 3, 1,
                               groups=in_channels, act=F.relu)
        self.Conv_0 = nn.Conv2d(in_channels, num_anchors * out_per_anchor, 1)

    def forward(self, x):
        y = conv(self.ConvBN_0(x), self.Conv_0)          # [B, k*out, H, W]
        b = y.shape[0]
        return y.permute(0, 2, 3, 1).reshape(b, -1, self.out_per_anchor)


class SSDDetector(nn.Module):
    """``forward(x)``: NHWC ``[B,S,S,3]`` → (cls_logits ``[B,A,C+1]``,
    bbox_deltas ``[B,A,4]``), both float32.  ``dtype`` is the compute dtype
    of the trunk and heads."""

    def __init__(self, num_classes=9, width_mult=1.0, dtype=torch.float32,
                 cascade=False):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.cascade = cascade
        self.width_mult = width_mult
        self.backbone = MobileNetV2(width_mult=width_mult, out_stages=(4, 6))
        ks = num_anchors_per_level()
        chans = self.backbone.out_channels
        kinds = ['cls_heads', 'reg_heads'] + (['reg2_heads'] if cascade
                                              else [])
        for kind in kinds:
            out = num_classes + 1 if kind == 'cls_heads' else 4
            for i, (c, k) in enumerate(zip(chans, ks)):
                self.add_module(f'{kind}_{i}', _DepthwiseHead(c, out, k))
        self.n_levels = len(ks)
        self._anchors = {}

    def _heads(self, kind, feats):
        return torch.cat([getattr(self, f'{kind}_{i}')(f).float()
                          for i, f in enumerate(feats)], dim=1)

    def anchors(self, input_size, device):
        key = (input_size, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                generate_anchors(input_size)).to(device)
        return self._anchors[key]

    def forward(self, x):
        size = x.shape[1]
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # channels_last view
        feats = self.backbone(x)
        logits = self._heads('cls_heads', feats)
        d1 = self._heads('reg_heads', feats)
        if not self.cascade:
            return logits, d1
        d2 = self._heads('reg2_heads', feats)
        # anchors → refined (stage 1) → final (stage 2), re-encoded against
        # the original anchors (encode∘decode is exact inside the clip)
        anchors = self.anchors(size, x.device)
        refined = decode_boxes(anchors, d1)
        final = decode_boxes(refined, d2, stds=CASCADE_STDS)
        return logits, encode_boxes(anchors, final)
