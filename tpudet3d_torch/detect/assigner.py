"""Box overlap (``iou_xyxy`` of ``tpudet3d/detect/assigner.py``).  Anchor
assignment belongs to the detector-training slice."""

import torch

__all__ = ['iou_xyxy']


def iou_xyxy(a, b):
    """Pairwise IoU: a [...,N,4] x b [...,M,4] → [...,N,M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))
