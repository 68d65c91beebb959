"""DeltaXYWH box coder (counterpart of ``tpudet3d/detect/coder.py``)."""

import math

import torch

__all__ = ['encode_boxes', 'decode_boxes', 'DEFAULT_STDS', 'CASCADE_STDS']

DEFAULT_STDS = (0.1, 0.1, 0.2, 0.2)
# second-regression stds of the cascade head
CASCADE_STDS = (0.05, 0.05, 0.1, 0.1)


def _per_component(x, stds, op):
    # scalar operands keep the stds off the host-to-device path
    return torch.stack([op(x[..., i], s) for i, s in enumerate(stds)], -1)


def _xyxy_to_cxcywh(boxes):
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    c = boxes[..., 0:2] + wh * 0.5
    return c, wh


def encode_boxes(anchors, gt, stds=DEFAULT_STDS):
    """gt/anchors [...,4] xyxy → normalized deltas [...,4]."""
    ac, awh = _xyxy_to_cxcywh(anchors)
    gc, gwh = _xyxy_to_cxcywh(gt)
    awh = awh.clamp(min=1e-6)
    gwh = gwh.clamp(min=1e-6)
    dxy = (gc - ac) / awh
    dwh = torch.log(gwh / awh)
    return _per_component(torch.cat([dxy, dwh], dim=-1), stds,
                          torch.div)


def decode_boxes(anchors, deltas, stds=DEFAULT_STDS, max_wh_ratio=16.0):
    """deltas [...,4] → xyxy boxes; wh clamped like mmdet's wh_ratio_clip."""
    deltas = _per_component(deltas, stds, torch.mul)
    ac, awh = _xyxy_to_cxcywh(anchors)
    cxy = ac + deltas[..., 0:2] * awh
    log_clip = math.log(max_wh_ratio)
    wh = awh * torch.exp(deltas[..., 2:4].clamp(-log_clip, log_clip))
    return torch.cat([cxy - wh * 0.5, cxy + wh * 0.5], dim=-1)
