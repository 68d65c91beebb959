"""Box overlap and MaxIoU anchor assignment (counterpart of
``tpudet3d/detect/assigner.py``), batched over images.

An anchor is positive to its best-IoU ground-truth box when that IoU is at
least ``pos_thr`` (0.4); each valid ground-truth box also claims its single
best anchor when their IoU exceeds ``min_pos_iou``.  Ground truth is padded
to a static G with a validity mask; padded rows never match.
"""

import torch

__all__ = ['iou_xyxy', 'assign_anchors']


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


def assign_anchors(anchors, gt_boxes, gt_valid, pos_thr=0.4, neg_thr=0.4,
                   min_pos_iou=0.0):
    """anchors ``[A,4]`` (or ``[B,A,4]``: the cascade's refined boxes per
    image), ``gt_boxes [B,G,4]``, ``gt_valid [B,G]`` bool → (``assigned
    [B,A]`` int64 with -1 for background, ``pos [B,A]``).

    Where two ground-truth boxes claim one anchor the later one wins, as
    the JAX package's scatter lets it; here the winner is the largest
    claiming index, an ``amax`` over a ``[B,A,G]`` mask, which is
    deterministic on every device (``index_put_`` with repeated indices is
    not on the card).  ``neg_thr`` equals ``pos_thr`` in every config and,
    as in the JAX package, is not read."""
    ious = iou_xyxy(anchors, gt_boxes)                       # [B, A, G]
    valid = gt_valid[:, None, :]
    ious_a = torch.where(valid, ious, -1.0)
    best_gt = ious_a.argmax(-1)                              # first maximum
    best_iou = ious_a.amax(-1)
    assigned = torch.where(best_iou >= pos_thr, best_gt, -1)

    # each ground-truth box claims its single best anchor
    ious_t = torch.where(valid, ious, float('-inf'))
    best_anchor = ious_t.argmax(1)                           # [B, G]
    gt_best_iou = ious_t.amax(1)
    claim = gt_valid & (gt_best_iou > min_pos_iou)
    a, g = ious.shape[1], ious.shape[2]
    anchor_ids = torch.arange(a, device=ious.device)
    claims = (anchor_ids[None, :, None] == best_anchor[:, None, :]) \
        & claim[:, None, :]                                  # [B, A, G]
    gt_ids = torch.arange(g, device=ious.device)
    winner = torch.where(claims, gt_ids, -1).amax(-1)        # [B, A]
    assigned = torch.where(winner >= 0, winner, assigned)
    return assigned, assigned >= 0
