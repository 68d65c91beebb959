"""SSD training loss (counterpart of ``tpudet3d/detect/losses.py``):
MaxIoU assignment, hard-negative mining, SmoothL1, optional GIoU, the
cascade's second stage and the clamped loss balancing.

Every per-image term is a batched tensor operation (the JAX package maps
one image's loss over the batch).  Mining keeps the JAX package's form: a
sort of each image's negative cross-entropies and a sum of the first
``min(3·n_pos, A − n_pos)`` through an ``arange < n_neg`` mask, so the
count never leaves the device (a ``topk`` with a tensor ``k``, boolean
indexing, ``nonzero`` or ``.item()`` would each wait for the host).
"""

import torch

from .assigner import assign_anchors
from .coder import CASCADE_STDS, decode_boxes, encode_boxes

__all__ = ['ssd_loss', 'giou_xyxy_paired']


def _per_anchor_ce(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return lse - picked


def giou_xyxy_paired(a, b):
    """Elementwise GIoU of paired boxes a, b ``[...,4]`` xyxy → ``[...]``,
    in [-1, 1]."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    union = area_a + area_b - inter
    iou = inter / union.clamp(min=1e-9)
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = (erb - elt).clamp(min=0)
    earea = ewh[..., 0] * ewh[..., 1]
    return iou - (earea - union) / earea.clamp(min=1e-9)


def _gather_gt(t, idx):
    """``t [B,G,...]`` at ``idx [B,A]`` → ``[B,A,...]``."""
    shape = idx.shape + t.shape[2:]
    index = idx.view(*idx.shape, *([1] * (t.dim() - 2))).expand(shape)
    return t.gather(1, index)


def _smooth_l1(diff, beta):
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def ssd_loss(cls_logits, bbox_deltas, anchors, gt_boxes, gt_labels, gt_valid,
             balance_params=None, neg_pos_ratio=3, smoothl1_beta=1.0,
             pos_thr=0.4, neg_thr=0.4, uniform_neg_weight=0.1,
             cascade_deltas=None, cascade_pos_thr=0.5, giou_weight=0.0):
    """Batched SSD loss.

    ``cls_logits [B,A,C+1]``, ``bbox_deltas [B,A,4]``, ``anchors [A,4]``;
    ``gt_boxes [B,G,4]`` (padded), ``gt_labels [B,G]``, ``gt_valid [B,G]``
    bool.  ``balance_params``: optional ``(s_cls, s_reg)`` log-variance
    scalars, clamped to [-1, 1].  ``cascade_deltas``: the stage-2 deltas
    ``[B,A,4]``, whose targets are re-assigned against the stage-1 decoded
    boxes (no gradient through them) at ``cascade_pos_thr`` and encoded at
    ``CASCADE_STDS``, with their own denominator.  ``giou_weight`` adds
    ``w·(1 − GIoU(decoded, gt))`` over each stage's positives;
    ``uniform_neg_weight`` a cross-entropy mean over all negatives beside
    the mined ones.  Returns ``(total, {'cls_loss', 'reg_loss',
    'num_pos'})``, 0-d float32 tensors."""
    b, a, c1 = cls_logits.shape
    background = c1 - 1
    gt_labels = gt_labels.long()
    assigned, pos = assign_anchors(anchors, gt_boxes, gt_valid,
                                   pos_thr=pos_thr, neg_thr=neg_thr)
    safe_gt = assigned.clamp(min=0)
    target_labels = torch.where(pos, gt_labels.gather(1, safe_gt),
                                background)
    ce = _per_anchor_ce(cls_logits, target_labels)               # [B, A]

    n_pos = pos.sum(1)
    # hard negative mining: the 3·n_pos largest negative cross-entropies;
    # an ascending stable sort reversed orders ties as the JAX package does
    neg_ce = torch.where(pos, float('-inf'), ce)
    sorted_neg = neg_ce.sort(dim=1, stable=True).values.flip(1)
    n_neg = torch.minimum(neg_pos_ratio * n_pos, a - n_pos)
    idx = torch.arange(a, device=ce.device)
    finite = torch.where(torch.isfinite(sorted_neg), sorted_neg, 0.0)
    neg_sum = torch.where(idx < n_neg[:, None], finite, 0.0).sum(1)
    pos_sum = torch.where(pos, ce, 0.0).sum(1)
    denom = n_pos.clamp(min=1).float()
    cls_loss = (pos_sum + neg_sum) / denom
    if uniform_neg_weight:
        neg_mask = ~pos
        all_neg_mean = (torch.where(neg_mask, ce, 0.0).sum(1)
                        / neg_mask.sum(1).clamp(min=1))
        cls_loss = cls_loss + uniform_neg_weight * all_neg_mean

    matched = _gather_gt(gt_boxes, safe_gt)                      # [B, A, 4]
    target_deltas = encode_boxes(anchors, matched)
    sl1 = _smooth_l1((bbox_deltas - target_deltas).abs(), smoothl1_beta)
    reg_loss = torch.where(pos[..., None], sl1, 0.0).sum((1, 2)) / denom
    if giou_weight:
        g1 = 1.0 - giou_xyxy_paired(decode_boxes(anchors, bbox_deltas),
                                    matched)
        reg_loss = reg_loss + giou_weight * torch.where(
            pos, g1, 0.0).sum(1) / denom

    if cascade_deltas is not None:
        # stage 2 regresses the residual from the stage-1 decoded box,
        # trained on stage 1's outputs, not through them
        refined = decode_boxes(anchors, bbox_deltas.detach())
        assigned2, pos2 = assign_anchors(refined, gt_boxes, gt_valid,
                                         pos_thr=cascade_pos_thr,
                                         neg_thr=cascade_pos_thr)
        matched2 = _gather_gt(gt_boxes, assigned2.clamp(min=0))
        t2 = encode_boxes(refined, matched2, stds=CASCADE_STDS)
        sl2 = _smooth_l1((cascade_deltas - t2).abs(), smoothl1_beta)
        denom2 = pos2.sum(1).clamp(min=1).float()
        reg2 = torch.where(pos2[..., None], sl2, 0.0).sum((1, 2)) / denom2
        if giou_weight:
            dec2 = decode_boxes(refined, cascade_deltas, stds=CASCADE_STDS)
            g2 = 1.0 - giou_xyxy_paired(dec2, matched2)
            reg2 = reg2 + giou_weight * torch.where(pos2, g2, 0.0).sum(1) \
                / denom2
        reg_loss = reg_loss + reg2

    cls_loss = cls_loss.mean()
    reg_loss = reg_loss.mean()
    if balance_params is not None:
        # clamped uncertainty weighting
        s_cls = balance_params[0].clamp(-1.0, 1.0)
        s_reg = balance_params[1].clamp(-1.0, 1.0)
        total = (torch.exp(-s_cls) * cls_loss + 0.5 * s_cls
                 + torch.exp(-s_reg) * reg_loss + 0.5 * s_reg)
    else:
        total = cls_loss + reg_loss
    return total, {'cls_loss': cls_loss, 'reg_loss': reg_loss,
                   'num_pos': n_pos.float().mean()}
