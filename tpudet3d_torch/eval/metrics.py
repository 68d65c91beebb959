"""Batched metrics: ADD / SADD / accuracy / 3D IoU, per class (counterpart
of ``tpudet3d/eval/metrics.py``).

ADD and SADD are fused reductions over ``[B,9,2]`` tensors; the per-class
grouping is one segment sum per metric (``index_add_``); the 2D-based 3D
IoU lifts both keypoint sets with the batched EPnP (``ops/geometry.py``)
and runs kernel K5 (``ops/box3d.py``) over the batch.  SADD takes, for
every predicted keypoint, the nearest of *all* GT keypoints (no bijective
matching), as the reference defines it.

Tensors stay on their device; numpy inputs go to ``device`` (the card
unless ``'cpu'``).  Keypoints compute in float32, as in the JAX package.
"""

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.box3d import iou_oriented_boxes
from ..ops.geometry import lift_2d_batched

__all__ = ['compute_average_distance', 'compute_accuracy',
           'compute_metrics_per_cls', 'compute_2d_based_iou',
           'add_sadd_per_sample']

NUM_KEYPOINTS = 9


def _tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def add_sadd_per_sample(pred_kp, gt_kp):
    """Per-sample ADD and SADD sums (not yet normalised): [..., 9, 2] →
    [...]."""
    add = torch.linalg.norm(pred_kp - gt_kp, dim=-1).sum(-1)
    pair = torch.linalg.norm(pred_kp[..., :, None, :]
                             - gt_kp[..., None, :, :], dim=-1)
    sadd = pair.amin(-1).sum(-1)
    return add, sadd


def compute_average_distance(pred_kp, gt_kp, num_keypoint=NUM_KEYPOINTS,
                             reduce_mean=True, device=None, **kwargs):
    """ADD and symmetric ADD, as 0-d tensors."""
    pred_kp = _tensor(pred_kp, device, torch.float32)
    gt_kp = _tensor(gt_kp, pred_kp.device, torch.float32)
    add_sum, sadd_sum = add_sadd_per_sample(pred_kp, gt_kp)
    reduce = torch.mean if reduce_mean else torch.sum
    return reduce(add_sum) / num_keypoint, reduce(sadd_sum) / num_keypoint


def compute_accuracy(pred_cats, gt_cats, reduce_mean=True, device=None,
                     **kwargs):
    """Classification accuracy from logits, as a 0-d tensor."""
    pred_cats = _tensor(pred_cats, device)
    gt_cats = _tensor(gt_cats, pred_cats.device)
    correct = (pred_cats.argmax(1) == gt_cats).float()
    return correct.mean() if reduce_mean else correct.sum()


def compute_2d_based_iou(pred_kp, gt_kp, reduce_mean=True, device=None):
    """Lift both 2D keypoint sets with EPnP (portrait, as the reference)
    and compute the oriented 3D IoU (K5) over the batch."""
    pred_kp = _tensor(pred_kp, device, torch.float32)
    gt_kp = _tensor(gt_kp, pred_kp.device, torch.float32)
    iou = iou_oriented_boxes(lift_2d_batched(pred_kp, portrait=True),
                             lift_2d_batched(gt_kp, portrait=True))
    return iou.mean() if reduce_mean else iou.sum()


def _metrics_segments(pred_kp, gt_kp, pred_cats, gt_cats, num_classes,
                      compute_iou, weights=None):
    """Per-class sums and counts of ADD, SADD, IoU and accuracy.

    ``weights [B]`` (optional) zeroes out padded samples of a partial
    batch."""
    add_sum, sadd_sum = add_sadd_per_sample(pred_kp, gt_kp)
    add_sum = add_sum / NUM_KEYPOINTS
    sadd_sum = sadd_sum / NUM_KEYPOINTS
    correct = (pred_cats.argmax(1) == gt_cats).float()
    if compute_iou:
        iou = iou_oriented_boxes(lift_2d_batched(pred_kp, portrait=True),
                                 lift_2d_batched(gt_kp, portrait=True))
    else:
        iou = torch.zeros_like(add_sum)
    if weights is None:
        weights = torch.ones_like(add_sum)
    segs = torch.zeros((5, num_classes), dtype=add_sum.dtype,
                       device=add_sum.device)
    values = torch.stack([add_sum, sadd_sum, iou, correct,
                          torch.ones_like(add_sum)]) * weights
    segs.index_add_(1, gt_cats.long(), values)
    return tuple(segs)


def compute_metrics_per_cls(pred_kp, gt_kp, pred_cats, gt_cats,
                            compute_iou=True, num_classes=NUM_KEYPOINTS,
                            device=None, **kwargs):
    """Returns ``([(cls, ADD, SADD, IOU, acc), ...]`` for the classes present
    in the batch, ``total_ADD, total_SADD, total_IOU, total_acc)`` as
    Python floats."""
    pred_kp = _tensor(pred_kp, device, torch.float32)
    dev = pred_kp.device
    gt_kp = _tensor(gt_kp, dev, torch.float32)
    pred_cats = _tensor(pred_cats, dev)
    gt_cats = _tensor(gt_cats, dev, torch.int64)
    batch_size = pred_kp.shape[0]
    sums = _metrics_segments(pred_kp, gt_kp, pred_cats, gt_cats,
                             int(num_classes), bool(compute_iou))
    add_s, sadd_s, iou_s, acc_s, counts = (s.cpu().numpy() for s in sums)

    computed = []
    for cl in range(int(num_classes)):
        n = counts[cl]
        if n > 0:
            computed.append((cl, float(add_s[cl] / n), float(sadd_s[cl] / n),
                             float(iou_s[cl] / n), float(acc_s[cl] / n)))
    return (computed,
            float(add_s.sum() / batch_size),
            float(sadd_s.sum() / batch_size),
            float(iou_s.sum() / batch_size),
            float(acc_s.sum() / batch_size))
