"""Fixed-shape SSD detection decode and NMS (counterpart of
``tpudet3d/detect/nms.py``), batched over images.

``decode_detections_plain`` is the plain PyTorch version of kernel K3
(``kernels/csrc/decode_nms.cu``); ``decode_detections`` is its wrapper.
Everything is static-shape: per-class top-K pre-selection, greedy NMS or
Gaussian soft-NMS, optional box voting, then a global top ``max_per_img``
across classes.  Padded rows have score 0 and arbitrary boxes.  Ties break
as ``lax.top_k`` does, by the lower index (stable sorts, never ``topk``).

The plain version computes scores, boxes and IoUs with the same IEEE
operations in the same order as the kernel, so on the card the two agree
bit for bit outside the box-vote sums.
"""

import math

import numpy as np
import torch

from ..kernels.build import check, library, stream_args
from .assigner import iou_xyxy
from .coder import decode_boxes

__all__ = ['greedy_nms', 'soft_nms', 'decode_detections_plain',
           'decode_detections', 'decode_nms_plan', 'decode_nms_check']


def greedy_nms(boxes, scores, iou_thr=0.45):
    """boxes ``[...,K,4]`` sorted by score desc, scores ``[...,K]`` → keep
    mask ``[...,K]``.  Box i is dropped when an earlier kept box overlaps it
    above ``iou_thr``; zero scores are never kept."""
    k = boxes.shape[-2]
    ious = iou_xyxy(boxes, boxes)
    tri = torch.ones((k, k), dtype=torch.bool, device=boxes.device).tril(-1)
    suppress = (ious > iou_thr) & tri                 # [i, j]: j suppresses i
    keep = scores > 0
    for i in range(1, k):
        sup = (suppress[..., i, :] & keep).any(-1)
        keep[..., i] &= ~sup
    return keep


def _inv(x):
    # 1/x rounded to float32, the reciprocal PyTorch multiplies by when a
    # tensor is divided by a Python number on the card
    return float(np.float32(1.0) / np.float32(x))


def soft_nms(boxes, scores, sigma=0.5, dup_iou=1.0):
    """Gaussian soft-NMS (Bodla et al. 2017): decay instead of suppress.

    Each of K rounds takes the highest unprocessed score and multiplies
    every other unprocessed score by ``exp(-iou²/sigma)``, or by 0 above
    the duplicate cutoff ``dup_iou``.  boxes ``[...,K,4]``, scores
    ``[...,K]`` → decayed scores ``[...,K]``."""
    k = boxes.shape[-2]
    ious = iou_xyxy(boxes, boxes)
    inv_sigma = _inv(sigma)
    s = scores.clone()
    processed = torch.zeros_like(s, dtype=torch.bool)
    for _ in range(k):
        masked = torch.where(processed, -1.0, s)
        i = masked.argmax(-1, keepdim=True)               # first maximum
        valid = masked.gather(-1, i) > 0.0
        row = ious.gather(-2, i[..., None].expand(*i.shape[:-1], 1, k))
        row = row.squeeze(-2)
        decay = torch.exp(-(row * row) * inv_sigma)
        decay = torch.where(row > dup_iou, 0.0, decay)
        decay = torch.where(processed | ~valid, 1.0, decay)
        decay = decay.scatter(-1, i, 1.0)
        s = s * decay
        processed = processed.scatter(-1, i, True)
    return s


def _softmax_probs(logits):
    """Softmax over the last axis with a sequential sum, the order the
    kernel uses."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    total = e[..., 0]
    for j in range(1, e.shape[-1]):
        total = total + e[..., j]
    return e / total[..., None]


def decode_detections_plain(cls_logits, bbox_deltas, anchors, score_thr=0.02,
                            iou_thr=0.45, max_per_img=200, pre_nms_k=200,
                            soft_nms_sigma=0.0, soft_nms_dup_iou=1.0,
                            box_vote_iou=0.0):
    """``[N,A,C+1]`` logits + ``[N,A,4]`` deltas → ``[N,max_per_img,6]``
    (x1, y1, x2, y2, score, label), score-descending, zero-padded."""
    n, a, c1 = cls_logits.shape
    c, k = c1 - 1, pre_nms_k
    probs = _softmax_probs(cls_logits.float())[..., :c]             # [N,A,C]
    boxes_all = decode_boxes(anchors, bbox_deltas.float())         # [N,A,4]
    scores = probs.transpose(1, 2)                                  # [N,C,A]
    scores = torch.where(scores > score_thr, scores, 0.0)
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]    # [N,C,K]
    top_boxes = torch.gather(boxes_all[:, None].expand(n, c, a, 4), 2,
                             top_idx[..., None].expand(n, c, k, 4))
    if soft_nms_sigma > 0.0:
        kept = soft_nms(top_boxes, top_scores, soft_nms_sigma,
                        soft_nms_dup_iou)
        kept = torch.where(kept > score_thr, kept, 0.0)
    else:
        keep = greedy_nms(top_boxes, top_scores, iou_thr)
        kept = torch.where(keep, top_scores, 0.0)
    if box_vote_iou > 0.0:
        ious = iou_xyxy(top_boxes, top_boxes)                      # [N,C,K,K]
        # padded and below-floor candidates carry score 0 → zero weight
        w = torch.where(ious > box_vote_iou, top_scores[..., None, :], 0.0)
        voted = (w @ top_boxes) / w.sum(-1, keepdim=True).clamp(min=1e-9)
        top_boxes = torch.where(kept[..., None] > 0.0, voted, top_boxes)
    flat_boxes = top_boxes.reshape(n, c * k, 4)
    flat_scores = kept.reshape(n, c * k)
    final_scores, final_idx = torch.sort(flat_scores, dim=-1,
                                         descending=True, stable=True)
    final_scores = final_scores[:, :max_per_img]
    final_idx = final_idx[:, :max_per_img]
    labels = torch.div(final_idx, k, rounding_mode='floor').float()
    boxes = torch.gather(flat_boxes, 1, final_idx[..., None].expand(-1, -1, 4))
    return torch.cat([boxes, final_scores[..., None], labels[..., None]], -1)


# limits of the kernel (kernels/csrc/decode_nms.cu): K (two words of
# removed bits per lane in the greedy chain), K up to which the first
# instantiation runs, classes per image (the size of a thread-block
# cluster), K up to which the soft-NMS decays stay in shared memory, and
# the shared memory a CTA may have
MAX_K = 2048
SMALL_K = 256
MAX_CLASSES = 16
DECAY_MATRIX_MAX_K = 128
SMEM_LIMIT = 232448


def _up16(b):
    return (b + 15) // 16 * 16


def decode_nms_plan(a, c, k, max_det):
    """Shared-memory bytes of one K3 CTA and words of device scratch per
    CTA for A anchors, C classes, top K and ``max_det`` rows (the kernel's
    ``make_layout``, which the C entry checks against this).  The bytes:
    the logits of the CTA's slice of ⌈A/C⌉ anchors, later the soft-NMS
    decays (up to K = 128) and the greedy bit rows (K·⌈K/32⌉ words), later
    the other classes' first min(K, max_det) scores; the score bits of all
    A anchors; two 256-bin histograms; 64 scalars; 15 words per candidate.
    Above K = 256, where the bit rows would not fit they move to a device
    scratch of K·⌈K/32⌉ words per CTA: N·C·K·⌈K/32⌉ words in all, 75 MB at
    N = 16, C = 9, K = 2044 (from about K = 1110 at A = 2044)."""
    w = (k + 31) // 32
    logits = ((a + c - 1) // c * (c + 1) + 4) * 4
    lists = c * min(k, max_det) * 4
    tail = _up16(a * 4) + 2 * 256 * 4 + 64 * 4 + k * 60
    nms = (k * k * 4 if k <= DECAY_MATRIX_MAX_K else 0) + k * w * 4
    scratch = 0
    if k > SMALL_K and _up16(max(logits, nms, lists)) + tail > SMEM_LIMIT:
        nms, scratch = 0, k * w
    return _up16(max(logits, nms, lists)) + tail, scratch


def decode_nms_check(n, a, c, k, max_det):
    """Refuses (``ValueError``) the shapes that K3 does not take, as its C
    entry does; returns :func:`decode_nms_plan`'s (bytes, scratch words)."""
    if not 0 < c <= MAX_CLASSES or not 0 < k <= min(a, MAX_K) \
            or not 0 < max_det <= c * k or not 0 < n:
        raise ValueError(f'unsupported pre_nms_k={k} / max_per_img='
                         f'{max_det} for N={n}, A={a}, C={c} (K up to '
                         f'min(A, MAX_K={MAX_K}), C up to {MAX_CLASSES})')
    smem, scratch = decode_nms_plan(a, c, k, max_det)
    if smem > SMEM_LIMIT:
        raise ValueError(f'A={a}, C={c}, K={k} need {smem} bytes of shared '
                         f'memory, more than SMEM_LIMIT={SMEM_LIMIT}')
    return smem, scratch


def _launch(cls_logits, bbox_deltas, anchors, score_thr, iou_thr,
            max_per_img, pre_nms_k, soft_nms_sigma, soft_nms_dup_iou,
            box_vote_iou):
    """Checks the inputs, allocates the output and the scratch and calls
    the C entry on ``cls_logits``' device."""
    n, a, c1 = cls_logits.shape
    c, k = c1 - 1, pre_nms_k
    for t, shape in ((cls_logits, (n, a, c1)), (bbox_deltas, (n, a, 4)),
                     (anchors, (a, 4))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != cls_logits.device:
            raise ValueError(f'expected contiguous float32 {shape} on '
                             f'{cls_logits.device}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    smem, scratch_words = decode_nms_check(n, a, c, k, max_per_img)
    out = torch.empty((n, max_per_img, 6), dtype=torch.float32,
                      device=cls_logits.device)
    scratch = torch.empty((n * c * scratch_words,), dtype=torch.int32,
                          device=cls_logits.device)
    inv_sigma = _inv(soft_nms_sigma) if soft_nms_sigma > 0.0 else 0.0
    err = library().tpd_decode_nms(
        cls_logits.data_ptr(), bbox_deltas.data_ptr(), anchors.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if scratch_words else None, n, a,
        c, k, max_per_img, score_thr, iou_thr, inv_sigma, soft_nms_dup_iou,
        box_vote_iou, math.log(16.0), smem, scratch_words,
        *stream_args(cls_logits))
    check(err, 'decode_detections')
    return out


def decode_detections(cls_logits, bbox_deltas, anchors, score_thr=0.02,
                      iou_thr=0.45, max_per_img=200, pre_nms_k=200,
                      soft_nms_sigma=0.0, soft_nms_dup_iou=1.0,
                      box_vote_iou=0.0):
    """K3: see :func:`decode_detections_plain`.  On the card the inputs are
    contiguous float32 tensors on one device; one launch, a thread-block
    cluster of the C class CTAs per image, for every K up to min(A, 2048)."""
    args = (score_thr, iou_thr, max_per_img, pre_nms_k, soft_nms_sigma,
            soft_nms_dup_iou, box_vote_iou)
    if cls_logits.device.type == 'cpu':
        return decode_detections_plain(cls_logits, bbox_deltas, anchors,
                                       *args)
    if cls_logits.device.type != 'cuda':
        raise ValueError(f'unsupported device {cls_logits.device}')
    out = _launch(cls_logits, bbox_deltas, anchors, *args)
    decode_detections.launches += 1
    return out


decode_detections.launches = 0
