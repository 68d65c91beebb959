"""The regressor-head epilogue of the serving path, kernel K4.

``head_epilogue_plain`` is the plain PyTorch version of K4
(``kernels/csrc/head_epilogue.cu``) and ``head_epilogue`` its wrapper.  It
takes the multi-head regressor's pre-activation output ``[B',9,18]``
(float32, bias added) and class logits ``[B',C]`` for B crops, where
``B' = 2B`` with horizontal-flip TTA (originals, then their mirrors), and:

1. applies the sigmoid ``1/(1+exp(-x))`` in float32;
2. with TTA, averages each crop with its mirror: keypoints in float32 with
   x mirrored back as ``(1 - 1/W) - x``, logits in their own dtype (``a+b``
   rounded to it, then halved);
3. takes the class argmax (the lower index on ties) and that class's head;
4. either computes the next pass's crop boxes (``refine_boxes``) or packs
   the ``[B,26]`` rows ``boxes(4), score, det label, kp(18), reg label,
   conf_mask``.

It replaces the JAX program's ``tpudet3d/models/wrapper.py:61-64`` (the
export-mode sigmoid) and, in ``tpudet3d/infer/engine.py``, ``:33-48``
(``tta_flip_average``), ``:54-77`` (``refine_boxes``), ``:270-276`` (the
argmax and head gather) and ``:291-300`` (the pack).
"""

import numpy as np
import torch

from ..kernels.build import check, library, stream_args

__all__ = ['head_epilogue', 'head_epilogue_plain', 'refine_boxes',
           'sigmoid', 'tta_flip_average', 'REFINE_EPS']

REFINE_EPS = 0.015


def sigmoid(x):
    """``1/(1+exp(-x))`` in float32: the formula K4 computes."""
    return 1.0 / (1.0 + torch.exp(-x))


def tta_flip_average(all_kp, cls_logits, k, crop_w):
    """Merge a doubled-batch regressor output (originals ++ mirrored crops)
    into averaged predictions for the k originals.  ``all_kp`` is
    ``[heads, 2k, 9, 2]`` normalised by the crop size; the mirror-back of x
    is ``(1 - 1/W) - x``.  Keypoint indices are not re-permuted."""
    flip_c = 1.0 - 1.0 / float(crop_w)
    kp_m = all_kp[:, k:].clone()
    kp_m[..., 0] = flip_c - kp_m[..., 0]
    return (0.5 * (all_kp[:, :k] + kp_m),
            0.5 * (cls_logits[:k] + cls_logits[k:]))


def refine_boxes(kp, boxes, frame_wh, margin_px, edge_grow, eps=REFINE_EPS):
    """Next-pass crop boxes from pass-N keypoints.

    kp ``[...,9,2]`` normalised to each box; boxes ``[...,4]`` xyxy px;
    frame_wh ``(w, h)``.  Box = predicted keypoint extent + margin; a side
    whose keypoints saturate at the crop edge grows by ``edge_grow``·box
    side (floored at the margin) instead.  ``lo`` is clamped to
    ``[0, w-1]``, ``hi`` to ``[0, w]``, then ``hi = max(hi, lo+1)``."""
    w, h = frame_wh
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    kp_px = kp * wh[..., None, :] + boxes[..., None, 0:2]
    rm = float(np.float32(margin_px))
    grow = edge_grow * wh
    pad_lo = torch.where(kp.amin(-2) <= eps, grow.clamp(min=rm), rm)
    pad_hi = torch.where(kp.amax(-2) >= 1.0 - eps, grow.clamp(min=rm), rm)
    lo = kp_px.amin(-2) - pad_lo
    hi = kp_px.amax(-2) + pad_hi
    lo = torch.stack([lo[..., 0].clamp(0, w - 1), lo[..., 1].clamp(0, h - 1)],
                     -1)
    hi = torch.stack([hi[..., 0].clamp(0, w), hi[..., 1].clamp(0, h)], -1)
    hi = torch.maximum(hi, lo + 1.0)       # degenerate-extent guard
    return torch.cat([lo, hi], dim=-1)


def _check_args(pre, logits, boxes, tta_w, refine, dets):
    if (refine is None) == (dets is None):
        raise ValueError('give exactly one of refine=(w, h, margin_px, '
                         'edge_grow) and dets')
    b = boxes.shape[0]
    b2 = 2 * b if tta_w else b
    if tuple(pre.shape[1:]) != (9, 18) or pre.shape[0] != b2 \
            or logits.dim() != 2 or logits.shape[0] != b2 \
            or not 0 < logits.shape[1] <= 9 or tuple(boxes.shape) != (b, 4) \
            or (dets is not None and tuple(dets.shape) != (b, 6)):
        raise ValueError(
            f'shapes: pre {tuple(pre.shape)}, logits {tuple(logits.shape)}, '
            f'boxes {tuple(boxes.shape)}'
            + ('' if dets is None else f', dets {tuple(dets.shape)}')
            + f' (TTA width {tta_w})')


def head_epilogue_plain(pre, logits, boxes, tta_w=0, refine=None, dets=None,
                        det_conf=0.0):
    """pre ``[B',9,18]`` float32, logits ``[B',C]``, boxes ``[B,4]`` (the
    crop boxes of this pass) → next boxes ``[B,4]`` when ``refine = (w, h,
    margin_px, edge_grow)`` is given, else the packed rows ``[B,26]`` of
    ``dets [B,6]`` (score at 4, label at 5) with ``conf_mask = score >
    det_conf``.  ``tta_w`` is the crop width when the batch holds mirrored
    crops, else 0."""
    _check_args(pre, logits, boxes, tta_w, refine, dets)
    b = boxes.shape[0]
    b2 = pre.shape[0]
    all_kp = sigmoid(pre.float()).transpose(0, 1).reshape(9, b2, 9, 2)
    if tta_w:
        all_kp, logits = tta_flip_average(all_kp, logits, b, tta_w)
    labels = logits.argmax(-1)                                      # [B]
    kp = all_kp[labels, torch.arange(b, device=labels.device)]     # [B,9,2]
    if refine is not None:
        w, h, margin_px, edge_grow = refine
        return refine_boxes(kp, boxes, (w, h), margin_px, edge_grow)
    scores = dets[:, 4]
    return torch.cat([boxes, scores[:, None], dets[:, 5:6],
                      kp.reshape(b, 18), labels.float()[:, None],
                      (scores > det_conf).float()[:, None]], dim=-1)


def head_epilogue(pre, logits, boxes, tta_w=0, refine=None, dets=None,
                  det_conf=0.0):
    """K4: see :func:`head_epilogue_plain`.  On the card every input is a
    contiguous tensor on one device: pre, boxes and dets float32, logits
    float32 or bfloat16."""
    if pre.device.type == 'cpu':
        return head_epilogue_plain(pre, logits, boxes, tta_w, refine, dets,
                                   det_conf)
    if pre.device.type != 'cuda':
        raise ValueError(f'unsupported device {pre.device}')
    _check_args(pre, logits, boxes, tta_w, refine, dets)
    for t, dtypes in ((pre, (torch.float32,)), (boxes, (torch.float32,)),
                      (logits, (torch.float32, torch.bfloat16)),
                      (dets, (torch.float32,))):
        if t is not None and (t.dtype not in dtypes or not t.is_contiguous()
                              or t.device != pre.device):
            raise ValueError(f'expected a contiguous {dtypes} tensor on '
                             f'{pre.device}, got {t.dtype} on {t.device}')
    b = boxes.shape[0]
    out = torch.empty((b, 4 if refine is not None else 26),
                      dtype=torch.float32, device=pre.device)
    if refine is not None:
        w, h, margin_px, edge_grow = refine
        geom = (float(w), float(h), float(margin_px), float(edge_grow))
    else:
        geom = (0.0, 0.0, 0.0, 0.0)
    flip_c = 1.0 - 1.0 / float(tta_w) if tta_w else 0.0
    err = library().tpd_head_epilogue(
        pre.data_ptr(), logits.data_ptr(), boxes.data_ptr(),
        0 if dets is None else dets.data_ptr(), out.data_ptr(), b,
        logits.shape[1], int(logits.dtype == torch.bfloat16), int(bool(tta_w)),
        flip_c, int(refine is not None), *geom, REFINE_EPS, 1.0 - REFINE_EPS,
        float(det_conf), *stream_args(pre))
    check(err, 'head_epilogue')
    head_epilogue.launches += 1
    return out


head_epilogue.launches = 0
