"""The plain float32 reference of the two serving stages, in the engine's
geometry: the detector's class probabilities and crop boxes for every
anchor of every frame, and the regressor's keypoints and logits at given
crop boxes.  Works everything out again from the frames and the weights;
the boxes it crops at are the ones being judged."""

import numpy as np
import torch

from . import image
from .models import INPUT_SIZE

REG_MEAN = (0.5931, 0.4690, 0.4229)
REG_STD = (0.2471, 0.2214, 0.2157)


def reg_norm():
    """The crop normalisation ``x * scale - offset`` in float32."""
    scale = 1.0 / (np.asarray(REG_STD, np.float64) * 255.0)
    offset = np.asarray(REG_MEAN, np.float64) * 255.0 * scale
    return (tuple(np.float32(scale).tolist()),
            tuple(np.float32(offset).tolist()))


@torch.no_grad()
def detect(det, frames, margin, classes):
    """uint8 BGR frames ``[N,H,W,3]`` on the card → each anchor's class
    probabilities ``[N,A,classes]``, its box as the engine crops it
    ``[N,A,4]`` (scaled to the frame, widened by ``margin`` pixels and
    clipped to it) and its decoded box in detector pixels ``[N,A,4]``, the
    one the suppression compares."""
    n, h, w, _ = frames.shape
    x = image.resize(frames, (INPUT_SIZE, INPUT_SIZE), True, 1.0 / 255.0)
    logits, boxes = det(x)
    probs = torch.softmax(logits, -1)[..., :classes]
    s = INPUT_SIZE
    crop = boxes * torch.tensor([w / s, h / s, w / s, h / s],
                                device=boxes.device)
    crop = crop + torch.tensor([-margin, -margin, margin, margin],
                               device=boxes.device)
    lim = torch.tensor([w, h, w, h], dtype=torch.float32,
                       device=boxes.device)
    return probs, torch.minimum(crop.clamp(min=0.0), lim), boxes


@torch.no_grad()
def regress(reg, frames, boxes, crop_hw):
    """Crops of ``boxes [N,M,4]`` through the regressor → every class's
    keypoints after the sigmoid ``[N*M,9,9,2]`` and the logits
    ``[N*M,C]``."""
    scale, offset = reg_norm()
    crops = image.crop(frames, boxes, crop_hw, True, scale, offset)
    pre, logits = reg(crops)
    return torch.sigmoid(pre).view(-1, 9, 9, 2), logits


def iou(a, b):
    """Pairwise IoU of xyxy boxes ``[...,N,4]`` and ``[...,M,4]``."""
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


def decode(probs, boxes, score_thr, iou_thr, max_det, pre_k):
    """Each class's ``pre_k`` best anchors above ``score_thr``, greedy
    suppression above ``iou_thr`` in score order, then the ``max_det``
    best over the classes → ``[N, max_det, 6]`` (box, score, class),
    zero-padded; ties by the lower index."""
    n, a, c = probs.shape
    scores = torch.where(probs > score_thr, probs, 0.0).transpose(1, 2)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[..., :pre_k], idx[..., :pre_k]
    cand = torch.gather(boxes[:, None].expand(n, c, a, 4), 2,
                        idx[..., None].expand(n, c, pre_k, 4))
    over = (iou(cand, cand) > iou_thr) & torch.ones(
        (pre_k, pre_k), dtype=torch.bool, device=probs.device).tril(-1)
    keep = top > 0
    for i in range(1, pre_k):
        keep[..., i] &= ~(over[..., i, :] & keep).any(-1)
    kept = torch.where(keep, top, 0.0).reshape(n, c * pre_k)
    best, order = torch.sort(kept, dim=-1, descending=True, stable=True)
    best, order = best[:, :max_det], order[:, :max_det]
    box = torch.gather(cand.reshape(n, c * pre_k, 4), 1,
                       order[..., None].expand(-1, -1, 4))
    label = torch.div(order, pre_k, rounding_mode='floor').float()
    return torch.cat([box, best[..., None], label[..., None]], -1)


@torch.no_grad()
def rows(det, reg, frames, serve, crop_hw, classes):
    """The whole two-stage answer of the reference for uint8 frames
    ``[N,H,W,3]``: each frame's rows as the engine returns them (crop box,
    score, detector class, the keypoints of the regressor's class, that
    class), for the detections scoring above ``serve['det_conf']``."""
    n, h, w, _ = frames.shape
    x = image.resize(frames, (INPUT_SIZE, INPUT_SIZE), True, 1.0 / 255.0)
    logits, boxes = det(x)
    probs = torch.softmax(logits, -1)[..., :classes]
    m = serve['max_detections']
    dets = decode(probs, boxes, serve['score_thr'], serve['nms_iou'], m,
                  max(4 * m, 32))
    s = INPUT_SIZE
    crop = dets[..., :4] * torch.tensor([w / s, h / s, w / s, h / s],
                                        device=dets.device)
    margin = float(np.float32(serve['crop_margin_px']))
    crop = crop + torch.tensor([-margin, -margin, margin, margin],
                               device=dets.device)
    crop = torch.minimum(crop.clamp(min=0.0), torch.tensor(
        [w, h, w, h], dtype=torch.float32, device=dets.device))
    kp, logits = regress(reg, frames, crop, crop_hw)
    label = logits.argmax(-1)
    kp = kp[torch.arange(label.shape[0], device=label.device), label]
    kp = kp.reshape(n, m, 18)
    out = []
    for i in range(n):
        keep = dets[i, :, 4] > serve['det_conf']
        out.append({'boxes': crop[i][keep].cpu().numpy(),
                    'scores': dets[i, :, 4][keep].cpu().numpy(),
                    'det_labels': dets[i, :, 5][keep].cpu().numpy()
                    .astype(np.int32),
                    'kp': kp[i][keep].reshape(-1, 9, 2).cpu().numpy(),
                    'labels': label.view(n, m)[i][keep].cpu().numpy()
                    .astype(np.int32)})
    return out
