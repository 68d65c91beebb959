"""Self-labelled training crops: the trained detector's own boxes
(counterpart of ``tpudet3d/data/selflabel.py``).

At deployment the regressor sees crops of the detector's predicted boxes,
in training the ground-truth keypoint extents ±10 px.  This runs the
trained detector once over the training scenes, matches each ground-truth
object to its best-IoU predicted box and writes those boxes (frame pixels)
to an npz; ``SceneCrops(det_boxes=...)`` then mixes crops of them, at the
engine's deploy geometry, into regressor training.
"""

import os
import os.path as osp

import numpy as np

__all__ = ['match_boxes_to_gt', 'generate_selflabel_boxes',
           'load_selflabel_boxes']


def match_boxes_to_gt(pred_boxes, gt_boxes, iou_thr=0.25):
    """Greedy best-IoU assignment of predicted boxes to GT boxes.

    pred_boxes [P,4], gt_boxes [G,4] (xyxy, same pixel space) →
    (boxes [G,4] float32, valid [G] bool): for each GT object the
    highest-IoU prediction with IoU >= iou_thr, each prediction used at
    most once (GTs visited in descending best-IoU order).  Class-agnostic
    on purpose: the deploy crop geometry comes from whatever box the
    detector draws over the object, regardless of its predicted label
    (the engine crops every confident detection, infer/engine.py)."""
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 4)
    g, p = len(gt_boxes), len(pred_boxes)
    out = np.zeros((g, 4), np.float32)
    valid = np.zeros(g, bool)
    if g == 0 or p == 0:
        return out, valid
    ix0 = np.maximum(gt_boxes[:, None, 0], pred_boxes[None, :, 0])
    iy0 = np.maximum(gt_boxes[:, None, 1], pred_boxes[None, :, 1])
    ix1 = np.minimum(gt_boxes[:, None, 2], pred_boxes[None, :, 2])
    iy1 = np.minimum(gt_boxes[:, None, 3], pred_boxes[None, :, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area_g = np.clip(gt_boxes[:, 2] - gt_boxes[:, 0], 0, None) * \
        np.clip(gt_boxes[:, 3] - gt_boxes[:, 1], 0, None)
    area_p = np.clip(pred_boxes[:, 2] - pred_boxes[:, 0], 0, None) * \
        np.clip(pred_boxes[:, 3] - pred_boxes[:, 1], 0, None)
    iou = inter / np.maximum(area_g[:, None] + area_p[None] - inter, 1e-9)
    used = np.zeros(p, bool)
    for gi in np.argsort(-iou.max(axis=1)):
        row = np.where(used, -1.0, iou[gi])
        pi = int(np.argmax(row))
        if row[pi] >= iou_thr:
            out[gi] = pred_boxes[pi]
            valid[gi] = True
            used[pi] = True
    return out, valid


def generate_selflabel_boxes(scene, det_checkpoint, out_path,
                             score_thr=0.05, iou_match=0.25, batch=32,
                             max_per_img=16, box_vote_iou=0.0, device=None):
    """Run the trained detector over every scene of ``scene``
    (``SyntheticScene``) and write the matched per-object predicted boxes
    (frame pixels) to ``out_path`` (.npz), on ``device`` (the card unless
    ``'cpu'``).

    The forward is the deploy engine's stage 1: frame → cv2 300² resize →
    BGR→RGB /255 → the bf16 SSD (``load_detector``) → K3, one launch a
    batch (``pre_nms_k = 4·max_per_img``); boxes go back to frame pixels by
    (w/300, h/300).  Matching is class-agnostic best IoU
    (``match_boxes_to_gt``).  Returns (n_matched, n_objects)."""
    import torch

    from ..core.device import resolve_device
    from ..detect import (INPUT_SIZE, decode_detections, generate_anchors,
                          load_detector)

    device = resolve_device(device)
    import cv2 as cv
    detector = load_detector(det_checkpoint, dtype=torch.bfloat16,
                             device=device)
    anchors = torch.from_numpy(generate_anchors()).to(device)

    n_scenes = len(scene)
    h, w = scene.frame_hw
    max_obj = scene.max_objects
    all_boxes = np.zeros((n_scenes, max_obj, 4), np.float32)
    all_valid = np.zeros((n_scenes, max_obj), bool)
    n_matched = n_objects = 0
    scale = np.asarray([w / INPUT_SIZE, h / INPUT_SIZE] * 2, np.float32)

    for start in range(0, n_scenes, batch):
        idxs = range(start, min(start + batch, n_scenes))
        samples = [scene.sample(i) for i in idxs]
        imgs = np.stack([cv.resize(s['img'], (INPUT_SIZE, INPUT_SIZE),
                                   interpolation=cv.INTER_LINEAR)
                         for s in samples])
        with torch.no_grad():
            x = torch.from_numpy(imgs).to(device).float().flip(-1) / 255.0
            logits, deltas = detector(x)
            dets = decode_detections(
                logits, deltas, anchors, score_thr=score_thr,
                max_per_img=max_per_img, box_vote_iou=box_vote_iou,
                pre_nms_k=4 * max_per_img).cpu().numpy()
        for bi, (i, s) in enumerate(zip(idxs, samples)):
            rows = dets[bi]
            rows = rows[rows[:, 4] > 0]
            pred = rows[:, :4] * scale
            # ground truth: the keypoints' extents in frame pixels
            kps_px = s['kps2d'] * np.asarray([w, h], np.float32)
            gt = np.concatenate([kps_px.min(axis=1), kps_px.max(axis=1)],
                                axis=1)
            boxes, valid = match_boxes_to_gt(pred, gt, iou_thr=iou_match)
            k = len(gt)
            all_boxes[i, :k] = boxes
            all_valid[i, :k] = valid
            n_matched += int(valid.sum())
            n_objects += k

    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    np.savez(out_path, boxes=all_boxes, valid=all_valid,
             seed=scene.seed, length=n_scenes, frame_hw=np.asarray([h, w]),
             score_thr=score_thr, iou_match=iou_match)
    return n_matched, n_objects


def load_selflabel_boxes(path, scene):
    """Load a ``generate_selflabel_boxes`` npz, checking that it was made
    for the same scene stream (seed, length, frame size): another file
    would pair boxes with the wrong scenes."""
    z = np.load(path)
    if int(z['seed']) != int(scene.seed) or \
            int(z['length']) != len(scene) or \
            tuple(int(v) for v in z['frame_hw']) != tuple(scene.frame_hw):
        raise ValueError(
            f'selflabel boxes {path} were generated for scene '
            f'(seed={int(z["seed"])}, length={int(z["length"])}, '
            f'frame_hw={tuple(z["frame_hw"])}) but the training scene is '
            f'(seed={scene.seed}, length={len(scene)}, '
            f'frame_hw={scene.frame_hw}) — regenerate with '
            f'python -m tpudet3d_torch.tools.selflabel_boxes')
    return z['boxes'], z['valid']
