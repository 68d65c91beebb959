"""Detector validation: VOC-style mAP (counterpart of
``tpudet3d/detect/eval.py``).

A batched forward in eval mode (the EMA or the weights, with the trained
batch statistics), the decode and NMS of kernel K3 once per batch
(``max_per_img`` 100, ``pre_nms_k`` 200), then the JAX package's
score-ranked matching on the host and all-point interpolated AP at an IoU
threshold.

Under a process group each rank matches its own images; ``results``
gathers every rank's (score, matched) records and ground-truth counts
before AP, since AP ranks all detections by score.  The records are put
in the order one process would have made them: image ``j`` of rank ``r``
is image ``r + world·j`` of the loader's interleaved stream.
"""

from collections import defaultdict

import numpy as np
import torch

from ..parallel import sharding
from .anchors import generate_anchors
from .nms import decode_detections

__all__ = ['average_precision', 'DetectorEvaluator']


def average_precision(scores, matched, num_gt):
    """All-point interpolated AP: scores [N], matched [N] bool, num_gt."""
    if num_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    matched = np.asarray(matched)[order]
    tp = np.cumsum(matched)
    fp = np.cumsum(~matched)
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    # integrate over recall steps
    idx = np.where(np.diff(np.concatenate([[0.0], recall])) > 0)[0]
    return float(np.sum(precision[idx] *
                        np.diff(np.concatenate([[0.0], recall]))[idx]))


class DetectorEvaluator:
    """Accumulates detections and ground truth; reports per-class AP and
    mAP.  ``params`` (name → tensor, e.g. the EMA) stand in for the
    model's parameters; None uses the model's own."""

    def __init__(self, model, params=None, num_classes=9, iou_thr=0.5,
                 score_thr=0.02, max_per_img=100):
        self.model = model
        self.params = params
        self.num_classes = num_classes
        self.iou_thr = iou_thr
        self.score_thr = score_thr
        self.max_per_img = max_per_img
        self._anchors = torch.from_numpy(generate_anchors())
        self._records = defaultdict(list)   # cls -> [(score, matched)]
        self._order = defaultdict(list)     # cls -> [(image, record)]
        self._num_gt = np.zeros(num_classes, np.int64)
        self._images = 0                    # images added on this rank
        self._n = 0                         # records added on this rank

    @torch.no_grad()
    def detect(self, imgs):
        """imgs: normalised ``[B,S,S,3]`` on the model's device →
        ``[B,max_per_img,6]`` rows on that device (K3, one launch)."""
        if self.params is None:
            logits, deltas = self.model(imgs)
        else:
            logits, deltas = torch.func.functional_call(
                self.model, self.params, (imgs,))
        if self._anchors.device != logits.device:
            self._anchors = self._anchors.to(logits.device)
        return decode_detections(logits, deltas, self._anchors,
                                 score_thr=self.score_thr,
                                 max_per_img=self.max_per_img,
                                 pre_nms_k=2 * self.max_per_img)

    def add_batch(self, imgs, gt_boxes, gt_labels, gt_valid, dets=None):
        """imgs: normalised ``[B,S,S,3]``; ground truth in input pixels,
        padded, with its mask (numpy).  ``dets`` (``detect``'s rows) skips
        the forward."""
        if dets is None:
            dets = self.detect(imgs)
        dets = dets.cpu().numpy()
        for b in range(dets.shape[0]):
            image = self._images * sharding.world() + sharding.rank()
            self._images += 1
            boxes = np.asarray(gt_boxes[b])[np.asarray(gt_valid[b])]
            labels = np.asarray(gt_labels[b])[np.asarray(gt_valid[b])]
            for c in np.unique(labels):
                self._num_gt[int(c)] += int(np.sum(labels == c))
            used = np.zeros(len(boxes), bool)
            for x0, y0, x1, y1, score, label in dets[b]:
                if score <= 0:
                    continue
                label = int(label)
                cand = np.nonzero((labels == label) & ~used)[0]
                matched = False
                if len(cand):
                    gb = boxes[cand]
                    ix0 = np.maximum(gb[:, 0], x0)
                    iy0 = np.maximum(gb[:, 1], y0)
                    ix1 = np.minimum(gb[:, 2], x1)
                    iy1 = np.minimum(gb[:, 3], y1)
                    inter = (np.clip(ix1 - ix0, 0, None) *
                             np.clip(iy1 - iy0, 0, None))
                    area_d = max((x1 - x0) * (y1 - y0), 0)
                    area_g = np.clip(gb[:, 2] - gb[:, 0], 0, None) * \
                        np.clip(gb[:, 3] - gb[:, 1], 0, None)
                    ious = inter / np.maximum(area_d + area_g - inter, 1e-9)
                    best = int(np.argmax(ious))
                    if ious[best] >= self.iou_thr:
                        used[cand[best]] = True
                        matched = True
                self._records[label].append((float(score), matched))
                self._order[label].append((image, self._n))
                self._n += 1

    def results(self):
        """{class_id: AP} and 'mAP' over the classes with ground truth."""
        records, num_gt = self._records, self._num_gt
        if sharding.world() > 1:
            records, num_gt = self._gathered()
        out = {}
        aps = []
        for c in range(self.num_classes):
            recs = records.get(c, [])
            scores = [r[0] for r in recs]
            matched = [r[1] for r in recs]
            ap = average_precision(scores, matched, int(num_gt[c]))
            out[c] = ap
            if num_gt[c] > 0:
                aps.append(ap)
        out['mAP'] = float(np.mean(aps)) if aps else 0.0
        return out

    def _gathered(self):
        """Every rank's records, in one process's order, and the summed
        ground-truth counts."""
        rows = [(c, image, n, score, matched)
                for c in self._records
                for (score, matched), (image, n) in zip(self._records[c],
                                                        self._order[c])]
        rows = sharding.gather_rows(np.asarray(rows, np.float64)
                                    .reshape(-1, 5))
        rows = rows[np.lexsort((rows[:, 2], rows[:, 1]))]
        records = defaultdict(list)
        for c, _, _, score, matched in rows:
            records[int(c)].append((float(score), bool(matched)))
        num_gt = sharding.gather_rows(self._num_gt[None]).sum(0)
        return records, num_gt.astype(np.int64)
