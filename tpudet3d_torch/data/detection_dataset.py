"""Full-frame detection dataset (COCO JSON) and its synthetic twin for
the SSD stage (copy of ``tpudet3d/data/detection_dataset.py``).

Items are grouped per image with all ground-truth boxes, padded to a
static ``max_boxes`` with a validity mask: (img uint8 BGR [S,S,3], boxes
[G,4] in input pixels, labels [G] int32, valid [G] bool).  The detector's
class order (``DETECTOR_CLASSES``) swaps camera and cereal_box against the
regressor's.  Without cv2, ``SyntheticDetection`` draws nothing (hard
scenes fall back to the easy layout) and ``DetectionDataset`` cannot read
its JPEGs, as in the JAX package.
"""

import json
import os.path as osp
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..core import DETECTOR_CLASSES
from .dataset import PALETTE, cv2_missing

try:
    import cv2 as cv
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

__all__ = ['DetectionDataset', 'SyntheticDetection', 'MAX_BOXES']

MAX_BOXES = 16


def _pad_boxes(boxes, labels, max_boxes=MAX_BOXES):
    out_b = np.zeros((max_boxes, 4), np.float32)
    out_l = np.zeros((max_boxes,), np.int32)
    out_v = np.zeros((max_boxes,), bool)
    n = min(len(boxes), max_boxes)
    if n:
        out_b[:n] = boxes[:n]
        out_l[:n] = labels[:n]
        out_v[:n] = True
    return out_b, out_l, out_v


class DetectionDataset:
    """Per-image COCO detection items, resized to the static input size."""

    def __init__(self, root_folder, mode='train', input_size=300,
                 min_size=17, max_boxes=MAX_BOXES):
        self.root = str(root_folder)
        self.input_size = input_size
        self.max_boxes = max_boxes
        ann_name = ('objectron_train.json' if mode == 'train'
                    else 'objectron_test.json')
        with open(Path(root_folder).resolve() / 'annotations' / ann_name) as f:
            ann = json.load(f)
        self.images = {img['id']: img for img in ann['images']}
        per_image = defaultdict(list)
        for a in ann['annotations']:
            x, y, w, h = a['bbox']
            if min(w, h) < min_size:   # mmdet's min_size=17
                continue
            per_image[a['image_id']].append(
                (np.asarray([x, y, x + w, y + h], np.float32),
                 int(a['category_id']) - 1))
        self.items = [(img_id, anns) for img_id, anns in per_image.items()
                      if anns]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        if not _HAS_CV2:
            raise cv2_missing('DetectionDataset (reading its JPEGs)')
        img_id, anns = self.items[idx]
        info = self.images[img_id]
        path = osp.join(self.root, info['file_name'])
        img = cv.imread(path)
        if img is None:
            raise FileNotFoundError(f'cannot read image {path}')
        h, w = img.shape[:2]
        s = self.input_size
        img = cv.resize(img, (s, s), interpolation=cv.INTER_LINEAR)
        boxes = np.stack([b for b, _ in anns])
        boxes = boxes * np.asarray([s / w, s / h, s / w, s / h], np.float32)
        labels = np.asarray([l for _, l in anns], np.int32)
        return (img,) + _pad_boxes(boxes, labels, self.max_boxes)


class SyntheticDetection:
    """Random rectangles on noise: the SSD train loop end to end without
    the converted dataset.  ``hard`` draws 2-6 textured, overlapping
    objects at the clustered anchors' scales among unlabelled clutter."""

    def __init__(self, length=512, input_size=300, max_boxes=MAX_BOXES,
                 seed=11, num_classes=len(DETECTOR_CLASSES), hard=False):
        self.length = length
        self.input_size = input_size
        self.max_boxes = max_boxes
        self.seed = seed
        self.num_classes = num_classes
        self.hard = hard

    def __len__(self):
        return self.length

    # per-class colours, so the class can be told from the pixels
    _PALETTE = PALETTE

    def _draw_easy(self, rng, img, s):
        n = rng.randint(1, 4)
        boxes, labels = [], []
        for _ in range(n):
            w = rng.uniform(0.2, 0.7) * s
            h = rng.uniform(0.2, 0.7) * s
            x0 = rng.uniform(0, s - w)
            y0 = rng.uniform(0, s - h)
            label = rng.randint(0, self.num_classes)
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(label)
            if _HAS_CV2:
                color = tuple(int(c) for c in self._PALETTE[label])
                cv.rectangle(img, (int(x0), int(y0)),
                             (int(x0 + w), int(y0 + h)), color, -1)
        return boxes, labels

    def _draw_hard(self, rng, img, s):
        """2-6 objects, box scales in the clustered anchors' range (widths
        0.23-0.80, heights 0.23-0.83 of the input), occlusion in z-order,
        textured objects (border and interior pattern), unlabelled
        clutter."""
        # unlabeled clutter the detector must learn to ignore
        for _ in range(rng.randint(2, 6)):
            c = rng.randint(90, 150)
            center = (rng.randint(0, s), rng.randint(0, s))
            cv.circle(img, center, rng.randint(8, 40),
                      (int(c), int(c), int(c)), -1)
        n = rng.randint(2, 7)
        boxes, labels = [], []
        for _ in range(n):
            w = rng.uniform(0.23, 0.80) * s
            h = np.clip(w * rng.uniform(0.65, 1.55), 0.23 * s, 0.83 * s)
            if boxes and rng.rand() < 0.5:
                # occlusion: place near an existing object
                bx = boxes[rng.randint(0, len(boxes))]
                cx = np.clip((bx[0] + bx[2]) / 2 + rng.uniform(-0.3, 0.3) * s,
                             w / 2, s - w / 2)
                cy = np.clip((bx[1] + bx[3]) / 2 + rng.uniform(-0.3, 0.3) * s,
                             h / 2, s - h / 2)
            else:
                cx = rng.uniform(w / 2, s - w / 2)
                cy = rng.uniform(h / 2, s - h / 2)
            x0, y0 = cx - w / 2, cy - h / 2
            label = rng.randint(0, self.num_classes)
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(label)
            color = tuple(int(c) for c in self._PALETTE[label])
            dark = tuple(int(c * 0.5) for c in self._PALETTE[label])
            p0, p1 = (int(x0), int(y0)), (int(x0 + w), int(y0 + h))
            cv.rectangle(img, p0, p1, color, -1)
            cv.rectangle(img, p0, p1, dark, 2)
            # interior pattern: diagonal + small filled circle
            cv.line(img, p0, p1, dark, 2)
            cv.circle(img, (int(cx), int(cy)), max(int(min(w, h) * 0.12), 2),
                      dark, -1)
        return boxes, labels

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 9176 + idx)
        s = self.input_size
        img = rng.randint(0, 64, (s, s, 3)).astype(np.uint8)   # dim noise bg
        if self.hard and _HAS_CV2:
            boxes, labels = self._draw_hard(rng, img, s)
        else:
            boxes, labels = self._draw_easy(rng, img, s)
        return (img,) + _pad_boxes(np.asarray(boxes, np.float32),
                                   np.asarray(labels, np.int32),
                                   self.max_boxes)
