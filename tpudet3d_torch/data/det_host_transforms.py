"""Host-side geometric detector augmentations: Expand and
MinIoURandomCrop (copy of ``tpudet3d/data/det_host_transforms.py``).

``Expand(ratio_range=(1, 3))`` pastes the image onto a larger mean-filled
canvas; ``MinIoURandomCrop(min_ious=(.1,.3,.5,.7,.9), min_crop_size=0.1)``
samples a crop whose IoU with every kept box exceeds a sampled floor.  Both
change the canvas size, so they run on the host in the loader threads,
drawn from a ``RandomState`` seeded by (seed, epoch, index); the result is
resized back to the square detector input.  Without cv2 the pipeline is
off (``None``), as in the JAX package.
"""

import numpy as np

try:
    import cv2 as cv
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

__all__ = ['build_detection_host_pipeline']

_MIN_IOUS = (0.1, 0.3, 0.5, 0.7, 0.9)


def _expand(rng, img, boxes, ratio_range=(1, 3), mean=(104, 117, 124)):
    if rng.rand() > 0.5:
        return img, boxes
    h, w = img.shape[:2]
    ratio = rng.uniform(*ratio_range)
    eh, ew = int(h * ratio), int(w * ratio)
    top = rng.randint(0, eh - h + 1)
    left = rng.randint(0, ew - w + 1)
    canvas = np.empty((eh, ew, 3), img.dtype)
    canvas[...] = np.asarray(mean, img.dtype)
    canvas[top:top + h, left:left + w] = img
    out = boxes.copy()
    out[:, [0, 2]] += left
    out[:, [1, 3]] += top
    return canvas, out


def _iou_with_patch(boxes, patch):
    lt = np.maximum(boxes[:, :2], patch[:2])
    rb = np.minimum(boxes[:, 2:], patch[2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = np.clip(boxes[:, 2:] - boxes[:, :2], 0, None).prod(-1)
    patch_area = (patch[2] - patch[0]) * (patch[3] - patch[1])
    return inter / np.maximum(area + patch_area - inter, 1e-9)


def _min_iou_crop(rng, img, boxes, labels, valid, min_crop_size=0.1,
                  max_trials=50):
    h, w = img.shape[:2]
    mode = rng.choice(len(_MIN_IOUS) + 1)
    if mode == len(_MIN_IOUS):
        return img, boxes, labels, valid       # keep original
    min_iou = _MIN_IOUS[mode]
    live = boxes[valid]
    if not len(live):
        return img, boxes, labels, valid
    for _ in range(max_trials):
        cw = rng.uniform(min_crop_size * w, w)
        ch = rng.uniform(min_crop_size * h, h)
        if not 0.5 <= cw / ch <= 2.0:          # mmdet's aspect constraint
            continue
        x0 = rng.uniform(0, w - cw)
        y0 = rng.uniform(0, h - ch)
        patch = np.asarray([x0, y0, x0 + cw, y0 + ch])
        ious = _iou_with_patch(live, patch)
        if ious.min() < min_iou:
            continue
        centers = (live[:, :2] + live[:, 2:]) / 2
        keep = ((centers[:, 0] > patch[0]) & (centers[:, 0] < patch[2]) &
                (centers[:, 1] > patch[1]) & (centers[:, 1] < patch[3]))
        if not keep.any():
            continue
        crop = img[int(y0):int(y0 + ch), int(x0):int(x0 + cw)]
        new_boxes = np.zeros_like(boxes)
        new_labels = np.zeros_like(labels)
        new_valid = np.zeros_like(valid)
        kept = live[keep]
        kept[:, [0, 2]] = np.clip(kept[:, [0, 2]] - x0, 0, cw)
        kept[:, [1, 3]] = np.clip(kept[:, [1, 3]] - y0, 0, ch)
        n = min(len(kept), len(boxes))
        new_boxes[:n] = kept[:n]
        new_labels[:n] = labels[valid][keep][:n]
        new_valid[:n] = True
        return crop, new_boxes, new_labels, new_valid
    return img, boxes, labels, valid


def build_detection_host_pipeline(input_size=300, expand_ratio=(1, 3),
                                  seed=0, enable=True):
    """fn(epoch, index, img, boxes, labels, valid) applying Expand +
    MinIoURandomCrop + resize back to the square input."""
    if not (_HAS_CV2 and enable):
        return None

    def fn(epoch, index, img, boxes, labels, valid):
        rng = np.random.RandomState(
            (seed * 900_001 + epoch * 133_337 + index) % (2 ** 31 - 1))
        img2, boxes2 = _expand(rng, img, boxes, expand_ratio)
        img2, boxes2, labels2, valid2 = _min_iou_crop(rng, img2, boxes2,
                                                      labels, valid)
        h, w = img2.shape[:2]
        if (h, w) != (input_size, input_size):
            img2 = cv.resize(img2, (input_size, input_size),
                             interpolation=cv.INTER_LINEAR)
            boxes2 = boxes2 * np.asarray(
                [input_size / w, input_size / h] * 2, np.float32)
        return img2, boxes2.astype(np.float32), labels2, valid2

    return fn
