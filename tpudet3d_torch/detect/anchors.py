"""Clustered SSD anchors (copy of the constants and generator of
``tpudet3d/detect/anchors.py``)."""

import math

import numpy as np

__all__ = ['CLUSTERED_WIDTHS', 'CLUSTERED_HEIGHTS', 'STRIDES', 'INPUT_SIZE',
           'generate_anchors', 'num_anchors_per_level']

INPUT_SIZE = 300
STRIDES = (16, 32)

# fractions of the 300px input (clustered on Objectron 2D boxes)
CLUSTERED_WIDTHS = (
    (0.2579684384230685, 0.4627705986569778, 0.34682129636083536,
     0.641596163690939),
    (0.5420266488537757, 0.430022826081911, 0.7605568897973095,
     0.6358004294180672, 0.5529565428117278, 0.8008912664437589),
)
CLUSTERED_HEIGHTS = (
    (0.2270640055663951, 0.30064816327707244, 0.4627093933691148,
     0.33801734483143625),
    (0.47856221526606557, 0.6557960498140745, 0.49101025166070583,
     0.6256796503549162, 0.8331586024284066, 0.7244268959927074),
)


def num_anchors_per_level():
    return tuple(len(w) for w in CLUSTERED_WIDTHS)


def generate_anchors(input_size=INPUT_SIZE):
    """[A,4] float32 (x1,y1,x2,y2) anchors over all levels, row-major per
    level, anchor-index fastest (the head's reshape order)."""
    all_anchors = []
    for stride, ws, hs in zip(STRIDES, CLUSTERED_WIDTHS, CLUSTERED_HEIGHTS):
        fm = math.ceil(input_size / stride)
        centers = (np.arange(fm, dtype=np.float32) + 0.5) * stride
        cx, cy = np.meshgrid(centers, centers)          # [fm, fm]
        w = np.asarray(ws, np.float32) * input_size     # [k]
        h = np.asarray(hs, np.float32) * input_size
        cx = cx[:, :, None]
        cy = cy[:, :, None]
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         axis=-1)                        # [fm, fm, k, 4]
        all_anchors.append(boxes.reshape(-1, 4))
    return np.concatenate(all_anchors, axis=0)
