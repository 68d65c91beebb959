"""Keypoint box overlays for the demo (copy of the drawing helpers of
``tpudet3d/utils/drawing.py``).  cv2 is imported when something is drawn,
so importing this module needs no cv2.

The 9-keypoint convention: index 0 is the centre, 1..8 the box vertices in
±e1±e2±e3 binary order.
"""

import numpy as np

__all__ = ['EDGES', 'draw_kp', 'normalize_kp', 'unnormalize_kp']

# vertex-index pairs (into the 9-keypoint array) of the box wireframe
EDGES = ((1, 2), (1, 3), (1, 5), (2, 4), (2, 6), (3, 4), (3, 7), (4, 8),
         (5, 6), (5, 7), (6, 8), (7, 8))


def normalize_kp(image_shape, unnormalized_keypoints):
    """Pixel coords → [0,1]."""
    h, w = image_shape[:2]
    return np.asarray(unnormalized_keypoints, np.float32) / np.asarray(
        [w, h], np.float32)


def unnormalize_kp(image_shape, normalized_keypoints):
    """[0,1] → integer pixel coords."""
    h, w = image_shape[:2]
    return np.multiply(np.asarray(normalized_keypoints),
                       np.asarray([w, h], np.float32)).astype(int)


def draw_kp(img, keypoints, name=None, normalized=True, RGB=True,
            num_keypoints=9, label=None):
    """Draw the 9-keypoint box wireframe on a copy of ``img`` and optionally
    save it to ``name``."""
    import cv2 as cv
    img_copy = np.ascontiguousarray(np.asarray(img))
    if img_copy.shape[0] == 3:
        img_copy = np.transpose(img_copy, (1, 2, 0)).copy()
    if img_copy.dtype != np.uint8:
        img_copy = np.clip(img_copy, 0, 255).astype(np.uint8)
    if RGB:
        img_copy = cv.cvtColor(img_copy, cv.COLOR_RGB2BGR)
    kp = np.asarray(keypoints, np.float32).reshape(num_keypoints, 2)
    if normalized:
        kp = unnormalize_kp(img_copy.shape, kp)
    kp = kp.astype(int)
    for a, b in EDGES:
        cv.line(img_copy, tuple(kp[a]), tuple(kp[b]), (94, 218, 121), 2)
    for i, p in enumerate(kp):
        color = (0, 0, 255) if i == 0 else (255, 130, 0)
        cv.circle(img_copy, tuple(p), 4, color, -1)
    if label:
        cv.putText(img_copy, str(label), (10, 180), cv.FONT_HERSHEY_SIMPLEX,
                   1, (0, 255, 0), 2, cv.LINE_AA)
    if name:
        cv.imwrite(name, img_copy)
    return img_copy
