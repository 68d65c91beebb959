"""Host-side geometric augmentations: cv2 warps in the loader threads
(copy of ``tpudet3d/data/host_transforms.py``).

``random_rotate`` (with the keep-inside auto-scale) and ``random_rescale``
run here per sample, seeded by (seed, epoch, index), and the keypoints
follow the same affine.  Without cv2 ``build_host_pipeline`` returns None
and the geometric augmentations are off, as in the JAX package.
"""

import math

import numpy as np

try:
    import cv2 as cv
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

__all__ = ['HOST_TRANSFORMS', 'build_host_pipeline']


def _scale_by_angle(angle_deg, h, w):
    rad = math.radians(angle_deg)
    cos = math.cos(rad) - 1
    sin = math.sin(rad)
    delta_h = w / 2 * cos + h / 2 * sin
    delta_w = w / 2 * sin + h / 2 * cos
    return max(w / (w + 2 * abs(delta_w)), h / (h + 2 * abs(delta_h)))


def host_random_rotate(angle_limit=10.0, p=0.5, **_kw):
    def fn(rng, img, kps):
        if rng.rand() >= p:
            return img, kps
        h, w = img.shape[:2]
        angle = rng.uniform(-angle_limit, angle_limit)
        scale = _scale_by_angle(angle, h, w)
        m = cv.getRotationMatrix2D((w * 0.5, h * 0.5), angle, scale)
        out = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR)
        new_kps = kps @ m[:, :2].T + m[:, 2]
        return out, new_kps.astype(np.float32)
    return fn


def host_random_rescale(scale_limit=0.1, p=0.5, **_kw):
    lo, hi = ((scale_limit[0], scale_limit[1])
              if isinstance(scale_limit, (tuple, list))
              else (-scale_limit, scale_limit))

    def fn(rng, img, kps):
        if rng.rand() >= p:
            return img, kps
        h, w = img.shape[:2]
        scale = 1.0 + rng.uniform(lo, hi)
        m = cv.getRotationMatrix2D((w * 0.5, h * 0.5), 0, scale)
        out = cv.warpAffine(img, m, (w, h), flags=cv.INTER_LINEAR)
        # keypoints scale about the origin
        m_kp = cv.getRotationMatrix2D((0.0, 0.0), 0, scale)
        new_kps = kps @ m_kp[:, :2].T + m_kp[:, 2]
        return out, new_kps.astype(np.float32)
    return fn


HOST_TRANSFORMS = {
    'random_rotate': host_random_rotate,
    'random_rescale': host_random_rescale,
}


def build_host_pipeline(pipeline_cfg, seed=0):
    """The host-side (geometric) steps of a declarative pipeline config as
    ``fn(epoch, index, img, kps) -> (img, kps)``, or None (no such step,
    or no cv2)."""
    if not _HAS_CV2:
        return None
    steps = [HOST_TRANSFORMS[name](**dict(kwargs))
             for name, kwargs in pipeline_cfg if name in HOST_TRANSFORMS]
    if not steps:
        return None

    def fn(epoch, index, img, kps):
        rng = np.random.RandomState(
            (seed * 1_000_003 + epoch * 97_001 + index) % (2 ** 31 - 1))
        for step in steps:
            img, kps = step(rng, img, kps)
        return img, kps

    return fn
