"""Objectron crop dataset (COCO-style JSON + JPEGs) and a synthetic twin
(copy of ``tpudet3d/data/dataset.py``).

* keypoints clipped to [3, dim-3] before cropping;
* crop box = keypoint extent ±10 px (or ``jitter_margins`` in train mode
  with ``crop_jitter``), clamped to the frame;
* 1-based COCO ``category_id`` → 0-based, the nearest class when
  ``num_classes < 9``; category filtering;
* train/val items → (image, kps, category); test items add the original
  frame and the crop coordinates.

Items are resized to the static target size here (host, cv2) and the
keypoints are returned in resized-pixel coordinates; augmentation and
normalisation run batched on the device (``data/transforms.py``).

Without cv2 ``SyntheticObjectron`` draws noise and no box, as the JAX
package's does, and ``Objectron`` cannot read its JPEGs.
"""

import json
import os.path as osp
from pathlib import Path

import numpy as np

from ..core import OBJECTRON_CLASSES

try:
    import cv2 as cv
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

__all__ = ['Objectron', 'SyntheticObjectron', 'jitter_margins']

# strong, well-separated per-class colors (class must be inferable)
PALETTE = np.asarray(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [128, 128, 0]], np.uint8)


def cv2_missing(what):
    return RuntimeError(f'{what} needs cv2 (opencv-python), which is not '
                        f'installed')


def _clamp(x, lo, hi):
    return min(max(x, lo), hi)


def jitter_margins(seed, idx, epoch=0):
    """Deterministic per-(example, epoch) crop margins, U(2, 18) px per
    side (mean 10, the fixed margin).  Seeded by (seed, idx, epoch), so the
    threaded loader's interleaving never touches the draw."""
    mix = (seed * 1000003 + idx * 97 + epoch * 7919) & 0x7fffffff
    return np.random.RandomState(mix).uniform(2.0, 18.0, size=4)


def draw_box(img, kps_px, category, thickness):
    """Render a filled, class-colored box wireframe with a distinct marker
    per vertex into ``img`` (BGR uint8, in place)."""
    from ..utils.drawing import EDGES
    pts = kps_px.astype(int)
    color = tuple(int(c) for c in PALETTE[category])
    dim = tuple(int(c * 0.45) for c in PALETTE[category])
    hull = cv.convexHull(pts[1:].reshape(-1, 1, 2))
    cv.fillConvexPoly(img, hull, dim)
    for a, b in EDGES:
        cv.line(img, tuple(pts[a]), tuple(pts[b]), color, thickness)
    cv.circle(img, tuple(pts[0]), thickness + 1, (255, 255, 255), -1)
    # a symmetric box has no canonical vertex order from pixels alone
    for v in range(1, 9):
        shade = int(30 + 25 * v)
        cv.circle(img, tuple(pts[v]), thickness + 1,
                  (shade, 255 - shade, 255 if v % 2 else 80), -1)


class Objectron:
    """Map-style dataset over the converted COCO annotations."""

    def __init__(self, root_folder, mode='train', resize=(224, 224),
                 debug_mode=False, category_list='all', crop_jitter=False,
                 seed=0):
        if mode not in ('train', 'val', 'test'):
            raise RuntimeError('Unknown dataset mode')
        self.root_folder = str(root_folder)
        self.mode = mode
        self.resize = tuple(resize)
        self.debug_mode = debug_mode
        self.seed = int(seed)
        self.crop_jitter = bool(crop_jitter) and mode == 'train'
        self._epoch = 0
        self.num_classes = (len(category_list)
                            if isinstance(category_list, (list, tuple))
                            else len(OBJECTRON_CLASSES))
        ann_name = ('objectron_train.json' if mode == 'train'
                    else 'objectron_test.json')
        ann_path = Path(root_folder).resolve() / 'annotations' / ann_name
        with open(ann_path, 'r') as f:
            ann = json.load(f)
        if category_list != 'all':
            self.annotations = [
                a for a in ann['annotations']
                if OBJECTRON_CLASSES[a['category_id'] - 1] in category_list]
            image_ids = {a['image_id'] for a in self.annotations}
            self.images = {img['id']: img for img in ann['images']
                           if img['id'] in image_ids}
        else:
            self.annotations = ann['annotations']
            self.images = {img['id']: img for img in ann['images']}

    def set_epoch(self, epoch):
        """Called by BatchLoader per epoch: varies the crop-jitter draws."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, idx):
        if not _HAS_CV2:
            raise cv2_missing('Objectron (JPEG decoding and resizing)')
        ann = self.annotations[idx]
        cat_id = int(ann['category_id']) - 1
        category = min(range(self.num_classes), key=lambda x: abs(x - cat_id))
        img_path = osp.join(self.root_folder,
                            self.images[ann['image_id']]['file_name'])
        image = cv.imread(img_path)
        if image is None:
            raise FileNotFoundError(f'missing image {img_path}')
        kps = np.asarray(ann['keypoints'], np.float32).reshape(9, 2)
        if self.debug_mode:
            from ..utils.drawing import draw_kp
            draw_kp(image, kps, f'image_before_pipeline_{idx}.jpg',
                    normalized=False, RGB=False)
        margins = (jitter_margins(self.seed, idx, self._epoch)
                   if self.crop_jitter else None)
        crop_kps, crop_img, crop_cords = self.crop(image, kps, margins)
        th, tw = self.resize
        ch, cw = crop_img.shape[:2]
        resized = cv.resize(crop_img, (tw, th), interpolation=cv.INTER_LINEAR)
        kps_px = crop_kps * np.asarray([tw / cw, th / ch], np.float32)
        if self.mode == 'test':
            return image, resized, kps_px, category, crop_cords
        return resized, kps_px, category

    def crop(self, image, keypoints, margins=None):
        """Clip keypoints, derive the ±10 px box (or ``margins``), crop."""
        real_h, real_w = image.shape[:2]
        clipped = self.clip_bb(keypoints, real_w, real_h)
        if margins is not None:
            ml, mt, mr, mb = margins
        else:
            ml = mt = mr = mb = 10.0
        x0 = int(_clamp(clipped[:, 0].min() - ml, 0, real_w))
        y0 = int(_clamp(clipped[:, 1].min() - mt, 0, real_h))
        x1 = int(_clamp(clipped[:, 0].max() + mr, 0, real_w))
        y1 = int(_clamp(clipped[:, 1].max() + mb, 0, real_h))
        crop_img = image[y0:y1, x0:x1]
        shifted = clipped - np.asarray([x0, y0], np.float32)
        return shifted.astype(np.float32), crop_img, (x0, y0, x1, y1)

    @staticmethod
    def clip_bb(kps, w, h):
        """Clip keypoint coords to [3, dim-3]."""
        out = np.empty_like(kps, dtype=np.float32)
        out[:, 0] = np.clip(kps[:, 0], 3, w - 3)
        out[:, 1] = np.clip(kps[:, 1], 3, h - 3)
        return out


class SyntheticObjectron:
    """Procedurally generated valid box projections, API-compatible with
    ``Objectron``."""

    def __init__(self, length=1024, mode='train', resize=(224, 224), seed=7,
                 category_list='all', num_classes=9):
        self.length = length
        self.mode = mode
        self.resize = tuple(resize)
        self.seed = seed
        self.num_classes = (len(category_list)
                            if isinstance(category_list, (list, tuple))
                            else num_classes)

    def __len__(self):
        return self.length

    def _box_projection(self, rng):
        """Random 3D box in front of the camera → 9 projected keypoints."""
        scale = rng.uniform(0.2, 0.6, size=3)
        angles = rng.uniform(-np.pi, np.pi, size=3)
        cx_, sx = np.cos(angles[0]), np.sin(angles[0])
        cy_, sy = np.cos(angles[1]), np.sin(angles[1])
        cz_, sz = np.cos(angles[2]), np.sin(angles[2])
        rot = (np.array([[1, 0, 0], [0, cx_, -sx], [0, sx, cx_]]) @
               np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]]) @
               np.array([[cz_, -sz, 0], [sz, cz_, 0], [0, 0, 1]]))
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                      rng.uniform(-3.0, -1.5)])
        corners = np.array([[sx_, sy_, sz_] for sx_ in (-1, 1)
                            for sy_ in (-1, 1) for sz_ in (-1, 1)], np.float64)
        pts = np.concatenate([[np.zeros(3)], corners * scale / 2]) @ rot.T + t
        # normalized screen coords: s = p_xy/(-z) + 0.5 (z < 0)
        return pts[:, :2] / (-pts[:, 2:3]) + 0.5

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        for _ in range(32):
            kps01 = self._box_projection(rng)
            if np.all(kps01 > 0.05) and np.all(kps01 < 0.95):
                break
        th, tw = self.resize
        kps_px = (kps01 * np.asarray([tw, th])).astype(np.float32)
        category = int(rng.randint(0, self.num_classes))
        img = rng.randint(0, 64, size=(th, tw, 3)).astype(np.uint8)
        if _HAS_CV2:
            draw_box(img, kps_px, category,
                     max(int(round(min(th, tw) / 100)), 2))
        if self.mode == 'test':
            return img, img.copy(), kps_px, category, (0, 0, tw, th)
        return img, kps_px, category
