"""Coherent full-frame synthetic scenes with exact 3D geometry (copy of
``tpudet3d/data/synthetic_scene.py``).

Each scene is a set of upright 3D boxes standing on one ground plane,
projected through the default Objectron camera and rendered class-colored
into the frame.  From one sample come the detector's items
(``SceneDetection``: the frame and the keypoints' 2D extents), the
regressor's (``SceneCrops``: the Objectron dataset's crop semantics, or
with ``det_boxes`` the trained detector's own boxes at the engine's deploy
margin) and the protocol's evaluation shards (``write_eval_shards``:
``tf.train.Example`` TFRecords).  2D keypoints are ``(s_y, s_x)`` of the
pinhole projection, the portrait convention of the protocol CLI.  Without
cv2 a scene is noise with no object drawn, as in the JAX package, and
``SceneCrops`` cannot resize its crops.
"""

import hashlib
import os
import os.path as osp
import struct
import tempfile

import numpy as np

from ..core import DETECTOR_TO_REGRESSOR_CLS, OBJECTRON_CLASSES
from ..core.crc32c import tfrecord_frame
from .dataset import cv2_missing, draw_box, jitter_margins
from .detection_dataset import MAX_BOXES, _pad_boxes

try:
    import cv2 as cv
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False

__all__ = ['SyntheticScene', 'SceneDetection', 'SceneCrops',
           'write_eval_shards']

# regressor class id -> detector class id (camera/cereal_box swapped)
REGRESSOR_TO_DETECTOR_CLS = tuple(
    DETECTOR_TO_REGRESSOR_CLS.index(i)
    for i in range(len(DETECTOR_TO_REGRESSOR_CLS)))

# vertex order matching EPNP_ALPHA: x slowest, then y, then z
_CORNER_SIGNS = np.array([[sx, sy, sz] for sx in (-1, 1)
                          for sy in (-1, 1) for sz in (-1, 1)], np.float64)


def _unit(v):
    return v / np.linalg.norm(v)


def _pinhole(points):
    """Camera-space points (z<0) → [0,1] screen coords with principal point
    0.5: s = p_xy/(-z) + 0.5, the convention the EPnP lift inverts."""
    points = np.asarray(points, np.float64)
    return points[..., :2] / (-points[..., 2:3]) + 0.5


class SyntheticScene:
    """Procedural scenes: N upright boxes on one ground plane, exact
    camera-space 3D keypoints + portrait-convention 2D keypoints."""

    _CACHE_VERSION = 1   # bump when _render_sample's output changes

    def __init__(self, length=256, frame_hw=(480, 640), seed=23,
                 min_objects=1, max_objects=3, classes=None,
                 clutter=True, cache_dir=''):
        self.length = length
        self.frame_hw = tuple(frame_hw)
        self.seed = seed
        self.min_objects = min_objects
        self.max_objects = max_objects
        # regressor-order class ids this generator may emit
        self.classes = (tuple(range(len(OBJECTRON_CLASSES)))
                        if classes is None else tuple(classes))
        self.clutter = clutter
        # optional on-disk cache: PNG frame + exact float keypoints in one
        # npz, so cached and rendered items are bit-identical
        self.cache_dir = str(cache_dir or '')
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)

    def __len__(self):
        return self.length

    def _sample_plane(self, rng):
        normal = _unit(np.array([rng.uniform(-0.12, 0.12), 1.0,
                                 rng.uniform(-0.12, 0.12)]))
        foot = np.array([0.0, rng.uniform(-1.1, -0.7),
                         rng.uniform(-2.8, -2.0)])
        t1 = _unit(np.cross(normal, np.array([0.0, 0.0, 1.0])))
        t2 = np.cross(normal, t1)
        return foot, normal, t1, t2

    def _sample_object(self, rng, plane):
        """One upright box with its bottom face ON the plane → (kps3d [9,3],
        kps2d [9,2] portrait-normalized) or None if out of frame."""
        foot0, normal, t1, t2 = plane
        half = rng.uniform(0.10, 0.28, size=3)           # hx, hy, hz
        yaw = rng.uniform(-np.pi, np.pi)
        ax = np.cos(yaw) * t1 + np.sin(yaw) * t2         # box x-axis
        ay = normal                                      # box y-axis (up)
        az = np.cross(ax, ay)                            # box z-axis
        rot = np.stack([ax, ay, az], axis=1)             # columns = axes
        foot = foot0 + t1 * rng.uniform(-1.0, 1.0) + t2 * rng.uniform(-0.6, 0.6)
        center = foot + normal * half[1]                 # bottom face on plane
        verts = center + (_CORNER_SIGNS * half) @ rot.T
        kps3d = np.concatenate([center[None], verts], axis=0)
        if np.any(kps3d[:, 2] >= -0.2):
            return None
        kps2d = _pinhole(kps3d)[:, ::-1].copy()          # (s_y, s_x): portrait
        if np.any(kps2d < 0.04) or np.any(kps2d > 0.96):
            return None
        extent = kps2d.max(0) - kps2d.min(0)
        if min(extent) < 0.12 or max(extent) > 0.85:     # detectable scale
            return None
        return kps3d, kps2d

    def sample(self, idx):
        """→ dict(img [H,W,3] BGR u8, kps2d [N,9,2] normalized,
        kps3d [N,9,3], labels [N] regressor-order, plane (center, normal))."""
        if self.cache_dir:
            if not _HAS_CV2:
                raise cv2_missing('the scene cache (PNG frames)')
            cached = self._cache_load(idx)
            if cached is not None:
                return cached
        out = self._render_sample(idx)
        if self.cache_dir:
            self._cache_store(idx, out)
        return out

    def _cache_path(self, idx):
        h, w = self.frame_hw
        # every generation parameter is in the key: an entry of a
        # differently configured generator is never served
        cfg = (self._CACHE_VERSION, self.seed, self.frame_hw,
               self.min_objects, self.max_objects, self.classes,
               self.clutter)
        tag = hashlib.sha1(repr(cfg).encode()).hexdigest()[:10]
        return osp.join(self.cache_dir,
                        f's{self.seed}_{h}x{w}_{tag}_{idx}.npz')

    def _cache_load(self, idx):
        path = self._cache_path(idx)
        if not osp.exists(path):
            return None
        try:
            z = np.load(path)
            img = cv.imdecode(z['png'], cv.IMREAD_COLOR)
            if img is None:     # corrupt payload: render again
                return None
            return dict(img=img, kps2d=z['kps2d'], kps3d=z['kps3d'],
                        labels=z['labels'],
                        plane=(z['plane_c'], z['plane_n']))
        except (OSError, ValueError, KeyError, EOFError):
            return None         # a truncated write of a dead process

    def _cache_store(self, idx, s):
        ok, enc = cv.imencode('.png', s['img'],
                              [cv.IMWRITE_PNG_COMPRESSION, 1])
        if not ok:
            return
        path = self._cache_path(idx)
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix='.tmp')
        with os.fdopen(fd, 'wb') as f:
            np.savez(f, png=enc, kps2d=s['kps2d'], kps3d=s['kps3d'],
                     labels=s['labels'], plane_c=s['plane'][0],
                     plane_n=s['plane'][1])
        os.replace(tmp, path)   # atomic: loader threads never see partials

    def _render_sample(self, idx):
        rng = np.random.RandomState(self.seed * 700001 + idx)
        h, w = self.frame_hw
        img = rng.randint(0, 56, size=(h, w, 3)).astype(np.uint8)
        plane = self._sample_plane(rng)
        objs = []
        n_target = rng.randint(self.min_objects, self.max_objects + 1)
        for attempt in range(400):
            if len(objs) == n_target:
                break
            if not objs and attempt and attempt % 40 == 0:
                plane = self._sample_plane(rng)   # unlucky plane: resample
            got = self._sample_object(rng, plane)
            if got is not None:
                objs.append(got)
        if not objs:
            raise RuntimeError('SyntheticScene: no placeable object in 400 '
                               'attempts — acceptance region is empty')
        labels = [int(self.classes[rng.randint(0, len(self.classes))])
                  for _ in objs]
        if _HAS_CV2:
            self._render(rng, img, objs, labels, plane)
        kps3d = np.stack([o[0] for o in objs]).astype(np.float32)
        kps2d = np.stack([o[1] for o in objs]).astype(np.float32)
        return dict(img=img, kps2d=kps2d, kps3d=kps3d,
                    labels=np.asarray(labels, np.int32),
                    plane=(plane[0].astype(np.float32),
                           plane[1].astype(np.float32)))

    def _render(self, rng, img, objs, labels, plane):
        h, w = self.frame_hw
        # ground quad for context
        foot, normal, t1, t2 = plane
        quad3d = np.stack([foot + t1 * sx * 1.6 + t2 * sz * 1.2
                           for sx, sz in ((-1, -1), (-1, 1), (1, 1), (1, -1))])
        if np.all(quad3d[:, 2] < -0.05):
            q2d = _pinhole(quad3d)
            qpx = np.clip((q2d[:, ::-1] * [w, h]), -4 * w, 4 * w).astype(int)
            cv.fillConvexPoly(img, qpx.reshape(-1, 1, 2), (70, 75, 70))
        if self.clutter:
            for _ in range(rng.randint(2, 6)):
                c = int(rng.randint(90, 150))
                cv.circle(img, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                          int(rng.randint(6, 28)), (c, c, c), -1)
        # painter's order: farther objects first
        order = np.argsort([o[0][0, 2] for o in objs])
        thickness = max(int(round(min(h, w) / 160)), 2)
        for i in order:
            draw_box(img, objs[i][1] * np.asarray([w, h]), labels[i],
                     thickness)


class SceneDetection:
    """Detector items over SyntheticScene: (img, boxes, labels, valid) with
    boxes the 2D keypoint extents in input-size pixels, labels in the
    detector's class order."""

    def __init__(self, scene, input_size=300, max_boxes=MAX_BOXES):
        self.scene = scene
        self.input_size = input_size
        self.max_boxes = max_boxes

    def __len__(self):
        return len(self.scene)

    def __getitem__(self, idx):
        s = self.scene.sample(idx)
        size = self.input_size
        img = cv.resize(s['img'], (size, size),
                        interpolation=cv.INTER_LINEAR) if _HAS_CV2 \
            else np.zeros((size, size, 3), np.uint8)
        lo = s['kps2d'].min(axis=1) * size                # [N, 2]
        hi = s['kps2d'].max(axis=1) * size
        boxes = np.concatenate([lo, hi], axis=1).astype(np.float32)
        labels = np.asarray([REGRESSOR_TO_DETECTOR_CLS[int(l)]
                             for l in s['labels']], np.int32)
        return (img,) + _pad_boxes(boxes, labels, self.max_boxes)


class SceneCrops:
    """Regressor items over SyntheticScene: one object per index, GT-box
    ±10 px crop → resize, keypoints in resized-crop pixels.  Train/val
    items are (crop, kps, cat); test items add the original frame and the
    crop coordinates.  Train mode jitters the crop margins
    (``jitter_margins``), per epoch.

    With ``det_boxes`` (an npz of ``data/selflabel.py``) a train item
    crops, with probability ``selflabel_p`` drawn per (seed, index,
    epoch), from the trained detector's box matched to the object plus
    ``selflabel_margin`` on every side, clipped to the frame: the engine's
    deploy geometry.  A box that leaves less than 8 px a side falls back
    to the ground-truth crop, and the keypoints are clipped into a crop
    that truncates the object."""

    def __init__(self, scene, resize=(224, 224), objects_per_scene=2,
                 mode='train', det_boxes='', selflabel_p=0.5,
                 selflabel_margin=10.0):
        self.scene = scene
        self.resize = tuple(resize)
        self.objects_per_scene = objects_per_scene
        self.mode = mode
        self._epoch = 0
        self.selflabel_p = float(selflabel_p)
        self.selflabel_margin = float(selflabel_margin)
        self._det_boxes = self._det_valid = None
        if det_boxes and mode == 'train':
            from .selflabel import load_selflabel_boxes
            self._det_boxes, self._det_valid = \
                load_selflabel_boxes(det_boxes, scene)

    def set_epoch(self, epoch):
        """Called by BatchLoader per epoch: varies the train-mode crop
        jitter and the self-label draws deterministically."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.scene) * self.objects_per_scene

    def _det_box(self, idx, k):
        """The matched detector box of object k, drawn with probability
        ``selflabel_p``, or None."""
        if self.mode != 'train' or self._det_boxes is None:
            return None
        scene_idx = idx // self.objects_per_scene
        if not self._det_valid[scene_idx, k]:
            return None
        draw = np.random.RandomState(
            (self.scene.seed * 99991 + idx * 31
             + self._epoch * 7919) & 0x7fffffff).uniform()
        return self._det_boxes[scene_idx, k] if draw < self.selflabel_p \
            else None

    def __getitem__(self, idx):
        if not _HAS_CV2:
            raise cv2_missing('SceneCrops (resizing the crops)')
        s = self.scene.sample(idx // self.objects_per_scene)
        n = len(s['labels'])
        k = (idx % self.objects_per_scene) % n
        h, w = s['img'].shape[:2]
        kps_px = s['kps2d'][k] * np.asarray([w, h], np.float32)
        # Objectron.crop semantics: clip to [3, dim-3], extent ±10 px
        clipped = np.stack([np.clip(kps_px[:, 0], 3, w - 3),
                            np.clip(kps_px[:, 1], 3, h - 3)],
                           axis=1).astype(np.float32)
        det_box = self._det_box(idx, k)
        if det_box is not None:
            # the engine's deploy geometry: the box and the margin on
            # every side, clipped to the frame
            m = self.selflabel_margin
            x0 = int(np.clip(det_box[0] - m, 0, w))
            y0 = int(np.clip(det_box[1] - m, 0, h))
            x1 = int(np.clip(det_box[2] + m, 0, w))
            y1 = int(np.clip(det_box[3] + m, 0, h))
            if x1 - x0 < 8 or y1 - y0 < 8:   # degenerate box: GT fallback
                det_box = None
        if det_box is None:
            if self.mode == 'train':
                ml, mt, mr, mb = jitter_margins(self.scene.seed, idx,
                                                self._epoch)
            else:
                ml = mt = mr = mb = 10.0
            x0 = int(np.clip(clipped[:, 0].min() - ml, 0, w))
            y0 = int(np.clip(clipped[:, 1].min() - mt, 0, h))
            x1 = int(np.clip(clipped[:, 0].max() + mr, 0, w))
            y1 = int(np.clip(clipped[:, 1].max() + mb, 0, h))
        crop_img = s['img'][y0:y1, x0:x1]
        crop_kps = clipped - np.asarray([x0, y0], np.float32)
        if det_box is not None:
            # a detector box may truncate the object: keypoints clipped
            # into the crop, the best a deployed regressor can predict
            crop_kps = np.stack(
                [np.clip(crop_kps[:, 0], 0, x1 - x0),
                 np.clip(crop_kps[:, 1], 0, y1 - y0)], axis=1)
        th, tw = self.resize
        ch, cw = crop_img.shape[:2]
        resized = cv.resize(crop_img, (tw, th), interpolation=cv.INTER_LINEAR)
        out_kps = crop_kps * np.asarray([tw / cw, th / ch], np.float32)
        if self.mode == 'test':
            return (s['img'], resized, out_kps, int(s['labels'][k]),
                    (x0, y0, x1, y1))
        return resized, out_kps, int(s['labels'][k])


# --- tf.train.Example wire format (the feature keys the protocol CLI reads)

def _varint(v):
    out = b''
    while True:
        b7 = v & 0x7f
        v >>= 7
        out += bytes([b7 | (0x80 if v else 0)])
        if not v:
            return out


def _feat_bytes(vals):
    body = b''.join(_varint(1 << 3 | 2) + _varint(len(v)) + v for v in vals)
    return _varint(1 << 3 | 2) + _varint(len(body)) + body


def _feat_floats(vals):
    packed = b''.join(struct.pack('<f', float(v)) for v in vals)
    body = _varint(1 << 3 | 2) + _varint(len(packed)) + packed
    return _varint(2 << 3 | 2) + _varint(len(body)) + body


def _feat_ints(vals):
    body = b''.join(_varint(1 << 3 | 0) + _varint(int(v)) for v in vals)
    return _varint(3 << 3 | 2) + _varint(len(body)) + body


def _example(features):
    body = b''
    for name, feat in features.items():
        entry = _varint(1 << 3 | 2) + _varint(len(name)) + name.encode()
        entry += _varint(2 << 3 | 2) + _varint(len(feat)) + feat
        body += _varint(1 << 3 | 2) + _varint(len(entry)) + entry
    return _varint(1 << 3 | 2) + _varint(len(body)) + body


def write_eval_shards(out_dir, classes, per_class=32, frame_hw=(480, 640),
                      seed=51, min_objects=1, max_objects=3):
    """Write per-class TFRecord shards (``<out_dir>/<class>/shard-00000``)
    with the feature keys and types the protocol CLI reads (image/encoded,
    point_2d, point_3d, instance_num, object/visibility, plane/*), framed
    with masked CRC32C checksums as ``tf.data.TFRecordDataset`` expects.
    Byte for byte the JAX package's shards."""
    if not _HAS_CV2:
        raise cv2_missing('write_eval_shards (JPEG frames)')
    for ci, cls in enumerate(classes):
        cls_id = OBJECTRON_CLASSES.index(cls)
        scene = SyntheticScene(length=per_class, frame_hw=frame_hw,
                               seed=seed + 131 * ci, classes=(cls_id,),
                               min_objects=min_objects,
                               max_objects=max_objects)
        cls_dir = osp.join(out_dir, cls)
        os.makedirs(cls_dir, exist_ok=True)
        with open(osp.join(cls_dir, 'shard-00000'), 'wb') as f:
            for i in range(per_class):
                s = scene.sample(i)
                ok, enc = cv.imencode('.jpg', s['img'],
                                      [cv.IMWRITE_JPEG_QUALITY, 95])
                if not ok:
                    raise RuntimeError(f'JPEG encoding failed: {cls} {i}')
                n = len(s['labels'])
                # point_2d rows are (x, y, depth) triplets in the Objectron
                # schema; depth is unused by the protocol readers
                p2 = np.concatenate(
                    [s['kps2d'], np.zeros((n, 9, 1), np.float32)], axis=-1)
                ex = _example({
                    'image/encoded': _feat_bytes([enc.tobytes()]),
                    'point_2d': _feat_floats(p2.reshape(-1).tolist()),
                    'point_3d': _feat_floats(
                        s['kps3d'].reshape(-1).tolist()),
                    'instance_num': _feat_ints([n]),
                    'object/visibility': _feat_floats([1.0] * n),
                    'plane/center': _feat_floats(s['plane'][0].tolist()),
                    'plane/normal': _feat_floats(s['plane'][1].tolist()),
                })
                f.write(tfrecord_frame(ex))
