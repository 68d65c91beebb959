"""Offline ETL: Objectron videos and ``.pbdata`` annotations → COCO JSON
and JPEGs (a copy of ``tpudet3d/data/converter/objectron_to_coco.py``).

As the reference converter: every ``fps_divisor``-th frame is extracted
and downscaled by ``res_divisor``, the 2D box is the keypoints' extent,
boxes are clipped only for ``clip_classes`` and unclipped boxes out of the
frame are dropped.  COCO ``category_id`` is 1-based.
"""

import json
import os
import os.path as osp

import numpy as np

from ...core import OBJECTRON_CLASSES
from .helpers import load_annotation_sequence, grab_frames

try:
    import cv2 as cv
except ImportError:  # pragma: no cover
    cv = None

__all__ = ['convert', 'load_video_info', 'keypoints_to_bbox',
           'OBJECTRON_NUM_KPS']

OBJECTRON_NUM_KPS = 9


def load_video_info(data_root, index_root, subset, classes):
    """Read the per-class index lists → [(video_path, annotation), ...]."""
    videos_info = []
    total_len = 0
    for cl in classes:
        index_file = osp.join(index_root, f'{cl}_annotations_{subset}')
        with open(index_file) as f:
            for line in f:
                rel = line.strip()
                if not rel:
                    continue
                ann_path = osp.join(data_root, 'annotation', rel + '.pbdata')
                ann = load_annotation_sequence(ann_path)
                for item in ann:
                    item[1] = cl   # index list class wins over proto category
                total_len += len(ann)
                vid_path = osp.join(data_root, 'videos', rel, 'video.MOV')
                videos_info.append((vid_path, ann))
    avg = total_len / max(len(videos_info), 1)
    return videos_info, avg


def unnormalize_keypoints(kp2d_flat, counts, size):
    """Flat normalized (x, y, depth) keypoints → per-object [9,2] int pixel
    arrays."""
    w, h = size
    splits = np.cumsum(counts)[:-1]
    per_obj = np.split(np.asarray(kp2d_flat, np.float32).reshape(-1, 3),
                       splits)
    out = []
    for kp in per_obj:
        pix = (kp[:, :2] * np.asarray([w, h], np.float32)).astype(int)
        assert len(pix) == OBJECTRON_NUM_KPS
        out.append(pix)
    return out


def keypoints_to_bbox(kp_px, size, clip=False):
    """9 keypoints → xywh box; None when out of frame and not clipped."""
    w, h = size
    x0, y0 = kp_px[:, 0].min(), kp_px[:, 1].min()
    x1, y1 = kp_px[:, 0].max(), kp_px[:, 1].max()
    if clip:
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(w - 1, x1), min(h - 1, y1)
    if x0 < 0 or y0 < 0 or x1 >= w or y1 >= h or (x1 - x0) * (y1 - y0) == 0:
        return None
    return [int(x0), int(y0), int(x1 - x0), int(y1 - y0)]


def convert(data_root, output_root, subset_name, obj_classes=OBJECTRON_CLASSES,
            index_root=None, fps_divisor=1, res_divisor=1, dump_images=True,
            clip_classes=('shoe', 'bike'), limit_videos=0):
    """Run the conversion; writes annotations/objectron_{subset}.json and
    images/*.jpg under output_root."""
    assert cv is not None, 'cv2 required for conversion'
    index_root = index_root or osp.join(data_root, 'index')
    ann_dir = osp.join(output_root, 'annotations')
    img_dir = osp.join(output_root, 'images')
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    videos_info, avg_len = load_video_info(data_root, index_root, subset_name,
                                           obj_classes)
    if limit_videos:
        videos_info = videos_info[:limit_videos]
    print(f'{len(videos_info)} videos, avg length {avg_len:.1f}')

    categories = [{'id': i + 1, 'name': c} for i, c in enumerate(obj_classes)]
    class_to_id = {c: i + 1 for i, c in enumerate(obj_classes)}
    images, annotations = [], []
    img_id = ann_id = 0
    stats = {'frames': 0, 'boxes': 0}

    for vid_idx, (vid_path, annotation) in enumerate(videos_info):
        req = [i for i in range(len(annotation)) if i % fps_divisor == 0]
        frames = grab_frames(vid_path, req)
        for frame_idx, frame_ann in enumerate(annotation):
            frame = frames.get(frame_idx)
            if frame is None:
                continue
            kp2d_flat, category, counts, _camera = frame_ann
            h, w = frame.shape[:2]
            if res_divisor > 1:
                frame = cv.resize(frame, (w // res_divisor, h // res_divisor))
                h, w = frame.shape[:2]
            try:
                objects_kp = unnormalize_keypoints(kp2d_flat, counts, (w, h))
            except AssertionError:
                continue
            clip = category in clip_classes
            boxes = [keypoints_to_bbox(kp, (w, h), clip) for kp in objects_kp]
            if not any(b is not None for b in boxes):
                continue
            file_name = f'images/{category}_{vid_idx}_{frame_idx}.jpg'
            if dump_images:
                cv.imwrite(osp.join(output_root, file_name), frame)
            images.append({'id': img_id, 'file_name': file_name,
                           'width': w, 'height': h})
            for kp, box in zip(objects_kp, boxes):
                if box is None:
                    continue
                annotations.append({
                    'id': ann_id, 'image_id': img_id,
                    'category_id': class_to_id[category],
                    'bbox': box, 'area': box[2] * box[3], 'iscrowd': 0,
                    'keypoints': kp.reshape(-1).tolist(),
                    'num_keypoints': OBJECTRON_NUM_KPS,
                })
                ann_id += 1
                stats['boxes'] += 1
            img_id += 1
            stats['frames'] += 1

    out = {'images': images, 'annotations': annotations,
           'categories': categories}
    json_path = osp.join(ann_dir, f'objectron_{subset_name}.json')
    with open(json_path, 'w') as f:
        json.dump(out, f)
    print(f'wrote {json_path}: {stats}')
    return json_path
