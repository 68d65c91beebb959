"""Objectron sequence parsing and video frame grabbing for the host ETL (a
copy of ``tpudet3d/data/converter/helpers.py``), on the wire-format parser
of ``proto.py`` (no generated protobuf bindings needed).
"""

import subprocess

import numpy as np

from .proto import parse_sequence

try:
    import cv2 as cv
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

__all__ = ['load_annotation_sequence', 'get_frame_annotation', 'grab_frames']


def get_frame_annotation(sequence, frame_id):
    """Per-frame 2D/3D keypoints + categories + camera for one frame.

    Returns (keypoints_2d_flat [sum(kp_i), 3] (x, y, depth),
             categories, keypoint_counts, camera_dict).
    2D points are normalized image coordinates like the vendor helper.
    """
    frame = sequence['frame_annotations'][frame_id]
    kp2d, cats, counts = [], [], []
    objects = sequence.get('objects', [])
    for obj_ann in frame.get('annotations', []):
        oid = obj_ann.get('object_id', 0)
        category = (objects[oid].get('category', 'unknown')
                    if oid < len(objects) else 'unknown')
        pts = obj_ann.get('keypoints', [])
        for kp in pts:
            p2 = kp.get('point_2d', {})
            kp2d.append([p2.get('x', 0.0), p2.get('y', 0.0),
                         p2.get('depth', 1.0)])
        cats.append(category)
        counts.append(len(pts))
    return np.asarray(kp2d, np.float32), cats, counts, frame.get('camera', {})


def load_annotation_sequence(ann_path):
    """.pbdata file → list of per-frame entries
    [keypoints_2d, category, counts, camera] (reference helper :103-111)."""
    with open(ann_path, 'rb') as f:
        sequence = parse_sequence(f.read())
    entries = []
    for frame_id in range(len(sequence.get('frame_annotations', []))):
        kp2d, cats, counts, camera = get_frame_annotation(sequence, frame_id)
        category = cats[0] if cats else 'unknown'
        entries.append([kp2d, category, counts, camera])
    return entries


def grab_frames(video_path, frame_ids, use_ffmpeg=False):
    """Random-access frame grab: {frame_id: BGR ndarray or None}."""
    frames = {}
    if use_ffmpeg or not _HAS_CV2:
        return _grab_frames_ffmpeg(video_path, frame_ids)
    cap = cv.VideoCapture(video_path)
    try:
        for idx in sorted(frame_ids):
            cap.set(cv.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            frames[idx] = frame if ok else None
    finally:
        cap.release()
    return frames


def _grab_frames_ffmpeg(video_path, frame_ids):
    """Decode the needed frames with an ffmpeg rawvideo pipe (select filter)."""
    probe = subprocess.run(
        ['ffprobe', '-v', 'quiet', '-select_streams', 'v:0',
         '-show_entries', 'stream=width,height', '-of', 'csv=p=0', video_path],
        capture_output=True, text=True, check=True)
    w, h = map(int, probe.stdout.strip().split(',')[:2])
    select = '+'.join(f'eq(n\\,{i})' for i in sorted(frame_ids))
    proc = subprocess.run(
        ['ffmpeg', '-v', 'quiet', '-i', video_path,
         '-vf', f"select='{select}'", '-vsync', '0',
         '-f', 'rawvideo', '-pix_fmt', 'bgr24', 'pipe:'],
        capture_output=True, check=True)
    raw = np.frombuffer(proc.stdout, np.uint8)
    n = raw.size // (w * h * 3)
    imgs = raw[:n * w * h * 3].reshape(n, h, w, 3)
    out = {}
    for k, idx in enumerate(sorted(frame_ids)):
        out[idx] = imgs[k] if k < n else None
    return out
