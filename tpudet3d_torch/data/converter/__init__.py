"""Objectron → COCO host ETL (counterpart of ``tpudet3d/data/converter``)."""

from .helpers import get_frame_annotation, grab_frames, load_annotation_sequence
from .objectron_to_coco import convert, keypoints_to_bbox, load_video_info
from .proto import decode_message, parse_sequence

__all__ = ['parse_sequence', 'decode_message', 'load_annotation_sequence',
           'get_frame_annotation', 'grab_frames', 'convert',
           'load_video_info', 'keypoints_to_bbox']
