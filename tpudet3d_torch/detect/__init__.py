from .anchors import (CLUSTERED_HEIGHTS, CLUSTERED_WIDTHS, INPUT_SIZE, STRIDES,
                      generate_anchors, num_anchors_per_level)
from .assigner import iou_xyxy
from .coder import CASCADE_STDS, DEFAULT_STDS, decode_boxes, encode_boxes
from .nms import (decode_detections, decode_detections_plain, greedy_nms,
                  soft_nms)
from .ssd import SSDDetector

__all__ = ['CLUSTERED_HEIGHTS', 'CLUSTERED_WIDTHS', 'INPUT_SIZE', 'STRIDES',
           'generate_anchors', 'num_anchors_per_level', 'iou_xyxy',
           'CASCADE_STDS', 'DEFAULT_STDS', 'decode_boxes', 'encode_boxes',
           'decode_detections', 'decode_detections_plain', 'greedy_nms',
           'soft_nms', 'SSDDetector']
