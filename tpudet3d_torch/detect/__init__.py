from .anchors import (CLUSTERED_HEIGHTS, CLUSTERED_WIDTHS, INPUT_SIZE, STRIDES,
                      generate_anchors, num_anchors_per_level)
from .assigner import assign_anchors, iou_xyxy
from .coder import CASCADE_STDS, DEFAULT_STDS, decode_boxes, encode_boxes
from .nms import (decode_detections, decode_detections_plain, greedy_nms,
                  soft_nms)
from .eval import DetectorEvaluator, average_precision
from .load import load_detector
from .losses import giou_xyxy_paired, ssd_loss
from .ssd import SSDDetector

__all__ = ['CLUSTERED_HEIGHTS', 'CLUSTERED_WIDTHS', 'INPUT_SIZE', 'STRIDES',
           'generate_anchors', 'num_anchors_per_level', 'iou_xyxy',
           'assign_anchors', 'ssd_loss', 'giou_xyxy_paired',
           'DetectorEvaluator', 'average_precision',
           'CASCADE_STDS', 'DEFAULT_STDS', 'decode_boxes', 'encode_boxes',
           'decode_detections', 'decode_detections_plain', 'greedy_nms',
           'soft_nms', 'SSDDetector', 'load_detector']
