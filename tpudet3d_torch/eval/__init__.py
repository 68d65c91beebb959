"""Objectron-protocol evaluation, batched metrics and the training
``Evaluator`` (counterpart of ``tpudet3d/eval``)."""
from .evaluator import Evaluator
from .metrics import (add_sadd_per_sample, compute_2d_based_iou,
                      compute_accuracy, compute_average_distance,
                      compute_metrics_per_cls)
from .protocol import (AveragePrecision, HitMiss, ObjectronProtocolEvaluator,
                       parse_example, read_tfrecord)

__all__ = ['Evaluator', 'add_sadd_per_sample', 'compute_2d_based_iou', 'compute_accuracy',
           'compute_average_distance', 'compute_metrics_per_cls',
           'AveragePrecision', 'HitMiss', 'ObjectronProtocolEvaluator',
           'parse_example', 'read_tfrecord']
