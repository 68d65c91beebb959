"""Objectron-protocol evaluation and batched metrics (counterpart of
``tpudet3d/eval``; the training ``Evaluator`` belongs to the training
slice)."""
from .metrics import (add_sadd_per_sample, compute_2d_based_iou,
                      compute_accuracy, compute_average_distance,
                      compute_metrics_per_cls)
from .protocol import (AveragePrecision, HitMiss, ObjectronProtocolEvaluator,
                       parse_example, read_tfrecord)

__all__ = ['add_sadd_per_sample', 'compute_2d_based_iou', 'compute_accuracy',
           'compute_average_distance', 'compute_metrics_per_cls',
           'AveragePrecision', 'HitMiss', 'ObjectronProtocolEvaluator',
           'parse_example', 'read_tfrecord']
