"""Build the default serving engine (counterpart of ``scripts/demo.py``
``build_engine``): MNv2-SSD-300 (width 1.0) and the MNv3-large-21k
multi-head regressor, both bf16, with random weights from a seeded
``torch.Generator``.

Trained weights reach the port as a ``state_dict`` through
``utils/convert.py``.  Loading a JAX (orbax) snapshot directly waits for
the offline conversion tool (ROADMAP.md, Queue 1), so the checkpoint
arguments raise.
"""

import os
import re

import torch

from ..core.config import AttrDict, read_py_config
from ..core.device import resolve_device
from ..detect.ssd import SSDDetector
from ..models.builder import build_model
from ..models.layers import init_weights
from .engine import EngineConfig, TwoStageEngine

__all__ = ['build_engine', 'build_detector']


def build_detector(width_mult=1.0, dtype=torch.bfloat16, cascade=False,
                   generator=None):
    """SSDDetector with seeded random weights (default seed 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    det = SSDDetector(num_classes=9, width_mult=width_mult, dtype=dtype,
                      cascade=cascade)
    return init_weights(det, generator).eval()


def _has_snapshot(output_dir):
    return bool(output_dir) and os.path.isdir(output_dir) and any(
        re.match(r'snap_\d+$', d) for d in os.listdir(output_dir))


def build_engine(reg_config_path='', det_checkpoint='', reg_checkpoint='',
                 det_conf=0.7, max_detections=8, host_downscale=1,
                 crop_margin_px=10.0, refine_passes=0, refine_margin_px=10.0,
                 score_thr=0.02, soft_nms_sigma=0.0, soft_nms_dup_iou=0.75,
                 box_vote_iou=0.0, tta_flip=False, device=None, seed=0):
    """The serving engine on ``device`` (the card unless ``'cpu'``)."""
    device = resolve_device(device)
    if reg_config_path:
        cfg = read_py_config(reg_config_path)
    else:
        cfg = AttrDict(model=dict(name='mobilenetv3_large_21k',
                                  pretrained=False, num_classes=9, bf16=True),
                       output_dir='')
    if det_checkpoint or reg_checkpoint or _has_snapshot(cfg.output_dir):
        raise NotImplementedError(
            'loading a JAX snapshot waits for the offline orbax → state_dict '
            'conversion tool (ROADMAP.md, Queue 1)')
    generator = torch.Generator().manual_seed(seed)
    detector = build_detector(generator=generator)
    regressor = build_model(cfg, generator=generator)
    crop_size = (tuple(cfg.data.resize) if cfg.get('data')
                 and cfg.data.get('resize') else (224, 224))
    return TwoStageEngine(detector, regressor,
                          EngineConfig(crop_size=crop_size,
                                       det_conf=det_conf,
                                       max_detections=max_detections,
                                       host_downscale=host_downscale,
                                       crop_margin_px=crop_margin_px,
                                       refine_passes=refine_passes,
                                       refine_margin_px=refine_margin_px,
                                       score_thr=score_thr,
                                       soft_nms_sigma=soft_nms_sigma,
                                       soft_nms_dup_iou=soft_nms_dup_iou,
                                       box_vote_iou=box_vote_iou,
                                       tta_flip=tta_flip),
                          device=device)
