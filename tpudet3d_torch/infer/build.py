"""Build the serving engine (counterpart of ``scripts/demo.py``
``build_engine``).

Without a config: MNv2-SSD-300 (width 1.0) and the MNv3-large-21k
multi-head regressor, both bf16.  ``reg_config_path`` names the regressor
(``model.name``, ``data.resize`` for the crop size).  Weights come from
converted snapshots (``utils/checkpoint.py``; ``scripts/snapshot_to_torch.py``
writes them): ``det_checkpoint`` through ``detect/load.py``, and
``reg_checkpoint`` or else the newest snapshot under the config's
``output_dir``.  A part without a snapshot gets random weights from a
seeded ``torch.Generator``.
"""

import torch

from ..core.config import AttrDict, read_py_config
from ..core.device import resolve_device
from ..detect.load import load_detector
from ..detect.ssd import SSDDetector
from ..models.builder import build_model
from ..models.layers import init_weights
from ..utils.checkpoint import (latest_snapshot, load_converted,
                                resolve_converted)
from ..utils.convert import load_state_dict_strict
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


def regressor_weights(snap, cfg):
    """The state_dict to serve from a converted regressor snapshot under
    ``cfg``: the JAX demo's ``resume_from`` + ``eval_params``.  A config
    with ``optim.ema_decay > 0`` serves the snapshot's EMA, or its raw
    weights when it has none (JAX seeds the average from them); a config
    without EMA serves the raw weights.  Either set carries the snapshot's
    batch statistics."""
    optim = cfg.get('optim') or {}
    ema_on = float(optim.get('ema_decay', 0.0) or 0.0) > 0
    if ema_on and snap['ema_params'] is not None:
        return snap['ema_params']
    return snap['params']


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
    generator = torch.Generator().manual_seed(seed)
    if det_checkpoint:
        detector = load_detector(det_checkpoint, dtype=torch.bfloat16,
                                 device='cpu')
    else:
        detector = build_detector(generator=generator)
    regressor = build_model(cfg, generator=generator)
    reg_snap = reg_checkpoint or (latest_snapshot(cfg.output_dir)
                                  if cfg.get('output_dir') else None)
    if reg_snap:
        path = resolve_converted(reg_snap)
        try:
            load_state_dict_strict(regressor, regressor_weights(
                load_converted(path, kind='regressor'), cfg))
        except (KeyError, ValueError) as e:
            raise ValueError(f'regressor snapshot {path} does not match '
                             f'{cfg.model.name}: {e}') from e
        print(f'loaded regressor weights from {path}')
    # crop at the regressor's trained input size (configs may set 288², say)
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
