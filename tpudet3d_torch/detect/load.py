"""Checkpoint-driven detector construction (counterpart of
``tpudet3d/detect/load.py``).

The snapshot carries the architecture: a cascade snapshot holds
``reg2_heads_*`` weights, and the stem conv's output channels give the
width, so callers never pass an architecture flag.
"""

import torch

from ..core.device import resolve_device
from ..utils.checkpoint import load_converted, resolve_converted
from ..utils.convert import load_state_dict_strict
from .ssd import SSDDetector

__all__ = ['load_detector']


def load_detector(path, dtype=torch.bfloat16, num_classes=9,
                  width_mult=None, device=None):
    """A converted detector snapshot (or the orbax ``snap_N`` directory
    beside it) → ``SSDDetector`` in eval mode on ``device`` (the card
    unless ``'cpu'``).

    Serves the EMA average when the snapshot has one, else the raw
    weights.  The model is a cascade exactly when ``reg2_heads_0.*`` keys
    are present, and when ``width_mult`` is None it takes the snapshot's
    width (the MNv2 stem has 32·width channels).  The load is strict: a key
    unmatched on either side, or a shape mismatch, raises."""
    device = resolve_device(device)
    path = resolve_converted(path)
    snap = load_converted(path, kind='detector')
    sd = snap['ema_params'] or snap['params']
    cascade = any(k.startswith('reg2_heads_0.') for k in sd)
    if width_mult is None:
        width_mult = sd['backbone.ConvBN_0.Conv_0.weight'].shape[0] / 32.0
    model = SSDDetector(num_classes=num_classes, width_mult=width_mult,
                        dtype=dtype, cascade=cascade)
    try:
        load_state_dict_strict(model, sd)
    except (KeyError, ValueError) as e:
        raise ValueError(
            f'detector snapshot {path} does not match SSDDetector('
            f'width_mult={width_mult}, cascade={cascade}): {e}') from e
    return model.to(device).eval()
