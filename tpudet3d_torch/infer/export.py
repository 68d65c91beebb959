"""Export of the regressor as a deployment artifact (counterpart of
``tpudet3d/infer/export.py``).

The exported program takes raw BGR uint8 crops ``[B,h,w,3]``, reverses
the channels, normalises them as ``(x - mean·255) / (std·255)`` in float32
and returns the regressor's export-mode outputs: sigmoid keypoints of all
heads ``[9,B,9,2]`` and class logits ``[B,C]``.  It is written with
``torch.export`` (``model.pt2``) beside a readable dump of its graph
(``model.graph.txt``), in place of the JAX package's ``jax.export``
artifact and StableHLO text.  It runs in the model's own dtype on the
device where its weights are; no kernel wrapper lies inside it (K2 and
K4 belong to the engine).
"""

import os.path as osp

import torch
from torch import nn

from ..core import mkdir_if_missing
from .engine import REG_MEAN, REG_STD

__all__ = ['ExportFn', 'make_export_fn', 'export_regressor', 'load_exported']


class ExportFn(nn.Module):
    """The deployment function: raw uint8 crops → ``(kp, logits)``."""

    def __init__(self, model, bgr_input=True):
        super().__init__()
        self.model = model
        self.bgr_input = bgr_input
        self.register_buffer('mean', torch.tensor(REG_MEAN) * 255)
        self.register_buffer('std', torch.tensor(REG_STD) * 255)

    def forward(self, raw_u8):
        x = raw_u8.float()
        if self.bgr_input:
            x = x.flip(-1)
        return self.model((x - self.mean) / self.std)


def make_export_fn(model, img_size=(128, 128), bgr_input=True):
    """The deployment function of ``model`` (a ``MultiHeadRegressor``) on
    the device of its weights.  ``img_size`` is kept for the JAX
    signature: the function takes any crop size."""
    device = next(model.parameters()).device
    return ExportFn(model.eval(), bgr_input).to(device).eval()


def export_regressor(model, save_path, img_size=(128, 128), batch_size=1):
    """Write ``<save_path>/model.pt2`` (the exported program for uint8
    input ``[batch_size, *img_size, 3]``) and ``<save_path>/model.graph.txt``
    (its readable graph); returns the ``ExportedProgram``."""
    mkdir_if_missing(save_path)
    fn = make_export_fn(model, img_size)
    example = torch.zeros((batch_size, *img_size, 3), dtype=torch.uint8,
                          device=fn.mean.device)
    with torch.no_grad():
        exported = torch.export.export(fn, (example,))
    path = osp.join(save_path, 'model.pt2')
    torch.export.save(exported, path)
    with open(osp.join(save_path, 'model.graph.txt'), 'w') as f:
        f.write(str(exported))
    print(f'exported deployment artifact to {save_path} '
          f'({osp.getsize(path)} bytes serialized, input uint8 {batch_size}x'
          f'{img_size[0]}x{img_size[1]}x3 BGR)')
    return exported


def load_exported(save_path):
    """Rehydrate ``<save_path>/model.pt2``; returns a callable."""
    return torch.export.load(osp.join(save_path, 'model.pt2')).module()
