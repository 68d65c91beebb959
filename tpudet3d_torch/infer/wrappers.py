"""Split-stage inference wrapper ``Regressor`` (counterpart of
``tpudet3d/infer/wrappers.py:97-147``).

``Regressor.get_detections(frame, detections)`` crops every detection of a
frame in one K2 launch (float32 crops, normalised as ``(x - mean) / std``
through ``x * (1/std) - mean/std``), runs the regressor over all of them in
one forward, and decodes each by its predicted class head with K4 (pack
mode).  The evaluation CLI's ``--gt_boxes`` diagnostic uses it.  The
``Detector`` wrapper belongs to the split-inference slice.
"""

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.image import crop_and_resize
from .engine import REG_MEAN, REG_STD
from .epilogue import head_epilogue

__all__ = ['Regressor']

_INV_STD = (1.0 / (np.asarray(REG_STD, np.float32) * 255)).astype(np.float32)
_SCALE = tuple(float(v) for v in _INV_STD)
_OFFSET = tuple(float(v) for v in (np.asarray(REG_MEAN, np.float32) * 255
                                   * _INV_STD).astype(np.float32))


class Regressor:
    """Stage-2 wrapper: frame + detections → ``[(kp [9,2], label), ...]``.

    ``model`` is a ``MultiHeadRegressor``; it runs on ``device`` (the card
    unless ``'cpu'``)."""

    def __init__(self, model, crop_size=(224, 224), max_batch=16,
                 input_is_bgr=True, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.crop_size = tuple(crop_size)
        self.max_batch = max_batch
        self.input_is_bgr = input_is_bgr

    @torch.no_grad()
    def _forward(self, frame, boxes):
        crops = crop_and_resize(frame[None], boxes[None], self.crop_size,
                                reverse_channels=self.input_is_bgr,
                                scale=_SCALE, offset=_OFFSET,
                                dtype=torch.float32)
        pre, logits = self.model(crops, pre_activation=True)
        rows = head_epilogue(pre, logits, boxes,
                             dets=torch.zeros((boxes.shape[0], 6),
                                              device=boxes.device))
        return rows[:, 6:24].reshape(-1, 9, 2), rows[:, 24].long()

    def get_detections(self, frame, detections):
        """All detections of the frame in one forward (at most
        ``max_batch``)."""
        if not len(detections):
            return []
        n = len(detections)
        boxes = np.zeros((self.max_batch, 4), np.float32)
        for i, det in enumerate(detections[:self.max_batch]):
            boxes[i] = det[:4]
        frame_t = torch.as_tensor(np.ascontiguousarray(frame),
                                  device=self.device)
        kp, labels = self._forward(frame_t, torch.as_tensor(
            boxes, device=self.device))
        kp, labels = kp.cpu().numpy(), labels.cpu().numpy()
        return [(kp[i], int(labels[i])) for i in range(min(n, self.max_batch))]

    @staticmethod
    def transform_kp(kp, crop_cords):
        """[0,1] crop coords → frame pixels."""
        x0, y0, x1, y1 = crop_cords
        kp[:, 0] = kp[:, 0] * (x1 - x0) + x0
        kp[:, 1] = kp[:, 1] * (y1 - y0) + y0
        return kp
