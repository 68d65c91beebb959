"""Split-stage inference wrappers ``Detector`` and ``Regressor``
(counterpart of ``tpudet3d/infer/wrappers.py``).

``Detector`` maps one frame to thresholded detections: channel reversal and
resize to 300² with K1, the SSD, K3 at ``max_per_img=max_detections`` and
``pre_nms_k=4·max_detections``, then the boxes scaled to frame pixels;
``run_async`` / ``wait_and_grab`` keep one frame in flight.

``Regressor.get_detections(frame, detections)`` crops every detection of a
frame in one K2 launch (float32 crops, normalised as ``(x - mean) / std``
through ``x * (1/std) - mean/std``), runs the regressor over all of them in
one forward, and decodes each by its predicted class head with K4 (pack
mode).  The evaluation CLI's ``--gt_boxes`` diagnostic uses it.
"""

import numpy as np
import torch

from ..core.device import resolve_device
from ..detect.anchors import INPUT_SIZE, generate_anchors
from ..detect.nms import decode_detections
from ..ops.image import crop_and_resize, resize_bilinear
from .engine import REG_MEAN, REG_STD, upload
from .epilogue import head_epilogue

__all__ = ['Detector', 'Regressor']

_INV_STD = (1.0 / (np.asarray(REG_STD, np.float32) * 255)).astype(np.float32)
_SCALE = tuple(float(v) for v in _INV_STD)
_OFFSET = tuple(float(v) for v in (np.asarray(REG_MEAN, np.float32) * 255
                                   * _INV_STD).astype(np.float32))


class Detector:
    """Stage-1 wrapper: frame → ``[(left, top, right, bottom, conf, label),
    ...]`` above ``conf``.  ``model`` is an ``SSDDetector``; it runs on
    ``device`` (the card unless ``'cpu'``)."""

    def __init__(self, model, conf=.6, max_detections=32, input_is_bgr=True,
                 expand_ratio=(1., 1.), device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()
        self.confidence = conf
        self.max_detections = max_detections
        self.input_is_bgr = input_is_bgr
        self.expand_ratio = tuple(expand_ratio)
        self.anchors = torch.from_numpy(generate_anchors()).to(self.device)
        self._pending = None

    def decode_kwargs(self):
        """K3's arguments: ``max_detections`` rows kept of
        ``4·max_detections`` candidates."""
        return dict(max_per_img=self.max_detections,
                    pre_nms_k=4 * self.max_detections)

    @torch.no_grad()
    def _detect(self, frame):
        """frame ``[H,W,3]`` uint8 on the device → ``(det_in, logits,
        deltas, dets)``: the SSD's input from K1, its outputs, and K3's
        ``[1, max_detections, 6]`` in detector pixels."""
        s = INPUT_SIZE
        det_in = resize_bilinear(frame[None], (s, s),
                                 reverse_channels=self.input_is_bgr,
                                 scale=1.0 / 255.0, dtype=self.model.dtype)
        logits, deltas = self.model(det_in)
        dets = decode_detections(logits.contiguous(), deltas.contiguous(),
                                 self.anchors, **self.decode_kwargs())
        return det_in, logits, deltas, dets

    @staticmethod
    def _to_frame(dets, h, w):
        """K3's rows ``[M, 6]`` with their boxes scaled from detector pixels
        to an ``h × w`` frame's."""
        s = INPUT_SIZE
        scale = torch.tensor([w / s, h / s, w / s, h / s], device=dets.device)
        return torch.cat([dets[:, :4] * scale, dets[:, 4:]], dim=1)

    def _forward(self, frame):
        """frame ``[H,W,3]`` uint8 on the device → ``[max_detections, 6]``
        with boxes in frame pixels."""
        return self._to_frame(self._detect(frame)[3][0], *frame.shape[:2])

    def run_async(self, frame):
        """Dispatch one frame; :meth:`wait_and_grab` reads its result."""
        self.frame_shape = frame.shape
        self._pending = self._forward(upload(frame, self.device))

    def wait_and_grab(self):
        if self._pending is None:
            raise RuntimeError('no detection in flight')
        dets = self._pending.cpu().numpy()
        self._pending = None
        return self._decode(dets, self.frame_shape)

    def get_detections(self, frame):
        self.run_async(frame)
        return self.wait_and_grab()

    def _decode(self, dets, frame_shape):
        """Rows above the threshold, the expand ratio applied, clipped to
        the frame, in ints, sorted by the top edge, largest first."""
        out = []
        h, w = frame_shape[:2]
        for x0, y0, x1, y1, conf, label in dets:
            if conf <= self.confidence:
                continue
            if self.expand_ratio != (1., 1.):
                bw, bh = x1 - x0, y1 - y0
                dw = bw * (self.expand_ratio[0] - 1.) / 2
                dh = bh * (self.expand_ratio[1] - 1.) / 2
                x0, x1 = max(x0 - dw, 0), x1 + dw
                y0, y1 = max(y0 - dh, 0), y1 + dh
            out.append((int(max(x0, 0)), int(max(y0, 0)),
                        int(min(x1, w)), int(min(y1, h)),
                        float(conf), int(label)))
        out.sort(key=lambda d: d[1], reverse=True)
        return out


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
