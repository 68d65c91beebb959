"""Two-stage serving engine (counterpart of ``tpudet3d/infer/engine.py``).

One batched pass per call: preprocess (K1) → SSD forward → decode + NMS
(K3) → box scaling, expand, margin and clip → crop-resize-normalize (K2) →
multi-head regressor → head epilogue (K4: sigmoid, TTA average, argmax,
head select, then the next pass's boxes or the packed rows) → optional
refine passes → ``[N, max_det, 26]`` packed rows.  Every stage runs over
the whole batch: one detector forward over N frames, one K3 launch over N
images, and per regress pass one K2 launch over N·max_det boxes, one
regressor forward over every crop and one K4 launch.
All ``max_det`` rows are always processed (padded rows carry score 0), as
the JAX program's fixed shapes do, and nothing on the path waits for the
device until the caller reads the result.

With ``det_int8_scales`` / ``reg_int8_scales`` (``infer/quant.py``
``calibrate_engine``) the detector's and the regressor's forwards run under
``intercepting``: their calibrated dense ``ConvBN`` convs go through the int8
path (K6, ``torch._int_mm``, K7), as the JAX program's do.  PyTorch runs
eagerly, so the JAX engine's per-shape executable cache has no counterpart
yet (CUDA-graph capture is a later slice).

``shard(devices)`` serves ``infer_batch`` over several devices, as the
JAX engine's ``shard(mesh)`` does over a mesh: each listed device holds a
replica of both models (the engine's own modules on its own device, a
copy elsewhere; the int8 scales are keyed by module path, so they carry
over), and a call splits its frames into equal slices, runs each slice's
fused path on its device's own stream and gathers the packed rows in
order.  A device may be listed more than once (two replicas on one card
run concurrently on two streams).  Setting ``det_model`` or
``reg_model`` drops the replicas, as JAX's ``det_vars`` / ``reg_vars``
setters drop its compiled programs.
"""

import copy
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..detect.anchors import INPUT_SIZE, generate_anchors
from ..detect.nms import decode_detections
from ..ops.image import crop_and_resize, resize_bilinear
from .epilogue import head_epilogue, refine_boxes, tta_flip_average
from .quant import intercepting

__all__ = ['TwoStageEngine', 'EngineConfig', 'refine_boxes',
           'tta_flip_average', 'upload', 'REG_MEAN', 'REG_STD', 'REG_SCALE',
           'REG_OFFSET']

REG_MEAN = (0.5931, 0.4690, 0.4229)
REG_STD = (0.2471, 0.2214, 0.2157)


def _reg_norm():
    """The crop normalisation ``x*scale - offset`` of the JAX serving
    program, whose constants are bfloat16 (``engine.py:254-257``)."""
    inv_std = (1.0 / (np.asarray(REG_STD) * 255)).astype(np.float32)
    offset = np.asarray(REG_MEAN) * 255 * inv_std
    as_bf16 = lambda v: tuple(  # noqa: E731
        torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float()
        .tolist())
    return as_bf16(inv_std), as_bf16(offset)


REG_SCALE, REG_OFFSET = _reg_norm()


@dataclass
class EngineConfig:
    max_detections: int = 8
    det_conf: float = 0.6
    nms_iou: float = 0.45
    score_thr: float = 0.02
    # Gaussian soft-NMS sigma; 0 = hard greedy NMS
    soft_nms_sigma: float = 0.0
    # soft-NMS duplicate cutoff: overlaps above it are zeroed, not decayed
    soft_nms_dup_iou: float = 0.75
    # box voting threshold (Gidaris & Komodakis 2015); 0 = off
    box_vote_iou: float = 0.0
    crop_size: Tuple[int, int] = (224, 224)
    expand_ratio: Tuple[float, float] = (1.0, 1.0)
    # fixed pixel margin around the detector box before cropping
    crop_margin_px: float = 0.0
    # keypoint-refinement passes: re-crop around the predicted extent
    refine_passes: int = 0
    refine_margin_px: float = 10.0
    # horizontal-flip TTA for the regressor (one doubled batch)
    tta_flip: bool = False
    # a side whose keypoints press against the crop edge grows by this
    # fraction of the box side in the next pass
    refine_edge_grow: float = 0.2
    input_is_bgr: bool = True
    # int8 PTQ: calibrated input scales of each stage's convs
    # (infer/quant.py calibrate_engine); None or {} serves unquantized
    det_int8_scales: Optional[dict] = None
    reg_int8_scales: Optional[dict] = None
    # downscale frames on the host (cv2 INTER_AREA) before upload; boxes
    # are rescaled to source pixels on output
    host_downscale: int = 1


def upload(frames, device):
    """Host uint8 frames → a tensor on ``device``, through pinned memory
    and without waiting for the copy on the card."""
    t = torch.as_tensor(np.ascontiguousarray(frames))
    if device.type == 'cuda':
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _canonical(device):
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _unpack(rows, scale=1.0):
    return {
        'boxes': rows[:, 0:4] * scale,
        'scores': rows[:, 4],
        'det_labels': rows[:, 5].astype(np.int32),
        'kp': rows[:, 6:24].reshape(-1, 9, 2),
        'labels': rows[:, 24].astype(np.int32),
    }


class TwoStageEngine:
    """Batched detector → regressor engine.

    ``detector`` is an ``SSDDetector`` and ``regressor`` a
    ``MultiHeadRegressor``; both are moved to ``device`` (the card unless
    ``device='cpu'``) in ``channels_last`` and eval mode."""

    def __init__(self, detector, regressor,
                 config: Optional[EngineConfig] = None, device=None):
        self.cfg = config or EngineConfig()
        self.device = resolve_device(device)
        self._replicas = None     # [(engine, stream)] after shard()
        fmt = torch.channels_last
        self.det_model = detector.to(self.device, memory_format=fmt).eval()
        self.reg_model = regressor.to(self.device, memory_format=fmt).eval()
        self.anchors = torch.from_numpy(generate_anchors()).to(self.device)
        self._pending = []   # FIFO of in-flight results
        self._consts = {}

    @property
    def det_model(self):
        return self._det_model

    @det_model.setter
    def det_model(self, model):
        self._det_model = model
        self._replicas = None

    @property
    def reg_model(self):
        return self._reg_model

    @reg_model.setter
    def reg_model(self, model):
        self._reg_model = model
        self._replicas = None

    def _const(self, values):
        """A float32 device tensor for ``values``, made once."""
        key = tuple(float(v) for v in values)
        t = self._consts.get(key)
        if t is None:
            t = torch.tensor(key, dtype=torch.float32, device=self.device)
            self._consts[key] = t
        return t

    def decode_kwargs(self):
        """The K3 settings of this engine's configuration."""
        cfg = self.cfg
        return dict(score_thr=cfg.score_thr, iou_thr=cfg.nms_iou,
                    max_per_img=cfg.max_detections,
                    pre_nms_k=max(4 * cfg.max_detections, 32),
                    soft_nms_sigma=cfg.soft_nms_sigma,
                    soft_nms_dup_iou=cfg.soft_nms_dup_iou,
                    box_vote_iou=cfg.box_vote_iou)

    def _heads(self, frames, boxes):
        """Crops of boxes ``[N,M,4]`` through the regressor: the heads'
        pre-activations ``[B',9,18]`` and logits ``[B',C]``, B' = N·M (2·N·M
        with TTA: originals, then mirrors)."""
        cfg = self.cfg
        crops = crop_and_resize(frames, boxes.contiguous(), cfg.crop_size,
                                reverse_channels=cfg.input_is_bgr,
                                scale=REG_SCALE, offset=REG_OFFSET,
                                mirror=cfg.tta_flip,
                                dtype=self.reg_model.dtype)
        with intercepting(self.reg_model, cfg.reg_int8_scales):
            return self.reg_model(crops, pre_activation=True)

    @torch.no_grad()
    def _detect(self, frames, h, w, margin):
        """Stage 1 over the batch: ``(det_in, logits, deltas, dets, boxes)``
        with ``dets [N,max_det,6]`` from K3 in detector pixels and ``boxes
        [N,max_det,4]`` scaled, expanded, margined and clipped to the
        frame."""
        cfg = self.cfg
        det_in = resize_bilinear(frames, (INPUT_SIZE, INPUT_SIZE),
                                 reverse_channels=cfg.input_is_bgr,
                                 scale=1.0 / 255.0,
                                 dtype=self.det_model.dtype)
        with intercepting(self.det_model, cfg.det_int8_scales):
            logits, deltas = self.det_model(det_in)
        dets = decode_detections(logits.contiguous(), deltas.contiguous(),
                                 self.anchors, **self.decode_kwargs())
        return det_in, logits, deltas, dets, self._crop_boxes(dets, h, w,
                                                              margin)

    def _crop_boxes(self, dets, h, w, margin):
        """The first crop boxes ``[N,max_det,4]`` of K3's detections ``dets
        [N,max_det,6]`` (detector pixels): scaled to the frame, expanded,
        margined and clipped to it."""
        cfg = self.cfg
        s = INPUT_SIZE
        boxes = dets[..., :4] * self._const([w / s, h / s, w / s, h / s])
        if tuple(cfg.expand_ratio) != (1.0, 1.0):
            c = (boxes[..., :2] + boxes[..., 2:]) / 2
            wh = (boxes[..., 2:] - boxes[..., :2]) \
                * self._const(cfg.expand_ratio)
            boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
        if margin:
            m = float(np.float32(margin))
            boxes = boxes + self._const([-m, -m, m, m])
        return torch.minimum(boxes.clamp(min=0.0), self._const([w, h, w, h]))

    @torch.no_grad()
    def _pipeline_core(self, frames, h, w, margin, refine_margin):
        """frames ``[N,H,W,3]`` uint8 on the engine's device → packed
        ``[N, max_det, 26]`` float32 on the device."""
        _, _, _, dets, boxes = self._detect(frames, h, w, margin)
        return self._regress(frames, dets, boxes, h, w, refine_margin)

    @torch.no_grad()
    def _regress(self, frames, dets, boxes, h, w, refine_margin):
        """Stage 2 of the detections ``dets [N,max_det,6]`` cropped at
        ``boxes [N,max_det,4]``: the refine passes, then the packed
        ``[N, max_det, 26]``."""
        cfg = self.cfg
        n, md = boxes.shape[:2]
        tta_w = cfg.crop_size[1] if cfg.tta_flip else 0
        for _ in range(int(cfg.refine_passes)):
            pre, logits = self._heads(frames, boxes)
            boxes = head_epilogue(
                pre, logits, boxes.reshape(n * md, 4), tta_w,
                refine=(w, h, refine_margin, cfg.refine_edge_grow)) \
                .reshape(n, md, 4)
        pre, logits = self._heads(frames, boxes)
        return head_epilogue(pre, logits, boxes.reshape(n * md, 4), tta_w,
                             dets=dets.reshape(n * md, 6),
                             det_conf=cfg.det_conf).reshape(n, md, 26)

    def _pipeline(self, frame, h, w, margin=None, refine_margin=None):
        """frame ``[H,W,3]`` uint8 on the device → packed ``[max_det, 26]``."""
        if margin is None:
            margin = self.cfg.crop_margin_px
        if refine_margin is None:
            refine_margin = self.cfg.refine_margin_px
        return self._pipeline_core(frame[None], h, w, margin,
                                   refine_margin)[0]

    def _pipeline_batch(self, frames, h, w, margin=None):
        """frames ``[N,H,W,3]`` uint8 on the device → packed
        ``[N, max_det, 26]`` on the device (what ``bench.py`` times)."""
        if margin is None:
            margin = self.cfg.crop_margin_px
        return self._pipeline_core(frames, h, w, margin,
                                   self.cfg.refine_margin_px)

    def _upload(self, frames):
        return upload(frames, self.device)

    # --- multi-device serving ----------------------------------------------
    def shard(self, devices):
        """Serve every ``infer_batch`` call over ``devices`` (e.g.
        ``['cuda:0', 'cuda:1']``): one replica of the detector and the
        regressor on each, the frames split into equal slices in order."""
        devices = [_canonical(d) for d in devices]
        if not devices:
            raise ValueError('shard needs at least one device')
        own = _canonical(self.device)
        replicas = []
        for dev in devices:
            if dev.type == 'cuda' and not torch.cuda.is_available():
                raise RuntimeError(f'{dev} listed but CUDA is not available')
            rep = self if dev == own else self._replica(dev)
            stream = (torch.cuda.Stream(dev) if dev.type == 'cuda'
                      else None)
            replicas.append((rep, stream))
        if own.type == 'cuda':
            torch.cuda.synchronize(own)
        self._replicas = replicas
        return self

    def _replica(self, dev):
        """A shallow copy of the engine serving on ``dev`` with its own
        copies of the models and anchors."""
        rep = copy.copy(self)
        fmt = torch.channels_last
        rep.device = dev
        rep._det_model = copy.deepcopy(self.det_model).to(
            dev, memory_format=fmt)
        rep._reg_model = copy.deepcopy(self.reg_model).to(
            dev, memory_format=fmt)
        rep._replicas = None
        rep.anchors = self.anchors.to(dev)
        rep._pending = []
        rep._consts = {}
        return rep

    def _sharded_batch(self, frames, h, w):
        """frames ``[N,H,W,3]`` uint8 on the host → packed ``[N, max_det,
        26]`` on the host, one slice a replica."""
        k = len(self._replicas)
        n = frames.shape[0]
        if n % k:
            raise ValueError(f'sharded serving needs the batch to split '
                             f'evenly over the replicas: {n} % {k} != 0')
        m = n // k
        outs = []
        for i, (rep, stream) in enumerate(self._replicas):
            ctx = nullcontext() if stream is None else torch.cuda.stream(
                stream)
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(stream.device))
            with ctx:
                outs.append(rep._pipeline_batch(
                    rep._upload(frames[i * m:(i + 1) * m]), h, w))
        for (_, stream) in self._replicas:
            if stream is not None:
                stream.synchronize()
        return np.concatenate([o.cpu().numpy() for o in outs])

    # --- batched (server) API ---------------------------------------------
    def infer_batch(self, frames):
        """frames ``[N,H,W,3]`` uint8 → list of per-frame result dicts.
        After ``shard(devices)`` N must split evenly over the replicas."""
        n, h, w = frames.shape[:3]
        if self._replicas:
            packed = self._sharded_batch(np.asarray(frames), h, w)
        else:
            packed = self._pipeline_batch(self._upload(frames), h, w)
            packed = packed.cpu().numpy()
        return [_unpack(packed[i, np.nonzero(packed[i, :, 25] > 0)[0]])
                for i in range(n)]

    # --- synchronous API -------------------------------------------------
    def __call__(self, frame):
        """frame: HWC uint8 numpy → dict of numpy outputs for the confident
        detections."""
        self.run_async(frame)
        while len(self._pending) > 1:    # drop stale in-flight results
            self._pending.pop(0)
        return self.wait_and_grab()

    # --- async API ---------------------------------------------------------
    def run_async(self, frame):
        """Upload and enqueue one frame without waiting for the device;
        results are a FIFO read by :meth:`wait_and_grab`."""
        scale = 1.0
        d = int(self.cfg.host_downscale)
        if d > 1:
            import cv2 as cv
            h0, w0 = frame.shape[:2]
            frame = cv.resize(frame, (w0 // d, h0 // d),
                              interpolation=cv.INTER_AREA)
            scale = float(d)
        h, w = frame.shape[:2]
        # the crop margins stay fixed in SOURCE pixels under downscaling
        out = self._pipeline(self._upload(frame), h, w,
                             margin=self.cfg.crop_margin_px / max(d, 1),
                             refine_margin=self.cfg.refine_margin_px
                             / max(d, 1))
        self._pending.append((out, scale))

    def wait_and_grab(self):
        if not self._pending:
            raise RuntimeError('no async inference in flight')
        out, scale = self._pending.pop(0)
        packed = out.cpu().numpy()
        return _unpack(packed[np.nonzero(packed[:, 25] > 0)[0]], scale)

    def warmup(self, frame_shape=(720, 1280, 3)):
        self(np.zeros(frame_shape, np.uint8))
