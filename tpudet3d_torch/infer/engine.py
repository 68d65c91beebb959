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
path (K6, ``torch._int_mm``, K7), as the JAX program's do.

On an unsharded CUDA engine ``infer_batch`` replays a CUDA graph of the
whole path, from the uploaded frames to the packed rows: the counterpart
of the JAX engine's per-shape executable cache.  The first call of a key
(the frames' shape and dtype, ``h``, ``w``, the configuration by value,
int8 scales included, the versions of the weights served int8, and
cuDNN's and cuBLAS's algorithm switches) runs the path eagerly on a side
stream, which is its answer and lets the kernels, cuDNN and the int8
weight cache set up outside the capture, then captures it into a graph
with a static input and output; every later call of the key copies its
pinned frames into the static input and replays, one graph launch in
place of ~800 launches from Python.  The kernels in the graph are the
same hand-written K1–K4 (and K6/K7) launched by the same C entries on the
capturing stream; a replay calls no kernel wrapper, so the wrappers'
``launches`` count the eager path's launches (a capture's warm-up and
capture both) and a device trace counts a replay's.  At most
:data:`MAX_GRAPHS` graphs are kept, the oldest evicted first.  A CPU
engine, ``shard(...)``, ``__call__`` and ``run_async`` stay eager.
``graph_stats`` counts the captures, replays and eager calls of
``infer_batch``.

``shard(devices)`` serves ``infer_batch`` over several devices, as the
JAX engine's ``shard(mesh)`` does over a mesh: each listed device holds a
replica of both models (the engine's own modules on its own device, a
copy elsewhere; the int8 scales are keyed by module path, so they carry
over), and a call splits its frames into equal slices, runs each slice's
fused path on its device's own stream and gathers the packed rows in
order.  A device may be listed more than once (two replicas on one card
run concurrently on two streams).  Setting ``det_model`` or
``reg_model`` drops the replicas and the graphs, as JAX's ``det_vars`` /
``reg_vars`` setters drop its compiled programs; setting ``anchors``
drops the graphs.  ``cfg`` may be edited or assigned freely: the key
holds it by value.  A graph reads the models' parameters and buffers, the
anchors and the int8 weights where they lay at its capture: load new
weights in place (``load_state_dict``; a weight served int8 then has a new
version, so the next call captures again) or assign the model again.
"""

import copy
import dataclasses
from contextlib import nullcontext
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..detect.anchors import INPUT_SIZE, generate_anchors
from ..detect.nms import decode_detections
from ..ops.image import crop_and_resize, resize_bilinear
from ..utils.profiling import annotate
from .epilogue import head_epilogue, refine_boxes, tta_flip_average
from .quant import int8_versions, int8_weights, intercepting

__all__ = ['TwoStageEngine', 'EngineConfig', 'refine_boxes',
           'tta_flip_average', 'upload', 'MAX_GRAPHS', 'REG_MEAN', 'REG_STD',
           'REG_SCALE', 'REG_OFFSET']

MAX_GRAPHS = 16

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


def _host_frames(frames, device):
    """Host uint8 frames as a tensor, in pinned memory for a card."""
    t = torch.as_tensor(np.ascontiguousarray(frames))
    return t.pin_memory() if device.type == 'cuda' else t


def upload(frames, device):
    """Host uint8 frames → a tensor on ``device``, through pinned memory
    and without waiting for the copy on the card; the span
    ``tpudet3d_torch.serve.upload``."""
    with annotate('tpudet3d_torch.serve.upload'):
        return _host_frames(frames, device).to(device, non_blocking=True)


def warm_up(fn, device):
    """``fn()`` on a side stream of the card ``device``, after the work
    already queued on its current stream, which then waits for it."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


def capture_graph(fn, device):
    """``fn()`` captured into a CUDA graph on the card ``device``, after a
    warm-up: returns the graph and ``fn``'s output, which each
    ``graph.replay()`` writes again."""
    graph = torch.cuda.CUDAGraph()
    # thread_local: another thread's CUDA calls (a loader's, say) do not
    # fail this thread's capture
    with torch.cuda.device(device), torch.cuda.graph(
            graph, capture_error_mode='thread_local'):
        out = fn()
    return graph, out


class _Graph(NamedTuple):
    """A captured path: its static input and output, the graph, and the
    int8 weights it reads."""
    static_in: torch.Tensor
    graph: object
    static_out: torch.Tensor
    held: list


def _by_value(v):
    """A configuration field as a key: dicts and lists as tuples."""
    if isinstance(v, dict):
        return tuple(sorted(v.items()))
    return tuple(v) if isinstance(v, list) else v


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
        self.graph_stats = {'captures': 0, 'replays': 0, 'eager': 0}

    # a graph reads what these held at its capture: assigning one drops
    # the graphs (and the models' replicas)
    @property
    def det_model(self):
        return self._det_model

    @det_model.setter
    def det_model(self, model):
        self._det_model = model
        self._replicas = None
        self._graphs = {}

    @property
    def reg_model(self):
        return self._reg_model

    @reg_model.setter
    def reg_model(self, model):
        self._reg_model = model
        self._replicas = None
        self._graphs = {}

    @property
    def anchors(self):
        return self._anchors

    @anchors.setter
    def anchors(self, anchors):
        self._anchors = anchors
        self._graphs = {}

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
        frame; the span ``serve.detect``."""
        cfg = self.cfg
        with annotate('tpudet3d_torch.serve.detect'):
            det_in = resize_bilinear(frames, (INPUT_SIZE, INPUT_SIZE),
                                     reverse_channels=cfg.input_is_bgr,
                                     scale=1.0 / 255.0,
                                     dtype=self.det_model.dtype)
            with intercepting(self.det_model, cfg.det_int8_scales):
                logits, deltas = self.det_model(det_in)
            dets = decode_detections(logits.contiguous(), deltas.contiguous(),
                                     self.anchors, **self.decode_kwargs())
            return det_in, logits, deltas, dets, self._crop_boxes(
                dets, h, w, margin)

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
        ``[N, max_det, 26]``; the span ``serve.regress``."""
        cfg = self.cfg
        n, md = boxes.shape[:2]
        tta_w = cfg.crop_size[1] if cfg.tta_flip else 0
        with annotate('tpudet3d_torch.serve.regress'):
            for _ in range(int(cfg.refine_passes)):
                pre, logits = self._heads(frames, boxes)
                boxes = head_epilogue(
                    pre, logits, boxes.reshape(n * md, 4), tta_w,
                    refine=(w, h, refine_margin, cfg.refine_edge_grow)) \
                    .reshape(n, md, 4)
            pre, logits = self._heads(frames, boxes)
            return head_epilogue(pre, logits, boxes.reshape(n * md, 4),
                                 tta_w, dets=dets.reshape(n * md, 6),
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
        """frames ``[N,H,W,3]`` uint8 on the host → packed ``[N/k, max_det,
        26]`` slices on the k replicas' devices, in order; the replicas'
        streams are left running (:meth:`_readback` waits for them)."""
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
        return outs

    def _readback(self, outs):
        """Packed rows on the devices → per-frame result dicts on the host,
        after the replicas' streams (if any); the span
        ``serve.readback``, which holds the host's wait for the device."""
        with annotate('tpudet3d_torch.serve.readback'):
            for (_, stream) in self._replicas or ():
                if stream is not None:
                    stream.synchronize()
            packed = np.concatenate([o.cpu().numpy() for o in outs])
            return [_unpack(p[np.nonzero(p[:, 25] > 0)[0]]) for p in packed]

    # --- CUDA graphs ------------------------------------------------------
    def _graphed(self):
        """Whether ``infer_batch`` replays graphs: an unsharded card."""
        return self.device.type == 'cuda' and not self._replicas

    def _graph_key(self, frames, h, w):
        """What a graph of the path fixes: the frames' shape and dtype,
        ``h``, ``w``, the configuration by value (margins and int8 scales
        included), the versions of the weights it reads as int8 copies
        made at its capture, and the switches by which cuDNN and cuBLAS
        pick their algorithms."""
        cfg, cudnn = self.cfg, torch.backends.cudnn
        return (tuple(frames.shape), str(frames.dtype), h, w,
                tuple(_by_value(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg)),
                int8_versions(self.det_model, cfg.det_int8_scales),
                int8_versions(self.reg_model, cfg.reg_int8_scales),
                cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    def _graph_batch(self, frames, h, w):
        """frames ``[N,H,W,3]`` uint8 on the host → packed ``[N, max_det,
        26]`` on the card, by the key's graph (captured on its first
        call); the spans ``serve.upload``, then ``serve.replay`` or
        ``serve.capture``."""
        key = self._graph_key(frames, h, w)
        with annotate('tpudet3d_torch.serve.upload'):
            host = _host_frames(frames, self.device)
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, host, h, w)
        with annotate('tpudet3d_torch.serve.replay'):
            g.static_in.copy_(host, non_blocking=True)
            g.graph.replay()
        self.graph_stats['replays'] += 1
        return g.static_out

    def _capture(self, key, host, h, w):
        """The first call of ``key``: the path run eagerly on a side stream
        (this call's answer), then captured; the span ``serve.capture``."""
        cfg = self.cfg
        with annotate('tpudet3d_torch.serve.capture'):
            static_in = torch.empty(host.shape, dtype=host.dtype,
                                    device=self.device)
            static_in.copy_(host, non_blocking=True)

            def path():
                return self._pipeline_core(static_in, h, w,
                                           cfg.crop_margin_px,
                                           cfg.refine_margin_px)
            answer = warm_up(path, self.device)
            graph, static_out = capture_graph(path, self.device)
            held = (int8_weights(self.det_model, cfg.det_int8_scales)
                    + int8_weights(self.reg_model, cfg.reg_int8_scales))
            if len(self._graphs) >= MAX_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
            self._graphs[key] = _Graph(static_in, graph, static_out, held)
        self.graph_stats['captures'] += 1
        return answer

    # --- batched (server) API ---------------------------------------------
    def infer_batch(self, frames):
        """frames ``[N,H,W,3]`` uint8 → list of per-frame result dicts.
        After ``shard(devices)`` N must split evenly over the replicas.
        Each stage is a span and the spans tile the call: eagerly
        ``serve.upload``, ``serve.detect``, ``serve.regress``,
        ``serve.readback``; on a graph's replay ``serve.upload``,
        ``serve.replay``, ``serve.readback``; on its capture
        ``serve.upload``, ``serve.capture`` (which holds ``serve.detect``
        and ``serve.regress`` twice: warm-up and capture),
        ``serve.readback``."""
        h, w = frames.shape[1:3]
        if self._graphed():
            return self._readback([self._graph_batch(frames, h, w)])
        self.graph_stats['eager'] += 1
        if self._replicas:
            outs = self._sharded_batch(np.asarray(frames), h, w)
        else:
            outs = [self._pipeline_batch(self._upload(frames), h, w)]
        return self._readback(outs)

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
        with annotate('tpudet3d_torch.serve.readback'):
            packed = out.cpu().numpy()
            return _unpack(packed[np.nonzero(packed[:, 25] > 0)[0]], scale)

    def warmup(self, frame_shape=(720, 1280, 3)):
        self(np.zeros(frame_shape, np.uint8))
