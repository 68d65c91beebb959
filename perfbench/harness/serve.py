"""Serving traffic: a closed loop of one client calling the port's
``TwoStageEngine.infer_batch`` on batches of uint8 frames held in host
memory, from a pool of seeded batches that cycle.

The traffic file gives ``batch``, ``height``, ``width``, ``pool`` and the
process's host ``threads`` (``torch.set_num_threads``: with the default
of one a core, the 88 MB pinned copy of each call spreads over every core
of a host that neighbours share, and runs spread the wider the more
threads copy: 19% in frames/s at eight, 5-15% at two, 2% at one over
three runs on an H100 host); the configuration file the detector, the
regressor and the engine's settings.

``correct`` judges every answer of the window against the float32
reference, staged so that no discrete choice of the detector's
suppression decides it (with random weights the top scores lie on a
plateau of neighbouring anchors):

* every frame returns ``max_detections`` rows (``rows_missing``);
* each row's box and score are those the reference decodes at some anchor
  for the row's class (``det_box_gap_px``, ``det_score_gap``): K1, the
  detector and K3's decode;
* the rows are what greedy suppression keeps over the reference's scores
  and boxes, as far as rounding cannot decide it (``nms_overlap``,
  ``nms_missed_score``; see :func:`selection`): K3's selection;
* at each row's own crop box, the reference's regressor gives the row's
  keypoints under the row's class (``kp_gap``: K2, the regressor, K4) and
  its largest logit at the row's class (``label_logit_gap``, the largest
  logit less the row class's: the classifier head and K4's argmax).
"""

import time
from math import inf

import numpy as np
import torch

from reference import models as ref_models
from reference import serve as ref_serve
from reference import image as ref_image

from . import inputs, weights, yardstick
from .common import busy_intervals, cuda, split as _split
from .common import traced as traced_calls

HOST_CALLS = 2   # calls traced with the host's operations too

FIELDS = 25      # boxes 4, score, det label, keypoints 18, label


def reference_models(cfg, seed, frames, device):
    """The float32 reference detector and regressor on ``device`` with the
    benchmark's weights (drawn and calibrated on ``frames``), and their
    ``state_dict`` s."""
    det = ref_models.SSDDetector(cfg['detector']['num_classes'],
                                 cfg['detector']['width_mult'],
                                 cfg['detector']['cascade'])
    reg = ref_models.MultiHeadRegressor(cfg['regressor']['backbone'],
                                        cfg['regressor']['num_classes'])
    f = torch.as_tensor(frames).to(device)
    size = ref_models.INPUT_SIZE
    det_sd = weights.make(det, inputs.stream_seed(seed, 'weights_det'),
                          device, ref_image.resize(f, (size, size), True,
                                                   1.0 / 255.0))
    n, h, w, _ = f.shape
    boxes = torch.tensor([[0, 0, w, h], [w / 4, h / 4, 3 * w / 4, 3 * h / 4]],
                         dtype=torch.float32, device=device).expand(n, 2, 4)
    scale, offset = ref_serve.reg_norm()
    crops = ref_image.crop(f, boxes, tuple(cfg['regressor']['crop']), True,
                           scale, offset)
    reg_sd = weights.make(reg, inputs.stream_seed(seed, 'weights_reg'),
                          device, crops)
    return det.eval(), reg.eval(), det_sd, reg_sd


def build_engine(cfg, det_sd, reg_sd, device):
    """The port's serving engine with the benchmark's weights."""
    from tpudet3d_torch.detect.ssd import SSDDetector
    from tpudet3d_torch.infer.engine import EngineConfig, TwoStageEngine
    from tpudet3d_torch.models.builder import build_backbone
    from tpudet3d_torch.models.wrapper import MultiHeadRegressor
    dtype = getattr(torch, cfg['dtype'])
    with torch.device(device):
        det = SSDDetector(num_classes=cfg['detector']['num_classes'],
                          width_mult=cfg['detector']['width_mult'],
                          dtype=dtype, cascade=cfg['detector']['cascade'])
        reg = MultiHeadRegressor(build_backbone(cfg['regressor']['backbone']),
                                 num_classes=cfg['regressor']['num_classes'],
                                 dtype=dtype)
    det.load_state_dict(det_sd)
    reg.load_state_dict(reg_sd)
    engine_cfg = EngineConfig(crop_size=tuple(cfg['regressor']['crop']),
                              **cfg['serve'])
    return TwoStageEngine(det, reg, engine_cfg, device=device)


class ReferenceEngine:
    """The control: the reference put in the program's place, every conv's,
    dense layer's and matmul's operands rounded to float8 (the precision
    below the configuration's bfloat16), answering as ``infer_batch``."""

    def __init__(self, cfg, det_sd, reg_sd, device):
        self.cfg, self.device = cfg, device
        self.det = ref_models.SSDDetector(cfg['detector']['num_classes'],
                                          cfg['detector']['width_mult'],
                                          cfg['detector']['cascade'])
        self.reg = ref_models.MultiHeadRegressor(
            cfg['regressor']['backbone'], cfg['regressor']['num_classes'])
        self.det.load_state_dict(det_sd)
        self.reg.load_state_dict(reg_sd)
        self.det.to(device).eval()
        self.reg.to(device).eval()

    def infer_batch(self, frames):
        with ref_models.lowered('fp8'):
            return ref_serve.rows(
                self.det, self.reg, torch.as_tensor(frames).to(self.device),
                self.cfg['serve'], tuple(self.cfg['regressor']['crop']),
                self.cfg['detector']['num_classes'])


def pack(result, rows):
    """``infer_batch``'s per-frame dicts → ``[N, rows, 25]`` float64, NaN
    where a frame returned fewer rows."""
    out = np.full((len(result), rows, FIELDS), np.nan)
    for i, r in enumerate(result):
        k = min(len(r['scores']), rows)
        out[i, :k, 0:4] = r['boxes'][:k]
        out[i, :k, 4] = r['scores'][:k]
        out[i, :k, 5] = r['det_labels'][:k]
        out[i, :k, 6:24] = r['kp'][:k].reshape(k, 18)
        out[i, :k, 24] = r['labels'][:k]
    return out


def judge_one(det, reg, frames, packed, cfg, device):
    """The staged numbers of one batch's answer ``packed [N, M, 25]``
    against the reference; see the module's docstring."""
    serve = cfg['serve']
    margin = float(np.float32(serve['crop_margin_px']))
    classes = cfg['detector']['num_classes']
    probs, ref_boxes, det_boxes = ref_serve.detect(det, frames, margin,
                                                   classes)
    rows = torch.as_tensor(packed, dtype=torch.float64, device=device)
    have = ~torch.isnan(rows[..., 4])
    out = {'rows_missing': float((~have).sum())}
    boxes = rows[..., 0:4].nan_to_num(0.0)
    # [N, M, A]: each row's box against every anchor's crop box
    dist = (boxes[:, :, None, :] - ref_boxes.double()[:, None]).abs() \
        .amax(-1)
    best, nearest = dist.min(-1)
    label = rows[..., 5].nan_to_num(0).long().clamp(0, classes - 1)
    p = probs.double().transpose(1, 2)                        # [N, C, A]
    p_row = torch.gather(p, 1, label[..., None].expand(-1, -1, p.shape[2]))
    near = dist <= best[..., None] + 1.0
    score_gap = torch.where(near, (p_row - rows[..., 4:5]).abs(),
                            torch.inf).amin(-1)
    overlap, missed = selection(probs.double(), det_boxes.double(), nearest,
                                label, rows[..., 4].nan_to_num(0.0), have,
                                serve)
    kp_ref, logits = ref_serve.regress(reg, frames, boxes.float(),
                                       tuple(cfg['regressor']['crop']))
    label = rows[..., 24].nan_to_num(0).long().clamp(
        0, logits.shape[1] - 1).reshape(-1)
    idx = torch.arange(label.shape[0], device=device)
    kp_sel = kp_ref[idx, label].double().reshape(rows.shape[0],
                                                 rows.shape[1], 18)
    kp_gap = (kp_sel - rows[..., 6:24]).abs().amax(-1)
    logits = logits.double()
    label_gap = (logits.amax(-1) - logits[idx, label]).view(rows.shape[:2])
    for name, x in (('det_box_gap_px', best), ('det_score_gap', score_gap),
                    ('kp_gap', kp_gap), ('label_logit_gap', label_gap)):
        x = x[have]
        out[name] = float(x.max()) if x.numel() else 0.0
    out['nms_overlap'] = overlap
    out['nms_missed_score'] = missed
    return out


IOU_SLACK = 0.05     # of the suppression's IoU threshold, for box rounding
TOPK_SLACK = 0.01    # of a class's K-th score, for score rounding


def selection(probs, det_boxes, nearest, label, score, have, serve):
    """How far the rows depart from greedy suppression over the
    reference's scores ``probs [N,A,C]`` and boxes ``det_boxes [N,A,4]``
    (detector pixels), each row at its nearest anchor ``nearest [N,M]``
    with its class ``label`` and score ``score``:

    * ``nms_overlap``: the largest IoU of two rows of one class (greedy
      suppression keeps none above ``nms_iou``);
    * ``nms_missed_score``: the largest score of an anchor and class, among
      each class's ``pre_nms_k`` best, that no row explains, above the
      frame's lowest row score.  A row explains an anchor of its class
      that it overlaps above ``nms_iou`` less :data:`IOU_SLACK` (itself
      included) up to the row's own score.  Sound answers read about 0;
      rows kept out of score order, or below an anchor that nothing
      suppressed, read the score they passed over.

    Anchors within :data:`TOPK_SLACK` of the K-th score of their class are
    left out, so that which of them the program's rounding took into its
    ``pre_nms_k`` does not decide the number."""
    n, a, c = probs.shape
    m = nearest.shape[1]
    rb = torch.gather(det_boxes, 1, nearest[..., None].expand(-1, -1, 4))
    same = (label[:, :, None] == label[:, None, :]) \
        & have[:, :, None] & have[:, None, :] \
        & ~torch.eye(m, dtype=torch.bool, device=have.device)
    overlap = torch.where(same, ref_serve.iou(rb, rb), 0.0).amax()
    k = min(max(4 * serve['max_detections'], 32), a)
    kth = probs.topk(k, dim=1).values[:, -1:, :]             # [N, 1, C]
    cand = (probs > kth + TOPK_SLACK) & (probs > serve['score_thr'])
    ov = ref_serve.iou(det_boxes, rb) > serve['nms_iou'] - IOU_SLACK
    of_class = torch.nn.functional.one_hot(label, c).bool() \
        & have[..., None]                                     # [N, M, C]
    explains = ov[..., None] & of_class[:, None]              # [N,A,M,C]
    cover = torch.where(explains, score[:, None, :, None], -torch.inf) \
        .amax(2)                                              # [N, A, C]
    floor = torch.where(have, score, torch.inf).amin(1)
    floor = torch.where(have.all(1), floor,
                        torch.full_like(floor, serve['score_thr']))
    excess = probs - torch.maximum(cover, floor[:, None, None])
    missed = torch.where(cand, excess, 0.0).amax().clamp(min=0.0)
    return float(overlap), float(missed)


def judge(det, reg, pool, answers, cfg, seed, device, per_batch=4):
    """The worst of each number over the window's answers: for each pool
    batch its distinct answers (the same frames give the same rows unless
    the program is not deterministic), at most ``per_batch`` of them drawn
    from the seed."""
    rng = np.random.default_rng(inputs.stream_seed(seed, 'sample'))
    m = cfg['serve']['max_detections']
    worst, judged = {}, 0
    for b, frames_np in enumerate(pool):
        distinct = {}
        for ans in answers[b]:
            packed = pack(ans, m)
            distinct.setdefault(packed.tobytes(), packed)
        picked = list(distinct.values())
        if len(picked) > per_batch:
            picked = [picked[i] for i in sorted(
                rng.choice(len(picked), per_batch, replace=False))]
        frames = torch.as_tensor(frames_np).to(device)
        for packed in picked:
            for k, v in judge_one(det, reg, frames, packed, cfg,
                                  device).items():
                worst[k] = max(worst.get(k, 0.0), v if v == v else inf)
            judged += 1
        del frames
    worst['distinct_answers_judged'] = judged
    return worst


def run(ctx):
    """One run of a serving cell; returns the result's fields, the numbers
    judged, and the per-layer trace (or None)."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    batch, h, w = tr['batch'], tr['height'], tr['width']
    torch.set_num_threads(tr['threads'])
    marks = [('start', time.perf_counter())]
    pool = inputs.frame_pool(ctx.seed, tr['pool'], batch, h, w, dev)
    marks.append(('inputs', time.perf_counter()))
    det_ref, reg_ref, det_sd, reg_sd = reference_models(
        cfg, ctx.seed, pool[0][:tr['calibration_frames']], dev)
    marks.append(('weights', time.perf_counter()))
    det_ref.cpu()
    reg_ref.cpu()
    cuda(dev, torch.cuda.empty_cache)
    cuda(dev, torch.cuda.reset_peak_memory_stats, dev)
    if ctx.control == 'fp8':
        engine = ReferenceEngine(cfg, det_sd, reg_sd, dev)
    else:
        engine = build_engine(cfg, det_sd, reg_sd, dev)
    del det_sd, reg_sd
    marks.append(('program', time.perf_counter()))
    answers = [[] for _ in pool]
    for b in range(len(pool)):                      # every shape, warm
        answers[b].append(engine.infer_batch(pool[b]))
    cuda(dev, torch.cuda.synchronize, dev)
    marks.append(('warm-up', time.perf_counter()))
    setup_s = time.perf_counter() - ctx.t0

    lat, calls = [], 0
    gc_time = _gc_clock()
    start = time.perf_counter()
    while True:
        b = calls % len(pool)
        t = time.perf_counter()
        res = engine.infer_batch(pool[b])
        end = time.perf_counter()
        lat.append(end - t)
        answers[b].append(res)
        calls += 1
        if end - start >= ctx.seconds:
            break
    window_s = end - start
    gc_s = gc_time()

    trace = None
    if ctx.trace:
        trace = traced(engine, pool, answers, cfg, tr, calls, window_s,
                       ctx.trace_calls, dev)
    peak = cuda(dev, torch.cuda.max_memory_allocated, dev) or 0
    del engine
    cuda(dev, torch.cuda.empty_cache)
    det_ref.to(dev)
    reg_ref.to(dev)
    numbers = judge(det_ref, reg_ref, pool, answers, cfg, ctx.seed, dev)
    e2e = {'serve_fps': calls * batch / window_s,
           'serve_p95_ms': float(np.percentile(np.asarray(lat) * 1e3, 95)),
           'setup_s': setup_s}
    return dict(e2e=e2e, attempted=calls * batch, numbers=numbers,
                memory_peak_bytes=peak, trace=trace,
                window=dict(calls=calls, window_s=window_s,
                            setup=_split(ctx.t0, marks), gc_s=gc_s,
                            ms_p5_p50_p95=np.percentile(
                                np.asarray(lat) * 1e3, [5, 50, 95]).tolist(),
                            ms_by_quarter=[float(np.mean(q)) * 1e3 for q in
                                           np.array_split(lat, 4) if len(q)]))


def traced(engine, pool, answers, cfg, tr, calls, window_s, n, dev):
    """``n`` more calls under ``torch.profiler``: the trace the per-layer
    readers take their numbers from.  ``bounds`` holds, for each kernel
    of the regressor's backbone file that it counts, its least time in
    each traced call (none for the backbones of ``BACKBONES``)."""
    def call(i):
        b = (calls + i) % len(pool)
        answers[b].append(engine.infer_batch(pool[b]))

    device, traced_s, bd = traced_calls(call, n, HOST_CALLS, dev,
                                        'infer_batch')
    size = ref_models.INPUT_SIZE
    batch, h, w = tr['batch'], tr['height'], tr['width']
    crop = tuple(cfg['regressor']['crop'])
    itemsize = torch.empty((), dtype=getattr(torch, cfg['dtype'])) \
        .element_size()
    k2 = []
    for i in range(n):
        b = (calls + i) % len(pool)
        boxes = torch.as_tensor(pack(answers[b][-1],
                                     cfg['serve']['max_detections'])[..., :4])
        k2.append(yardstick.bound_s(
            yardstick.k2_bytes(torch.nan_to_num(boxes).float(), h, w, crop,
                               itemsize),
            boxes.shape[0] * boxes.shape[1] * crop[0] * crop[1] * 3 * 8))
    with torch.device('meta'):
        det = ref_models.SSDDetector(cfg['detector']['num_classes'],
                                     cfg['detector']['width_mult'],
                                     cfg['detector']['cascade'])
        reg = ref_models.MultiHeadRegressor(cfg['regressor']['backbone'],
                                            cfg['regressor']['num_classes'])
        flops = (yardstick.forward_flops(
            det, torch.empty(batch, size, size, 3))[0]
            + yardstick.forward_flops(reg, torch.empty(
                batch * cfg['serve']['max_detections'], *crop, 3))[0])
    return dict(
        kind='serve', events=device, units=n, items_per_unit=batch,
        busy_s=sum(e - s for s, e in busy_intervals(device)) / 1e6,
        window_s=traced_s, unit_wall_s=window_s / calls,
        flops_per_unit=flops,
        k1_bound_s=yardstick.bound_s(
            yardstick.k1_bytes(batch, h, w, (size, size), itemsize),
            yardstick.k1_ops(batch, h, w, (size, size))),
        k2_bound_s=k2, bounds=yardstick.backbone_bounds(
            cfg['regressor']['backbone'],
            batch * cfg['serve']['max_detections'], crop, itemsize, False,
            n),
        breakdown=bd)


def _gc_clock():
    """Start timing the interpreter's garbage collections; the returned
    function stops and gives their seconds."""
    import gc
    spent, began = [0.0], [0.0]

    def cb(phase, info):
        if phase == 'start':
            began[0] = time.perf_counter()
        else:
            spent[0] += time.perf_counter() - began[0]
    gc.callbacks.append(cb)

    def stop():
        gc.callbacks.remove(cb)
        return spent[0]
    return stop
