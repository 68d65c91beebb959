"""The cases, inputs, tolerances and comparisons that hold each CUDA kernel
of the port against its plain PyTorch version, in one place for the card
smoke (``chip_smoke.py``), the kernel tools (``tools/k1_bench.py`` to
``k6_bench.py``) and the port's tests, so that all of them check the same
cases at the same tolerances:

* K1–K7's cases (``K1_CASES`` to ``K7_CASES``), their tolerances
  (``K1_TOLS``, ``K2_TOLS``, :func:`k4_error`) and their inputs, each made
  from a seed;
* the boxes and keypoints of the geometry's tests (:func:`box_kps`,
  :func:`projected_box_keypoints`), the demo's moving frames, the seeded
  snapshots of the flagship configuration (:func:`write_snapshots`) and
  the distances of two parameter trees (:func:`update_err`,
  :func:`max_leaf_err`);
* :func:`cycle_ms`, the back-to-back time of a call on the card.

Every function that builds or reads a port module imports it when it is
called, so that a kernel tool that switches checkouts (``use_tree``)
drives that checkout's package.  Importing this module needs no CUDA.
"""

import contextlib

import numpy as np
import torch

FRAME = (720, 1280, 3)         # the serving path's 720p BGR frames
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
# the flagship regressor config (EfficientNet-lite0 served from its EMA)
EL0_CONFIG = 'configs/scene_regressor_el0_ema.py'
K4_REFINE = (1280, 720, 10.0, 0.2)     # (w, h, margin_px, edge_grow)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def cycle_ms(fns, iters):
    """Mean device time per call over ``iters`` calls that cycle through
    ``fns`` (CUDA events, after one warm-up call of each)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# K1's shapes on the port's paths, resized to 300²: (name, (H, W), batch,
# frames dropped from the front).  720p serving, 1280×720 portrait
# evaluation, host_downscale 2 and 3, a batch slice frames[1:] whose base
# and rows are not 16-byte aligned, and an upscale.
K1_CASES = (('720p', (720, 1280), 2, 0), ('portrait', (1280, 720), 2, 0),
            ('360p', (360, 640), 2, 0), ('240p', (240, 426), 2, 0),
            ('slice', (239, 425), 3, 1), ('upscale', (100, 150), 2, 0))
K1_TOLS = ((torch.bfloat16, 2 ** -8), (torch.float32, 1e-5))


def k1_frames(case, dev, seed=0):
    """The uint8 frames of a K1_CASES entry on ``dev``, sliced there."""
    _, hw, n, skip = next(c for c in K1_CASES if c[0] == case)
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    return torch.from_numpy(frames).to(dev)[skip:]


# K2's cases: (name, frames (N, H, W), boxes, output (h, w)).  'serving':
# the serving path's 128 boxes of 720p frames; 'tiny': 1-px, sub-pixel,
# empty and inverted boxes (side floored at 1 px); 'border': boxes touching
# and crossing each frame border and one wholly outside (clamp); 'full_row':
# boxes spanning the whole 1280-px row and more; 'upscale': boxes of 22 px
# and 4 px upscaled 10x and 56x to 224; 'portrait': the evaluation path's
# 1280x720 frames; 'n1': one frame; 'out64x48' and 'out62x50': output sizes
# of the CPU tests, 50 columns not a multiple of the kernel's 8-pixel runs
# and 62 rows not a multiple of its band; 'r288': the serving path of
# configs/scene_regressor_el0_r288.py (288² crops, 18 bands of 16 rows).
K2_CASES = (('serving', (16, 720, 1280), 'engine', (224, 224)),
            ('tiny', (2, 720, 1280), 'tiny', (224, 224)),
            ('border', (2, 720, 1280), 'border', (224, 224)),
            ('full_row', (2, 720, 1280), 'full_row', (224, 224)),
            ('upscale', (2, 720, 1280), 'upscale', (224, 224)),
            ('portrait', (2, 1280, 720), 'engine', (224, 224)),
            ('n1', (1, 720, 1280), 'engine', (224, 224)),
            ('out64x48', (2, 720, 1280), 'engine', (64, 48)),
            ('out62x50', (2, 720, 1280), 'border', (62, 50)),
            ('r288', (16, 720, 1280), 'engine', (288, 288)))
K2_TOLS = ((torch.bfloat16, 2 ** -7 + 1e-4), (torch.float32, 1e-4))


def engine_like_boxes(n, k, h, w, seed):
    """Boxes as the serving path makes them: inside the frame, some on its
    edges, some thinner than a pixel."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-40, w, (n, k))
    y0 = rng.uniform(-40, h, (n, k))
    b = np.stack([x0, y0, x0 + rng.uniform(0.2, w / 2, (n, k)),
                  y0 + rng.uniform(0.2, h / 2, (n, k))], -1)
    return np.clip(b, 0, [w, h, w, h]).astype(np.float32)


def k2_boxes(kind, n, h, w, seed=1):
    """Boxes [n,8,4] of a K2_CASES kind as numpy."""
    if kind == 'engine':
        return engine_like_boxes(n, 8, h, w, seed)
    rng = np.random.RandomState(seed)
    x, y = rng.uniform(0, w - 30, 8), rng.uniform(0, h - 30, 8)
    if kind == 'tiny':
        b = [[x[0], y[0], x[0] + 1, y[0] + 1],
             [x[1], y[1], x[1] + .3, y[1] + .2],
             [x[2], y[2], x[2], y[2]],
             [x[3], y[3], x[3] - 5, y[3] - 3],
             [0, 0, 1, 1], [w - 1, h - 1, w, h],
             [x[6], y[6], x[6] + 1.5, y[6] + .7],
             [x[7] + .5, y[7] + .5, x[7] + 1.25, y[7] + 3]]
    elif kind == 'border':
        b = [[0, 0, 50, 40], [-30, -20, 40, 30], [w - 50, h - 40, w, h],
             [w - 40, h - 30, w + 30, h + 20], [-10, 100, w + 10, 200],
             [100, -5, 200, h + 5], [w - 1, h - 1, w + 5, h + 5],
             [-20, -20, -5, -5]]
    elif kind == 'full_row':
        b = [[0, y[0], w, y[0] + 100], [-50, y[1], w + 50, y[1] + 300],
             [0, 0, w, h], [0, y[3], w, y[3] + 1], [0.5, 0, w - 0.5, 20],
             [0, h - 224, w, h], [-1, y[6], w + 1, y[6] + 5],
             [0, y[7], w, y[7] + 10]]
    elif kind == 'upscale':
        b = [[x[i], y[i], x[i] + 22.4, y[i] + 22.4] for i in range(6)] + [
            [x[6], y[6], x[6] + 4, y[6] + 4], [0, 0, 22.4, 22.4]]
    else:
        raise ValueError(f'unknown kind {kind!r}')
    b = np.asarray(b, np.float32)
    return np.stack([b + 3 * i * (kind not in ('border', 'full_row'))
                     for i in range(n)])


def k2_case(case, dev, seed=0):
    """The frames, boxes and output size of a K2_CASES entry on ``dev``."""
    _, (n, h, w), kind, out_hw = next(c for c in K2_CASES if c[0] == case)
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    return (torch.from_numpy(frames).to(dev),
            torch.from_numpy(k2_boxes(kind, n, h, w)).to(dev), out_hw)


# K3's serving settings: the base decode (K=32, max_det 8) and the three
# suppressions on top of it
K3_BASE = dict(score_thr=0.02, iou_thr=0.45, max_per_img=8, pre_nms_k=32)
K3_SETTINGS = {'greedy': {},
               'soft': dict(soft_nms_sigma=0.5, soft_nms_dup_iou=0.75),
               'vote': dict(box_vote_iou=0.6)}
DET_ANCHORS, DET_CLASSES = 2044, 9     # the default detector's A and C


def det_batch(n, kind='random', seed=2):
    """Detector logits ``[n,A,C+1]`` and deltas ``[n,A,4]`` as numpy.

    ``random``: logits N(0, 2²), anchors 100–139 a copy of anchor 99 (exact
    score ties); ``sparse``: background-dominant, as a trained detector's
    (the background logit, the last, 8; classes N(0, 1.5²)), so that only
    a few anchors per class clear a 0.02 floor; ``ties``: sparse, plus for
    each class c ten anchors with a distinct high score and a run of 40
    anchors with one equal score just below them, so that the run
    straddles the 32nd place.
    """
    a, c = DET_ANCHORS, DET_CLASSES
    rng = np.random.RandomState(seed)
    deltas = (rng.standard_normal((n, a, 4)) * 0.5).astype(np.float32)
    if kind == 'random':
        logits = rng.standard_normal((n, a, c + 1)) * 2.0
        logits[:, 100:140] = logits[:, 99:100]
    elif kind in ('sparse', 'ties'):
        logits = rng.standard_normal((n, a, c + 1)) * 1.5
        logits[..., c] = 8.0
        if kind == 'ties':
            for k in range(c):
                top = slice(200 * k, 200 * k + 10)
                logits[:, top] = -2.0
                logits[:, top, c] = 0.0
                logits[:, top, k] = 5.0 + rng.uniform(0, 1, (n, 10))
                run = slice(200 * k + 20, 200 * k + 60)
                logits[:, run] = -2.0
                logits[:, run, c] = 0.0
                logits[:, run, k] = 4.0
    else:
        raise ValueError(f'unknown kind {kind!r}')
    return logits.astype(np.float32), deltas


# K3's cases, each on top of K3_BASE: (name, N, logits of det_batch,
# settings).  The serving path's greedy, soft-NMS and box-vote settings at
# N=16 and N=1; objectron_eval's floor at det_tresh 0 and its --preset
# recall; background-dominant logits that leave fewer than K candidates
# per class (zero rows padded); a run of equal scores across the K-th
# place; K=256 (max_detections 64) and the JAX defaults (K=200,
# max_per_img 200), above the K up to which the kernel keeps the soft-NMS
# decays in shared memory; the kernel's large-K instantiation at K=512
# (max_detections 128: bit rows in shared memory) and K=2044
# (max_detections 511, the most the 2044 anchors allow: bit rows in the
# device scratch); detector training's two shapes: its validation (N=64,
# K=200, max_det 100) and self-labelling (N=32, K=64, max_det 16, floor
# 0.05).
K3_SOFT = K3_SETTINGS['soft']
K3_CASES = (('greedy', 16, 'random', {}),
            ('soft', 16, 'random', K3_SOFT),
            ('vote', 16, 'random', K3_SETTINGS['vote']),
            ('n1', 1, 'random', {}),
            ('floor0', 16, 'random', dict(score_thr=0.0)),
            ('recall', 16, 'random', dict(score_thr=0.005, **K3_SOFT)),
            ('sparse', 16, 'sparse', {}),
            ('ties', 16, 'ties', {}),
            ('k256', 16, 'random', dict(pre_nms_k=256, max_per_img=64)),
            ('k256_soft', 16, 'random', dict(pre_nms_k=256, max_per_img=64,
                                            **K3_SOFT)),
            ('jax_defaults', 16, 'random', dict(pre_nms_k=200,
                                                max_per_img=200)),
            ('jax_defaults_vote', 16, 'random', dict(
                pre_nms_k=200, max_per_img=200, box_vote_iou=0.6)),
            ('k512', 16, 'random', dict(pre_nms_k=512, max_per_img=128)),
            ('k512_soft', 16, 'random', dict(
                pre_nms_k=512, max_per_img=128, soft_nms_sigma=0.5,
                soft_nms_dup_iou=0.8)),
            ('k2044', 16, 'random', dict(pre_nms_k=2044, max_per_img=511)),
            ('k2044_vote', 16, 'random', dict(
                pre_nms_k=2044, max_per_img=511, box_vote_iou=0.6)),
            ('det_eval', 64, 'random', dict(pre_nms_k=200,
                                            max_per_img=100)),
            ('selflabel', 32, 'random', dict(score_thr=0.05, pre_nms_k=64,
                                             max_per_img=16)))


def k3_case(case, dev, n=None):
    """Logits and deltas of a K3_CASES entry on ``dev`` (its first ``n``
    images, all by default) and its decode settings."""
    _, n_case, kind, kw = next(c for c in K3_CASES if c[0] == case)
    logits, deltas = det_batch(n_case, kind)
    return (torch.from_numpy(logits[:n]).to(dev),
            torch.from_numpy(deltas[:n]).to(dev), dict(K3_BASE, **kw))


def compare_dets(out, ref, what):
    """K3's rows against its plain version's: the rows with score > 0
    agree (padded rows carry arbitrary boxes), scores within 1e-6, boxes
    within 1e-3 px and labels exact; raises otherwise.  Returns the
    error."""
    keep = ref[..., 4] > 0
    if not bool(keep.any()):
        raise RuntimeError(f'{what}: no detection')
    if not torch.equal(out[..., 4] > 0, keep):
        raise RuntimeError(f'{what}: kept rows differ')
    e_s = max_err(out[..., 4][keep], ref[..., 4][keep])
    e_b = max_err(out[..., :4][keep], ref[..., :4][keep])
    if not torch.equal(out[..., 5][keep], ref[..., 5][keep]):
        raise RuntimeError(f'{what}: labels differ')
    print(f'{what}: max |kernel - plain| score {e_s:.3g} (tol 1e-6), '
          f'box {e_b:.3g} px (tol 1e-3)')
    if not (e_s <= 1e-6 and e_b <= 1e-3):
        raise RuntimeError(f'{what} disagrees')
    return max(e_s, e_b)


# K4's logit rows with NaNs and ties ({class: value} over negative logits),
# cycled over the crops: torch.argmax takes the first NaN, else the first
# maximum.  Ties sit in lanes far apart in K4's warp reduction (1 and 8,
# 2 and 7), all nine tie, -0.0 ties +0.0, and with TTA a crop and its
# mirror give inf - inf = NaN or NaN + x.
K4_SPECIAL_ROWS = (
    {c: 1.5 for c in range(9)},                      # 0: all nine tie
    {1: 4.0, 8: 4.0},                                # 1
    {6: np.nan, 3: np.nan, 0: 7.0},                  # 3: first NaN
    {8: np.nan, 0: np.inf},                          # 8: NaN beats inf
    {c: -np.inf for c in range(9)},                  # 0: all -inf
    {2: np.inf, 7: np.inf},                          # 2
    {5: -0.0, 4: 0.0},                               # 4: -0.0 == +0.0
    {8: 3.0},                                        # 8: the last class
)
# K4's crop counts beyond the serving pass's 128: one warp's crop alone,
# and a last CTA of 3 or 1 live warps; (B, NaNs and ties)
K4_CASES = ((128, False), (1, False), (127, False), (129, False),
            (128, True), (1, True), (127, True), (129, True))


def k4_inputs(b, tta, seed=0, nan_ties=False):
    """Regressor outputs for K4 over b crops as numpy: pre-activations
    [B',9,18] (every 7th crop saturated, so keypoints press against the
    crop edge), logits [B',9] exactly representable in bfloat16 with exact
    ties at the maximum (the same in a crop and its mirror), crop boxes
    [b,4] in a 720p frame and detections [b,6] (every 5th a padded row
    with score 0).  With ``nan_ties`` the logits follow K4_SPECIAL_ROWS
    instead, a crop's mirror three patterns on from the crop's own."""
    rng = np.random.RandomState(seed)
    b2 = 2 * b if tta else b
    pre = rng.normal(0.0, 2.0, (b2, 9, 18)).astype(np.float32)
    pre[::7] *= 8.0
    logits = rng.normal(0.0, 2.0, (b2, 9)).astype(np.float32)
    logits = torch.from_numpy(logits).bfloat16().float().numpy()
    if nan_ties:
        logits = -np.abs(logits) - 1.0
        for r in range(b2):
            pattern = K4_SPECIAL_ROWS[(r % b + 3 * (r >= b))
                                      % len(K4_SPECIAL_ROWS)]
            for c, v in pattern.items():
                logits[r, c] = v
    else:
        group = np.arange(b2) % b % 3
        logits[group == 0, 4] = logits[group == 0, 6] = 8.0
        logits[group == 1, 2] = logits[group == 1, 7] = 9.0
    w, h = K4_REFINE[:2]
    x0 = rng.uniform(-20, w, b)
    y0 = rng.uniform(-20, h, b)
    boxes = np.stack([x0, y0, x0 + rng.uniform(0.5, 400, b),
                      y0 + rng.uniform(0.5, 300, b)], -1)
    boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
    dets = np.zeros((b, 6), np.float32)
    dets[:, :4] = boxes
    dets[:, 4] = rng.uniform(0, 1, b)
    dets[::5, 4] = 0.0
    dets[:, 5] = rng.randint(0, 9, b)
    return pre, logits, boxes, dets


def k4_error(out, ref, refine):
    """K4's output ``out`` against its plain version's ``ref``: (max error,
    whether it is within tolerance).  Refine mode: boxes within 1e-4 px;
    pack mode: keypoints within 1e-6, and boxes, scores, labels and
    conf_mask exact (the error is inf where they differ)."""
    if refine:
        e = max_err(out, ref)
        return e, e <= 1e-4
    rest = [0, 1, 2, 3, 4, 5, 24, 25]
    if not torch.equal(out[:, rest], ref[:, rest]):
        return float('inf'), False
    e = max_err(out[:, 6:24], ref[:, 6:24])
    return e, e <= 1e-6


def compare_k4(out, ref, what, refine):
    """Raises unless K4 is within :func:`k4_error`'s tolerance; returns the
    error."""
    e, ok = k4_error(out, ref, refine)
    print(f'{what}: max |kernel - plain| '
          + (f'box {e:.3g} px (tol 1e-4)' if refine
             else f'kp {e:.3g} (tol 1e-6; boxes, scores, labels exact)'))
    if not ok:
        raise RuntimeError(f'{what} disagrees')
    return e


def box_kps(center, half, rot=np.eye(3)):
    """Objectron 9-keypoint box: centre, then the 8 corners in binary
    ±e1±e2±e3 order."""
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], float)
    return np.concatenate([[center], corners * half @ rot.T + center])


def rotation(angles):
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    return (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))


def projected_box_keypoints(n, seed=0):
    """[n,9,2] float32 keypoints in [0,1] of random oriented boxes 1.5–3 m
    in front of the default camera, projected as portrait frames are (the
    regressor's training targets; the metrics lift them back).  A box
    whose projection leaves [0,1] is drawn again."""
    from tpudet3d_torch.ops import geometry
    rng = np.random.RandomState(seed)
    cam = geometry.convert_camera_matrix_2_ndc(
        geometry.get_default_camera_matrix())
    out = []
    while len(out) < n:
        box = box_kps(np.r_[rng.uniform(-0.4, 0.4, 2), rng.uniform(-3, -1.5)],
                      rng.uniform(0.1, 0.5, 3),
                      rotation(rng.uniform(-np.pi, np.pi, 3)))
        uv = geometry.project_3d_points(box, cam)
        xy = np.stack([(uv[:, 1] + 1) / 2, (uv[:, 0] + 1) / 2], -1)
        if xy.min() >= 0.0 and xy.max() <= 1.0:
            out.append(xy)
    return np.stack(out).astype(np.float32)


def k5_fuzz_pairs(n, seed=0):
    """n pairs of random oriented boxes [n,9,3] x 2 (float32): random
    rotations, sides 0.05-2, centres within 0.3 of the origin so most
    pairs overlap."""
    rng = np.random.RandomState(seed)

    def one():
        return box_kps(rng.uniform(-0.3, 0.3, 3),
                       rng.uniform(0.05, 2.0, 3) / 2,
                       rotation(rng.uniform(-np.pi, np.pi, 3)))

    pairs = [(one(), one()) for _ in range(n)]
    return (np.stack([p[0] for p in pairs]).astype(np.float32),
            np.stack([p[1] for p in pairs]).astype(np.float32))


def k5_exact_cases():
    """(name, box, box, exact IoU) of the unit box against: itself, a half
    shift, a 45° turn, a nested box, a disjoint box, a touching box and a
    box with a NaN corner."""
    half = np.array([.5, .5, .5])
    unit = box_kps(np.zeros(3), half)
    th = np.pi / 4
    rot = np.array([[np.cos(th), -np.sin(th), 0],
                    [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    inter = 2 * (np.sqrt(2) - 1)
    bad = unit.copy()
    bad[3] = np.nan
    return [('self', unit, unit, 1.0),
            ('half_shift', unit, box_kps(np.array([.5, 0, 0]), half), 1 / 3),
            ('rot45', unit, box_kps(np.zeros(3), half, rot),
             inter / (2 - inter)),
            ('nested', unit, box_kps(np.zeros(3), half / 2), 0.125),
            ('disjoint', unit, box_kps(np.array([5., 0, 0]), half), 0.0),
            ('touching', unit, box_kps(np.array([1., 0, 0]), half), 0.0),
            ('nan', bad, unit, 0.0)]


# K6's cases: (name, NCHW shape, kernel, stride, pad, element offset of the
# input in its buffer, K6's route in bf16 and in f32 for channels-last
# memory; NCHW memory takes ``strided``): the stems of the detector (batch
# 16 at 300²) and of the regressor (128 crops at 224²), 1×1 convs at M =
# 17, 49 and 128·49 rows, the first two with a depth padded from 24 to 32,
# the third el0's widest (1152), a served padded 1×1 (72 → 80 at 56², 128
# crops), a 1×1 of depth 20 (not whole 16-byte bf16 vectors, whole f32
# ones), one of odd depth, one at an odd element offset (an unaligned
# pointer), a 5×5 stride 2 at an odd size, and a 3×3 whose last band, 1
# output row of 2, stages the zero row below the frame
K6_CASES = (('stem300', (16, 3, 300, 300), 3, 2, 1, 0, ('staged', 'staged')),
            ('stem224', (128, 3, 224, 224), 3, 2, 1, 0,
             ('staged', 'staged')),
            ('m17', (1, 24, 1, 17), 1, 1, 0, 0, ('rows', 'rows')),
            ('m49', (1, 24, 7, 7), 1, 1, 0, 0, ('rows', 'rows')),
            ('m6272', (128, 1152, 7, 7), 1, 1, 0, 0, ('rows', 'rows')),
            ('pad72', (128, 72, 56, 56), 1, 1, 0, 0, ('rows', 'rows')),
            ('c20', (2, 20, 9, 9), 1, 1, 0, 0, ('strided', 'rows')),
            ('c13', (2, 13, 9, 9), 1, 1, 0, 0, ('strided', 'strided')),
            ('odd', (1, 24, 7, 7), 1, 1, 0, 1, ('strided', 'strided')),
            ('k5s2', (2, 40, 13, 11), 5, 2, 2, 0, ('staged', 'staged')),
            ('k3edge', (128, 16, 21, 21), 3, 1, 1, 0,
             ('staged', 'staged')))
# K7's cases: (name, M, N, Np, bias): M = 17, 49 and 128·49 rows at the
# regressor's widths; N = 20 of Np = 24 takes the element-wise path
K7_CASES = (('m17', 17, 320, 320, False), ('m49', 49, 960, 960, True),
            ('m6272', 6272, 1280, 1280, False),
            ('m6272_bias', 6272, 320, 320, True),
            ('n20', 49, 20, 24, True))


def k6_input(case, dtype, dev, channels_last=True, seed=0):
    """The input of a K6_CASES entry: normal values times 40 with every
    7th an exact half (a rounding tie at ``s_x = 127``) and a few past
    the clip, at the case's element offset in its buffer; returns ``(x,
    kernel, stride, pad)``."""
    _, shape, k, stride, pad, offset, _ = next(c for c in K6_CASES
                                               if c[0] == case)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) * 40.0
    flat = x.view(-1)
    flat[::7] = flat[::7].round() + 0.5
    flat[:4] = torch.tensor([200.0, -200.0, 126.5, -127.5], device=dev)
    x = x.to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    if offset:
        buf = torch.zeros(x.numel() + offset, dtype=dtype, device=dev)
        view = buf[offset:].as_strided(x.shape, x.stride())
        view.copy_(x)
        x = view
    return x, k, stride, pad


def k6_route(case, dtype, channels_last=True):
    """The route K6 must take on a K6_CASES entry."""
    routes = next(c for c in K6_CASES if c[0] == case)[-1]
    return routes[dtype == torch.float32] if channels_last else 'strided'


def k6_plan(qops, x, kernel, stride, pad):
    """K6's plan for ``x`` on its card (the C entry refuses another)."""
    from tpudet3d_torch.ops.image import _sm_count
    return qops.quantize_plan(tuple(x.shape), x.stride(), x.dtype, kernel,
                              stride, pad, x.data_ptr(), _sm_count(x.device))


def k7_input(case, dev, seed=0):
    """int32 sums, a per-channel scale and a bias (or None) of a K7_CASES
    entry, the sums spanning up to the largest the regressor's widest conv
    can reach (127²·1152)."""
    _, m, n, n_pad, bias = next(c for c in K7_CASES if c[0] == case)
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randint(-127 * 127 * 1152, 127 * 127 * 1152, (m, n_pad),
                      generator=gen, device=dev, dtype=torch.int32)
    y[0, :4] = torch.tensor([2 ** 24 + 1, 257, -(2 ** 24 + 3), 0],
                            device=dev, dtype=torch.int32)
    scale = torch.rand(n, generator=gen, device=dev) * 1e-4
    b = torch.randn(n, generator=gen, device=dev) if bias else None
    return y, scale, b


@contextlib.contextmanager
def plain_quant(qops):
    """K6 and K7 through their plain versions, also on the card."""
    saved = qops.quantize_input, qops.rescale
    qops.quantize_input, qops.rescale = (qops.quantize_input_plain,
                                         qops.rescale_plain)
    try:
        yield
    finally:
        qops.quantize_input, qops.rescale = saved


@contextlib.contextmanager
def recording_int8_convs(quant):
    """Every int8 conv's ``(x, layer, s_x)`` in the calls inside."""
    calls, conv = [], quant.int8_conv

    def record(x, layer, s_x):
        calls.append((x, layer, s_x))
        return conv(x, layer, s_x)

    quant.int8_conv = record
    try:
        yield calls
    finally:
        quant.int8_conv = conv


def moving_frames(n, shape=None, seed=7):
    """n BGR frames of ``shape`` (default FRAME): noise with 3 flat boxes
    moving 3 px right and 1 px down a frame."""
    h, w, _ = shape or FRAME
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    boxes = [(int(w * x0), int(h * y0), int(w * x1), int(h * y1)) for
             x0, y0, x1, y1 in ((0.15, 0.2, 0.33, 0.55), (0.47, 0.28, 0.64,
                                                         0.72),
                                (0.7, 0.42, 0.86, 0.83))]
    colors = rng.randint(0, 256, (3, 3))
    out = []
    for t in range(n):
        f = base.copy()
        for (x0, y0, x1, y1), c in zip(boxes, colors):
            f[y0 + t:y1 + t, x0 + 3 * t:x1 + 3 * t] = c
        out.append(f)
    return out


def write_snapshots(root):
    """A cascade MNv2-SSD-300 w1.0 and an EfficientNet-lite0 regressor
    (seeded) as converted snapshots ``snap_3.pt`` under ``root``; the
    regressor's EMA differs from its raw weights.  Returns the paths, the
    in-memory modules and the state_dicts."""
    import os
    from tpudet3d_torch.core import read_py_config
    from tpudet3d_torch.infer.build import build_detector
    from tpudet3d_torch.models import build_model
    from tpudet3d_torch.utils.checkpoint import save_converted

    def weights(module):
        return {k: v.detach().clone() for k, v in module.state_dict().items()
                if not k.endswith('num_batches_tracked')}

    gen = torch.Generator().manual_seed(6)
    det = build_detector(cascade=True, generator=gen)
    reg = build_model(read_py_config(EL0_CONFIG), generator=gen)
    params = weights(reg)
    ema = {k: v if 'running_' in k else v + 0.01 * torch.randn(
        v.shape, generator=gen) for k, v in params.items()}
    paths = {}
    for kind, sd, extra in (('detector', weights(det), None),
                            ('regressor', params, ema)):
        os.makedirs(os.path.join(root, kind))
        paths[kind] = save_converted(os.path.join(root, kind, 'snap_3.pt'),
                                     kind, 3, sd, extra)
    return paths, det, reg, params, ema


def max_leaf_err(a, b):
    """Largest leaf-wise |a - b| / max(|b|, 1e-3) (JAX's bound's measure)
    and its leaf."""
    return max((float(((a[k].double() - b[k].double()).abs()
                       / b[k].double().abs().clamp(min=1e-3)).max()), k)
               for k in b)


def update_err(a, b, start, keys=None):
    """|Δa − Δb| / |Δb| over the tensors ``keys`` (all), Δ the move from
    ``start``: the distance of two updates, whatever the learning rate."""
    keys = list(b) if keys is None else keys
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum())
              for k in keys)
    den = sum(float(((b[k].double() - start[k].double()) ** 2).sum())
              for k in keys)
    return (num / max(den, 1e-300)) ** 0.5
