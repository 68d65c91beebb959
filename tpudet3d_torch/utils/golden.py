"""The golden record of the JAX package's bf16 and int8 product route: the
half that needs no JAX.

``tests/torch_port_golden.py`` runs the JAX package on the CPU and writes
``tests/fixtures/torch_port_golden/`` (``manifest.json`` and
``golden.npz``); ``chip_smoke.py`` phase 12 holds the port on the card
against it.  Both sides make every input with the functions here, from
numpy's ``RandomState`` (whose streams numpy keeps fixed), so a machine
without JAX remakes the generator's weights, frames and training items
bit for bit from the manifest alone:

* weights (:func:`remake_variables`): Flax-named numpy trees, every leaf
  drawn in the manifest's leaf order by its kind (:func:`draw_leaf`), the
  batch norms' running statistics then replaced by the record's (the
  generator calibrates them on the frames, so that the random networks
  stay in range); load them with ``utils/convert.py``'s
  ``load_jax_variables``;
* frames (:func:`golden_frames`) and the rectangles planted in them
  (:func:`golden_boxes`), regressor items (:func:`regressor_items`) and
  detector items (:func:`detector_items`);
* the CountSketch of a gradient or an update in the Flax layout
  (:func:`flax_vector`, :func:`count_sketch`).

The rules compare the port's value ``p`` with JAX's bf16 value ``j``; the
yardstick is JAX's own bf16 against its float32 for the same value, ``y =
|j - j_f32|`` (for int8: JAX's int8 against its bf16; for the float32
training gates: JAX's float32 against its float64).  Two independent
roundings of one result part by about √2·y, hence the factor 2
(:data:`FACTOR`):

* :func:`continuous_rule`: mean |p - j| ≤ 2·mean y and every |p - j| ≤
  2·max y + one bf16 ulp of |j|;
* :func:`sketch_rule`: ‖S(p - j)‖ ≤ 2·‖S(j - j_f32)‖ + 0.01·‖S j‖;
* :func:`dets_rule`: K3's detections on JAX's own detector outputs
  paired with JAX's decode of them by box IoU > 0.9, at least ¾ paired,
  classes equal, boxes and scores within a bf16 ulp;
* :func:`rows_rule`: engine rows against JAX's, held on the rows JAX
  decides (those its own bf16 and yardstick rows pair on, with equal
  labels).  Gated on the engine's second stage run on JAX's detections,
  where every row pairs; reported for the free-running engine: with
  random weights the detector's top scores lie on a plateau of
  neighbouring anchors, where K3's ranking and suppression follow the
  last bits, and JAX's own bf16 and float32 rows pair on 19 and 13 of 32
  at full width.  Trained classification heads do not decide them
  either (``tests/torch_port_heads_probe.py``): the random backbone's
  features carry their spatial signal at 33–48 times JAX's own bf16
  noise, and heads that separate the rectangles amplify both.

The drivers run the record's cases on a device and apply the rules:
:func:`golden_serving` (cases A and B, bf16, and their int8 half C),
:func:`golden_regressor_step` (D) and :func:`golden_detector_step` (E),
each returning its rules and each run's kernel launches
(``utils/profiling.py`` ``drive``).  ``chip_smoke.py`` phase 12 runs them
on the card and ``tests/test_torch_port_golden.py`` on the CPU.

This module is testing support: it imports numpy, torch and the port's
own modules, and nothing of JAX or of the JAX package.
"""

import hashlib
import json
import os.path as osp

import numpy as np
import torch

from .profiling import drive, drive_replay

__all__ = ['FACTOR', 'SLACK', 'MATCH_IOU', 'MATCH_SHARE', 'BUCKETS',
           'VAR_FLOOR', 'FIXTURE', 'load_golden', 'digest', 'tree_digest',
           'leaf_kind', 'draw_leaf', 'remake_variables', 'golden_frames',
           'golden_boxes', 'regressor_items', 'detector_items', 'sketch_hash',
           'count_sketch', 'flax_vector', 'leaf_norms', 'bf16_ulp',
           'continuous_rule', 'sketch_rule', 'match_rows', 'rows_rule',
           'dets_rule', 'pack_rows', 'unpack_rows', 'GOLDEN_REPORTED',
           'GOLDEN_GATED_GRADS', 'GOLDEN_NEXT', 'golden_inputs',
           'golden_variables', 'golden_module', 'golden_engine',
           'golden_dets', 'golden_scales_err', 'golden_regress',
           'golden_serving', 'golden_regressor_step', 'golden_regressor_run',
           'golden_detector_step', 'golden_detector_fixed',
           'golden_grad_rules', 'golden_step_report']

FACTOR = 2.0          # the port within twice JAX's own bf16 noise
SLACK = 0.01          # of the reference's sketch norm (gradients)
MATCH_IOU = 0.9       # a port row pairs with a JAX row above this IoU
MATCH_SHARE = 0.75    # the share of rows that must pair
BUCKETS = 4096        # CountSketch buckets
VAR_FLOOR = 1.0       # added to each calibrated batch-norm variance

FIXTURE = osp.join('tests', 'fixtures', 'torch_port_golden')


def load_golden(root):
    """``(manifest, arrays)`` of the fixture under ``root``."""
    with open(osp.join(root, 'manifest.json')) as f:
        manifest = json.load(f)
    with np.load(osp.join(root, 'golden.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def digest(*arrays):
    """sha256 over the arrays' dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f'{a.dtype.str}{a.shape}'.encode())
        h.update(a.tobytes())
    return h.hexdigest()


def tree_digest(tree):
    """:func:`digest` of a nested dict's leaves, in sorted key order."""
    def leaves(node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                yield from leaves(node[k])
            else:
                yield node[k]
    return digest(*leaves(tree))


# --- weights ---------------------------------------------------------------

def leaf_kind(collection, path, shape):
    """The draw of a Flax leaf: ``conv`` and ``dense`` kernels (``dense``
    also for the heads' ``[9, C, 18]`` kernel, fan-in C), ``scale``,
    ``bias`` (``head_bias`` too), ``mean``, ``var``."""
    name = path[-1]
    if collection == 'batch_stats' and name in ('mean', 'var'):
        return name
    if collection == 'params':
        if name == 'kernel':
            return 'conv' if len(shape) == 4 else 'dense'
        if name == 'head_kernel':
            return 'dense'
        if name in ('bias', 'head_bias'):
            return 'bias'
        if name == 'scale':
            return 'scale'
    raise ValueError(f'no draw for {collection}/{"/".join(path)}')


def _fan_in(kind, shape):
    if kind == 'conv':                      # [kh, kw, I/g, O]
        return shape[0] * shape[1] * shape[2]
    return shape[-2]                        # [I, O] or [9, C, 18]


def draw_leaf(rng, kind, shape):
    """One leaf from ``rng``: conv kernels N(0, √(2/fan_in)), dense kernels
    N(0, 1/√fan_in), scale and var U(0.5, 1.5), bias and mean N(0, 0.1);
    float32."""
    shape = tuple(shape)
    if kind == 'conv':
        v = rng.normal(0.0, np.sqrt(2.0 / _fan_in(kind, shape)), shape)
    elif kind == 'dense':
        v = rng.normal(0.0, 1.0 / np.sqrt(_fan_in(kind, shape)), shape)
    elif kind in ('scale', 'var'):
        v = rng.uniform(0.5, 1.5, shape)
    elif kind in ('bias', 'mean'):
        v = rng.normal(0.0, 0.1, shape)
    else:
        raise ValueError(f'unknown leaf kind {kind}')
    return v.astype(np.float32)


def remake_variables(leaves, seed, stats=None):
    """``{'params': ..., 'batch_stats': ...}`` numpy trees from the
    manifest's ``leaves`` (``[collection, path, shape, kind]`` in order),
    each drawn from one ``RandomState(seed)`` in that order; with
    ``stats`` (the record's calibrated statistics, the ``batch_stats``
    leaves flattened in that order) the running statistics are those."""
    rng = np.random.RandomState(seed)
    out, i = {}, 0
    for collection, path, shape, kind in leaves:
        node = out.setdefault(collection, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaf = draw_leaf(rng, kind, shape)
        if stats is not None and collection == 'batch_stats':
            n = leaf.size
            leaf = np.asarray(stats[i:i + n], np.float32).reshape(shape)
            i += n
        node[path[-1]] = leaf
    if stats is not None and i != len(stats):
        raise ValueError(f'{len(stats)} statistics for {i} values')
    return out


# --- inputs ----------------------------------------------------------------

def _frame_draws(n, h, w, seed):
    """The frames of :func:`golden_frames` and each frame's rectangles
    ``[k, 7]`` (x0, y0, x1, y1 pixels, then the BGR fill), in draw
    order."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, (n, -(-h // 16), -(-w // 16), 3))
    frames = np.repeat(np.repeat(cells, 16, 1), 16, 2)[:, :h, :w]
    frames = frames + rng.randint(-12, 13, frames.shape)
    rects = []
    for f in frames:
        drawn = []
        for _ in range(rng.randint(3, 6)):
            bh, bw = rng.randint(h // 8, h // 2), rng.randint(w // 8, w // 2)
            y0, x0 = rng.randint(0, h - bh), rng.randint(0, w - bw)
            fill = rng.randint(0, 256, 3)
            f[y0:y0 + bh, x0:x0 + bw] = fill
            drawn.append([x0, y0, x0 + bw, y0 + bh, *fill])
        rects.append(np.asarray(drawn, np.int64))
    return np.clip(frames, 0, 255).astype(np.uint8), rects


def golden_frames(n, h, w, seed):
    """``[n,h,w,3]`` uint8 BGR frames: a blocky background of 16-pixel
    cells with noise on it, and 3 to 5 filled rectangles each, drawn by
    numpy slicing."""
    return _frame_draws(n, h, w, seed)[0]


def golden_boxes(n, h, w, seed):
    """The rectangles planted in :func:`golden_frames` as detection ground
    truth, from the same draws: ``boxes [n, 5, 4]`` (xyxy pixels of the
    frame, float32), ``labels [n, 5]`` (int64: the fill's brightness,
    ``sum(BGR)`` in nine equal bins) and ``valid [n, 5]`` (a frame has 3 to
    5).  A later rectangle may cover part of an earlier one; both stay."""
    rects = _frame_draws(n, h, w, seed)[1]
    boxes = np.zeros((n, 5, 4), np.float32)
    labels = np.zeros((n, 5), np.int64)
    valid = np.zeros((n, 5), bool)
    for i, r in enumerate(rects):
        boxes[i, :len(r)] = r[:, :4]
        labels[i, :len(r)] = r[:, 4:].sum(1) * 9 // (3 * 256)
        valid[i, :len(r)] = True
    return boxes, labels, valid


def _box_keypoints(rng):
    """Objectron's 9 keypoints (centre, corners in ±e1±e2±e3 order) of a
    random oriented box 1.5-3 m in front of the default camera,
    projected as portrait frames are, in [0, 1]; None if it leaves."""
    from ..ops import geometry
    a = rng.uniform(-np.pi, np.pi, 3)
    c, s = np.cos(a), np.sin(a)
    rot = (np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
           @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
           @ np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]]))
    center = np.r_[rng.uniform(-0.4, 0.4, 2), rng.uniform(-3, -1.5)]
    half = rng.uniform(0.1, 0.5, 3)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], float)
    box = np.concatenate([[center], corners * half @ rot.T + center])
    cam = geometry.convert_camera_matrix_2_ndc(
        geometry.get_default_camera_matrix())
    uv = geometry.project_3d_points(box, cam)
    xy = np.stack([(uv[:, 1] + 1) / 2, (uv[:, 0] + 1) / 2], -1)
    return xy if xy.min() >= 0.0 and xy.max() <= 1.0 else None


def regressor_items(n, size, seed):
    """A regressor batch: normalised NHWC float32 noise images ``[n, size,
    size, 3]``, the keypoints ``[n,9,2]`` of projected boxes and classes
    ``[n]`` (int64)."""
    rng = np.random.RandomState(seed)
    imgs = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    cats = rng.randint(0, 9, n).astype(np.int64)
    kp = []
    while len(kp) < n:
        xy = _box_keypoints(rng)
        if xy is not None:
            kp.append(xy)
    return imgs, np.stack(kp).astype(np.float32), cats


def detector_items(n, size, boxes, seed):
    """A detector batch: images ``[n, size, size, 3]`` in [0, 1], ground
    truth boxes ``[n, boxes, 4]`` (xyxy pixels, sides 0.1-0.7 of the
    image), labels ``[n, boxes]`` (int64) and ``valid [n, boxes]`` (the
    last quarter of each image's rows invalid)."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    wh = rng.uniform(0.1, 0.7, (n, boxes, 2)) * size
    xy = rng.uniform(0, 1, (n, boxes, 2)) * (size - wh)
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, 9, (n, boxes)).astype(np.int64)
    valid = np.ones((n, boxes), bool)
    valid[:, boxes - boxes // 4:] = False
    return imgs, gt, labels, valid


# --- sketches --------------------------------------------------------------

def sketch_hash(n, seed, buckets=BUCKETS):
    """Each of ``n`` flat coordinates' bucket and sign, from
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    bucket = rng.randint(0, buckets, n)
    sign = rng.randint(0, 2, n) * 2.0 - 1.0
    return bucket, sign


def count_sketch(vec, hashed, buckets=BUCKETS):
    """The CountSketch of a flat vector (float64)."""
    bucket, sign = hashed
    return np.bincount(bucket, weights=sign * np.asarray(vec, np.float64),
                       minlength=buckets)


_PORT_LEAF = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
              'head_kernel': 'head_kernel', 'head_bias': 'head_bias'}


def _to_flax(t, name, flax_shape):
    a = t.detach().float().cpu().numpy()
    if name == 'kernel' and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)                 # [O,I,kh,kw] → HWIO
    elif name == 'kernel' and a.ndim == 2:
        a = a.T                                     # [O,I] → [I,O]
    if a.shape != tuple(flax_shape):
        raise ValueError(f'{a.shape} does not lay out as {flax_shape}')
    return a


def flax_vector(named, leaves):
    """The ``params`` leaves of ``named`` (port name → tensor, e.g. each
    parameter's gradient) in the Flax layout, flattened and concatenated
    in the manifest's leaf order (float32)."""
    parts = []
    for collection, path, shape, _ in leaves:
        if collection != 'params':
            continue
        key = '.'.join(list(path[:-1]) + [_PORT_LEAF[path[-1]]])
        parts.append(_to_flax(named[key], path[-1], shape).ravel())
    return np.concatenate(parts)


def leaf_norms(vec, leaves):
    """Each ``params`` leaf's L2 norm inside a flat vector from
    :func:`flax_vector`."""
    out, i = [], 0
    for collection, _, shape, _ in leaves:
        if collection != 'params':
            continue
        n = int(np.prod(shape))
        out.append(float(np.linalg.norm(np.asarray(vec[i:i + n],
                                                   np.float64))))
        i += n
    return np.asarray(out)


# --- the rules -------------------------------------------------------------

def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits; 0 at 0)."""
    a = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def _f64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def continuous_rule(p, j, j_ref, factor=FACTOR):
    """The port's ``p`` against JAX's ``j`` with JAX's ``|j - j_ref|`` as
    the yardstick; returns the numbers and ``ok``."""
    p, j, j_ref = _f64(p), _f64(j), _f64(j_ref)
    if p.shape != j.shape or j.shape != j_ref.shape:
        raise ValueError(f'shapes {p.shape}, {j.shape}, {j_ref.shape}')
    err, y = np.abs(p - j), np.abs(j - j_ref)
    if err.size == 0:
        return dict(n=0, mean_err=0.0, mean_y=0.0, max_err=0.0, max_y=0.0,
                    ok=True)
    finite = bool(np.isfinite(p).all())
    res = dict(n=int(err.size), mean_err=float(err.mean()),
               mean_y=float(y.mean()), max_err=float(err.max()),
               max_y=float(y.max()))
    res['ok'] = bool(
        finite and res['mean_err'] <= factor * res['mean_y']
        and np.all(err - bf16_ulp(j) <= factor * res['max_y']))
    return res


def sketch_rule(sp, sj, sj_ref, factor=FACTOR, slack=SLACK):
    """‖S(p) - S(j)‖ ≤ factor·‖S(j) - S(j_ref)‖ + slack·‖S(j)‖."""
    sp, sj, sj_ref = _f64(sp), _f64(sj), _f64(sj_ref)
    res = dict(err=float(np.linalg.norm(sp - sj)),
               yardstick=float(np.linalg.norm(sj - sj_ref)),
               norm=float(np.linalg.norm(sj)))
    res['ok'] = bool(np.isfinite(sp).all() and res['err'] <= factor
                     * res['yardstick'] + slack * res['norm'])
    return res


def pack_rows(results, max_det):
    """Engine results (one dict a frame) → ``[N, max_det, 25]`` float32
    rows (box 4, score, det_label, keypoints 18, label), NaN past each
    frame's rows."""
    out = np.full((len(results), max_det, 25), np.nan, np.float32)
    for i, r in enumerate(results):
        n = len(r['scores'])
        out[i, :n] = np.concatenate([
            r['boxes'], r['scores'][:, None], r['det_labels'][:, None],
            np.asarray(r['kp']).reshape(n, 18), r['labels'][:, None]], -1)
    return out


def unpack_rows(rows):
    """Inverse of :func:`pack_rows`: one dict a frame."""
    out = []
    for r in rows:
        r = r[~np.isnan(r[:, 4])]
        out.append(dict(boxes=r[:, :4], scores=r[:, 4],
                        det_labels=r[:, 5].astype(np.int64),
                        kp=r[:, 6:24].reshape(-1, 9, 2),
                        labels=r[:, 24].astype(np.int64)))
    return out


def _box_iou(a, b):
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)  # noqa: E731
    union = area(a)[:, None] + area(b)[None] - inter
    return inter / np.maximum(union, 1e-12)


def match_rows(a, b, iou_thr=MATCH_IOU):
    """Pairs ``(i, k)`` of frame rows ``a`` and ``b`` (dicts), one to one:
    each row of ``a`` in order takes the unpaired row of ``b`` above
    ``iou_thr`` with its own detector class if there is one (K3 keeps a
    box once per class), else the one of highest IoU."""
    iou = _box_iou(np.asarray(a['boxes'], np.float64),
                   np.asarray(b['boxes'], np.float64))
    used, pairs = set(), []
    for i in range(len(a['scores'])):
        cand = [k for k in range(len(b['scores']))
                if k not in used and iou[i, k] > iou_thr]
        if not cand:
            continue
        same = [k for k in cand if b['det_labels'][k] == a['det_labels'][i]]
        k = max(same or cand, key=lambda k: iou[i, k])
        used.add(k)
        pairs.append((i, k))
    return pairs


def rows_rule(port, jax_rows, jax_ref, factor=FACTOR, share=MATCH_SHARE):
    """The engine's rows (one dict a frame) against JAX's, with JAX's
    ``jax_ref`` rows as the yardstick.  The rows held are those JAX
    decides: a JAX row that pairs with a row of its own yardstick with
    both labels equal.  A row that JAX's own rounding moves (random
    weights leave the detector's top scores on a plateau of neighbouring
    anchors, where K3's ranking and suppression follow the last bits) is
    counted, not held.  At least ``share`` of the decided rows must pair
    with the port's, labels equal on those pairs, and their scores and
    keypoints under :func:`continuous_rule`."""
    n_rows = n_decided = n_paired = 0
    labels_equal = True
    vals = {'scores': ([], [], []), 'kp': ([], [], [])}
    same = lambda a, i, b, k: bool(  # noqa: E731
        a['det_labels'][i] == b['det_labels'][k]
        and a['labels'][i] == b['labels'][k])
    for p, j, r in zip(port, jax_rows, jax_ref):
        decided = {k: kr for k, kr in match_rows(j, r) if same(j, k, r, kr)}
        n_rows += len(j['scores'])
        n_decided += len(decided)
        for i, k in match_rows(p, j):
            if k not in decided:
                continue
            n_paired += 1
            labels_equal &= same(p, i, j, k)
            for key, (a, b, c) in vals.items():
                a.append(np.asarray(p[key][i], np.float64).ravel())
                b.append(np.asarray(j[key][k], np.float64).ravel())
                c.append(np.asarray(r[key][decided[k]], np.float64).ravel())
    res = dict(rows=n_rows, decided=n_decided, paired=n_paired,
               labels_equal=labels_equal,
               share_ok=bool(n_decided > 0
                             and n_paired >= share * n_decided))
    for key, (a, b, c) in vals.items():
        res[key] = continuous_rule(*(np.concatenate(v) if v else
                                     np.zeros(0) for v in (a, b, c)),
                                   factor=factor)
    res['ok'] = bool(res['share_ok'] and labels_equal and res['scores']['ok']
                     and res['kp']['ok'])
    return res


def dets_rule(port, ref, share=MATCH_SHARE):
    """K3's detections ``[N, K, 6]`` (box, score, class; score 0 pads) on
    one input against JAX's decode of it: the matched-rows rule over every
    row, the class equal on each pair (:func:`match_rows` prefers it), the
    boxes and scores within a bf16 ulp of JAX's (one decode in float32:
    rounding only)."""
    port, ref = _f64(port), _f64(ref)
    n_rows = n_paired = 0
    labels_equal = True
    got, want = [], []
    for p, r in zip(port, ref):
        p, r = p[p[:, 4] > 0], r[r[:, 4] > 0]
        rows = [dict(boxes=d[:, :4], scores=d[:, 4], det_labels=d[:, 5])
                for d in (p, r)]
        n_rows += max(len(p), len(r))
        for i, k in match_rows(*rows):
            n_paired += 1
            labels_equal &= bool(p[i, 5] == r[k, 5])
            got.append(p[i, :5])
            want.append(r[k, :5])
    p, r = (np.concatenate(v) if v else np.zeros(0) for v in (got, want))
    err = np.abs(p - r)
    res = dict(rows=n_rows, paired=n_paired, labels_equal=labels_equal,
               max_err=float(err.max()) if err.size else 0.0,
               within_ulp=bool(np.all(err <= bf16_ulp(r))))
    res['ok'] = bool(n_rows > 0 and n_paired >= share * n_rows
                     and labels_equal and res['within_ulp'])
    return res


# The record's cases driven on a device (``chip_smoke.py`` phase 12 on the
# card, tests/test_torch_port_golden.py on the CPU): each remakes its
# inputs, runs the port, and holds each output by the rules above.  On the
# card, ``count`` also holds each run's kernel launches to the path's own.

# reported, not gated: the free-running engine's rows (random weights
# leave the detector's top scores on a plateau, where JAX's own bf16 and
# float32 rows part; trained heads part them further,
# tests/torch_port_heads_probe.py), the port's calibration on its own
# detections (crops of other boxes where the rows part), and JAX's
# calibration with its crops in float32 beside its own in bf16 (the size
# of that cast)
GOLDEN_REPORTED = ('rows', 'scales', 'jax_f32_crops_vs_bf16_crops')


def golden_inputs(manifest):
    """The frames, remade and checked against the manifest's digest."""
    fr = manifest['frames']
    frames = golden_frames(fr['n'], fr['h'], fr['w'], fr['seed'])
    if digest(frames) != fr['sha256']:
        raise RuntimeError('the golden frames are not remade bit for bit')
    return frames


def golden_variables(spec, arrays):
    """A model's Flax-named numpy variables, remade with the record's
    calibrated statistics and checked."""
    v = remake_variables(spec['leaves'], spec['seed'],
                                arrays[spec['stats']])
    if tree_digest(v) != spec['sha256']:
        raise RuntimeError(f'the golden weights of {spec["source"]} are not '
                           'remade bit for bit')
    return v


def golden_module(spec, dtype, arrays):
    """The port's module of a manifest model, float32 parameters, compute
    in ``dtype``, the remade weights loaded."""
    from ..core import AttrDict
    from ..detect import SSDDetector
    from ..models import build_model
    from .convert import load_jax_variables
    if spec['kind'] == 'detector':
        module = SSDDetector(num_classes=9, width_mult=spec['width_mult'],
                             dtype=dtype, cascade=spec['cascade'])
    else:
        module = build_model(AttrDict(model=dict(
            name=spec['name'], num_classes=9, bf16=False)), dtype=dtype)
    return load_jax_variables(module, golden_variables(spec, arrays))


def golden_engine(manifest, arrays, case, dev, scales=None):
    from ..infer import EngineConfig, TwoStageEngine
    s = manifest['serving'][case]
    kw = dict(manifest['engine'], crop_size=tuple(
        manifest['engine']['crop_size']), expand_ratio=tuple(
        manifest['engine']['expand_ratio']))
    if scales is not None:
        kw.update(det_int8_scales=scales['det'], reg_int8_scales=scales['reg'])
    models = manifest['models']
    return TwoStageEngine(
        golden_module(models[s['detector']], torch.bfloat16, arrays).eval(),
        golden_module(models[s['regressor']], torch.bfloat16,
                      arrays).eval(),
        EngineConfig(**kw), device=dev)


def golden_dets(engine, logits, deltas, ref, wrappers):
    """K3 through the engine's decode settings on JAX's detector outputs,
    against JAX's decode of them; ``(rule, launches)``."""
    from ..detect import decode_detections
    lg, dl = (torch.from_numpy(x).to(engine.device) for x in (logits, deltas))
    dets, launches = drive(wrappers, lambda: decode_detections(
        lg, dl, engine.anchors, **engine.decode_kwargs()))
    return dets_rule(dets, ref), launches


def golden_scales_err(got, ref, ref_f32):
    """Calibrated scales (``{'det': ..., 'reg': ...}``) against JAX's, with
    JAX's float32 build's scales as the yardstick; ``ok`` when both stages
    meet the rule."""
    out = {}
    for stage in ('det', 'reg'):
        keys = sorted(ref[stage])
        if sorted(got[stage]) != keys:
            raise RuntimeError(f'calibrated {stage} convs differ from the '
                               'JAX package\'s')
        out[stage] = continuous_rule(
            [got[stage][k] for k in keys], [ref[stage][k] for k in keys],
            [ref_f32[stage][k] for k in keys])
        # the conv of the largest error, and the stem's (the conv that
        # takes the model's input: first in sorted order in every model)
        worst = max(keys, key=lambda k: abs(got[stage][k] - ref[stage][k]))
        for name, k in (('worst', worst), ('stem', keys[0])):
            out[stage][name] = dict(conv=k, got=got[stage][k],
                                    jax=ref[stage][k],
                                    jax_f32=ref_f32[stage][k])
    out['ok'] = out['det']['ok'] and out['reg']['ok']
    return out


def golden_regress(engine, frames, dets, wrappers):
    """The engine's second stage (crop boxes, refine passes, heads, K4's
    packing) on the detections ``dets [N,max_det,6]``, as ``infer_batch``
    unpacks it: ``(rows, launches)``."""
    from ..infer.engine import _unpack, upload
    n, h, w = frames.shape[:3]
    up = upload(frames, engine.device)
    d = torch.from_numpy(dets).to(engine.device)
    packed, launches = drive(wrappers, lambda: engine._regress(
        up, d, engine._crop_boxes(d, h, w, engine.cfg.crop_margin_px), h,
        w, engine.cfg.refine_margin_px))
    packed = packed.cpu().numpy()
    return [_unpack(p[np.nonzero(p[:, 25] > 0)[0]]) for p in packed], \
        launches


def golden_serving(manifest, arrays, case, dev, wrappers, count):
    """Cases A/B and their int8 half (C) on ``dev``: the engine's rows,
    the detector's logits and deltas and the regressor's outputs on the
    JAX engine's crop boxes, bf16 and int8, against the record."""
    from ..infer.engine import upload
    from ..infer.quant import calibrate_engine
    frames = golden_inputs(manifest)
    n, h, w = frames.shape[:3]
    boxes = torch.from_numpy(arrays[f'{case}/boxes']).to(dev)
    a = {k: arrays[f'{case}/{k}'] for k in (
        'bf16/rows', 'f32/rows', 'bf16/det_logits', 'f32/det_logits',
        'bf16/det_deltas', 'f32/det_deltas', 'bf16/pre', 'f32/pre',
        'bf16/cls', 'f32/cls')}
    res, launches = {}, {}

    def outputs(engine, what):
        rows, launches[f'{case} {what} infer_batch'] = drive_replay(
            wrappers, lambda: engine.infer_batch(frames))
        up = upload(frames, dev)
        (_, logits, deltas, _, _), launches[f'{case} {what} detect'] = \
            drive(wrappers, lambda: engine._detect(
                up, h, w, engine.cfg.crop_margin_px))
        with torch.no_grad():
            (pre, cls), launches[f'{case} {what} heads'] = drive(
                wrappers, lambda: engine._heads(up, boxes))
        return rows, logits, deltas, pre, cls

    engine = golden_engine(manifest, arrays, case, dev)
    rows, logits, deltas, pre, cls = outputs(engine, 'bf16')
    rule = continuous_rule
    res['det_logits'] = rule(logits, a['bf16/det_logits'],
                             a['f32/det_logits'])
    res['det_deltas'] = rule(deltas, a['bf16/det_deltas'],
                             a['f32/det_deltas'])
    res['pre'] = rule(pre, a['bf16/pre'], a['f32/pre'])
    res['cls'] = rule(cls, a['bf16/cls'], a['f32/cls'])
    res['rows'] = rows_rule(rows, unpack_rows(a['bf16/rows']),
                                   unpack_rows(a['f32/rows']))
    # K3, the engine's own decode stage, on JAX's detector outputs
    res['dets'], launches[f'{case} bf16 decode'] = golden_dets(
        engine, a['bf16/det_logits'], a['bf16/det_deltas'],
        arrays[f'{case}/bf16/dets'], wrappers)
    # the second stage on JAX's detections: every row pairs
    dets = arrays[f'{case}/bf16/dets']
    regress, launches[f'{case} bf16 regress'] = golden_regress(
        engine, frames, dets, wrappers)
    res['regress_rows'] = rows_rule(
        regress, unpack_rows(arrays[f'{case}/bf16/regress_rows']),
        unpack_rows(arrays[f'{case}/f32/regress_rows']))

    # int8: the port's calibration on the detections JAX's calibration
    # cropped, against JAX's scales (gated); JAX's own with its crops in
    # float32, as the port crops, beside them (the size of that cast) and
    # the port's calibration on its own detections (both reported); then
    # JAX's scales served
    ref = manifest['int8'][case]
    scales, launches[f'{case} calibrate'] = drive(
        wrappers, lambda: calibrate_engine(engine, frames))
    on_jax = calibrate_engine(engine, frames,
                              dets=list(arrays[f'C/{case}/calib_dets']))
    int8 = dict(scales_on_jax_dets=golden_scales_err(
        dict(zip(('det', 'reg'), on_jax)), ref['bf16'], ref['f32']))
    int8['jax_f32_crops_vs_bf16_crops'] = golden_scales_err(
        ref['bf16_f32_crops'], ref['bf16'], ref['f32'])
    int8['scales'] = golden_scales_err(dict(zip(('det', 'reg'), scales)),
                                       ref['bf16'], ref['f32'])
    q = golden_engine(manifest, arrays, case, dev, ref['bf16'])
    rows8, logits8, deltas8, pre8, cls8 = outputs(q, 'int8')
    c = {k: arrays[f'C/{case}/{k}'] for k in (
        'rows', 'pre', 'cls', 'det_logits', 'det_deltas')}
    int8['det_logits'] = rule(logits8, c['det_logits'],
                              a['bf16/det_logits'])
    int8['det_deltas'] = rule(deltas8, c['det_deltas'],
                              a['bf16/det_deltas'])
    int8['pre'] = rule(pre8, c['pre'], a['bf16/pre'])
    int8['cls'] = rule(cls8, c['cls'], a['bf16/cls'])
    int8['rows'] = rows_rule(rows8, unpack_rows(c['rows']),
                                    unpack_rows(a['bf16/rows']))
    int8['dets'], launches[f'{case} int8 decode'] = golden_dets(
        q, c['det_logits'], c['det_deltas'], arrays[f'C/{case}/dets'],
        wrappers)
    regress8, launches[f'{case} int8 regress'] = golden_regress(
        q, frames, dets, wrappers)
    int8['regress_rows'] = rows_rule(
        regress8, unpack_rows(arrays[f'C/{case}/regress_rows']),
        unpack_rows(arrays[f'{case}/bf16/regress_rows']))
    if count:
        from ..infer import quant
        n_det = len(quant.quantized_conv_paths(q.det_model))
        n_reg = len(quant.quantized_conv_paths(q.reg_model))
        with_rows = sum(len(r['scores']) > 0 for r in rows)
        passes = int(q.cfg.refine_passes) + 1
        want = {'bf16 infer_batch': [1, passes, 1, passes, 0, 0, 0],
                'bf16 decode': [0, 0, 1, 0, 0, 0, 0],
                'int8 decode': [0, 0, 1, 0, 0, 0, 0],
                'bf16 detect': [1, 0, 1, 0, 0, 0, 0],
                'bf16 heads': [0, 1, 0, 0, 0, 0, 0],
                'bf16 regress': [0, passes, 0, passes, 0, 0, 0],
                'calibrate': [n, with_rows, 1, 0, 0, 0, 0],
                'int8 infer_batch': [1, passes, 1, passes, 0,
                                     n_det + passes * n_reg,
                                     n_det + passes * n_reg],
                'int8 detect': [1, 0, 1, 0, 0, n_det, n_det],
                'int8 heads': [0, 1, 0, 0, 0, n_reg, n_reg],
                'int8 regress': [0, passes, 0, passes, 0, passes * n_reg,
                                 passes * n_reg]}
        for run, n_k in want.items():
            if launches[f'{case} {run}'] != n_k:
                raise RuntimeError(f'phase 12 {case} {run}: launches '
                                   f'{launches[f"{case} {run}"]}, the '
                                   f'path\'s own {n_k}')
    return res, int8, launches


def golden_regressor_step(manifest, arrays, case, dev, wrappers, count):
    """Case D on ``dev``: the eval step's sums with the IoU on the initial
    state, then one train step (``tpudet3d_torch.train``) in bf16 and one
    in float32.  Returns the rules, the launches and the port's flat
    gradients by record key."""
    spec = manifest['train'][case]
    mspec = manifest['models'][spec['model']]
    items = regressor_items(spec['batch'], spec['size'],
                                   spec['items_seed'])
    if digest(*items) != spec['sha256']:
        raise RuntimeError(f'the items of case {case} are not remade bit '
                           'for bit')
    batch = [torch.from_numpy(x).to(dev) for x in items]
    res, launches, grads = {}, {}, {}
    for prec, dtype in (('bf16', torch.bfloat16), ('f32', torch.float32)):
        terms, grads[f'{prec}/grad'], update, n, sums = golden_regressor_run(
            spec, mspec, arrays, batch, dtype, dev, wrappers, prec == 'bf16')
        launches.update({f'{case} {prec} {k}': v for k, v in n.items()})
        if prec == 'bf16':
            res.update(golden_step_report(arrays, case, mspec['leaves'],
                                          spec['sketch_seed'], terms,
                                          grads['bf16/grad'], update))
            got = torch.stack([x.double().cpu() for x in sums]).numpy()
            ref = arrays[f'{case}/bf16/eval']
            ref32 = arrays[f'{case}/f32/eval']
            res['eval'] = continuous_rule(got[:3], ref[:3], ref32[:3])
            res['eval_counts_equal'] = bool(np.array_equal(got[4], ref[4]))
            res['eval_acc'] = dict(port=got[3].tolist(), jax=ref[3].tolist(),
                                   jax_f32=ref32[3].tolist())
        else:
            res['f32_terms'] = continuous_rule(
                terms[1:4], arrays[f'{case}/f32/terms'][1:4],
                arrays[f'{case}/f64/terms'])
    res.update(golden_grad_rules(arrays, case, mspec['leaves'],
                                 spec['sketch_seed'], grads))
    if count:
        want = {'bf16 eval': [0, 0, 0, 0, 1, 0, 0]}
        for k, v in launches.items():
            if v != want.get(k[len(case) + 1:], [0] * 7):
                raise RuntimeError(f'phase 12 {k}: launches {v}; the '
                                   'path\'s own: one K5 in the eval step')
    res['ok'] = bool(res['grads_ok'] and res['eval']['ok']
                     and res['eval_counts_equal'])
    return res, launches, grads


def golden_regressor_run(spec, mspec, arrays, batch, dtype, dev, wrappers,
                         evaluate):
    """One train step of case D's regressor computing in ``dtype`` (and,
    with ``evaluate``, the eval step before it): the loss terms, the flat
    gradient and update (Flax layout), the launches of each call and the
    eval step's sums."""
    from ..core import read_py_config
    from ..losses import LossManager, build_loss
    from ..train import (build_optimizer, create_train_state,
                         make_eval_step, make_train_step)
    cfg = read_py_config(spec['config'])
    imgs, kp, cats = batch
    model = golden_module(mspec, dtype, arrays)
    model.dropout_rate = spec['dropout']
    terms = []

    def recorded(fn):
        def crit(*args):
            out = fn(*args)
            terms.append(out.detach())
            return out
        return crit

    lm = LossManager(tuple([recorded(f) for f in group]
                           for group in build_loss(cfg)), cfg.loss.coeffs,
                     cfg.loss.alwa)
    opt = build_optimizer(cfg, model.parameters())
    state = create_train_state(model, opt, lm, ema_decay=0.0, device=dev)
    launches, sums = {}, None
    if evaluate:
        (sums, _), launches['eval'] = drive(
            wrappers, lambda: make_eval_step(model)(None, imgs, kp, cats,
                                                    compute_iou=True))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_train_step(model, lm, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    (state, metrics), launches['step'] = drive(
        wrappers, lambda: step(state, imgs, kp, cats, gen))
    m = metrics.double().cpu()
    got_terms = torch.cat([m[:1], torch.stack(terms).double().cpu(),
                           m[1:3]]).numpy()
    named = dict(model.named_parameters())
    leaves = mspec['leaves']
    return (got_terms,
            flax_vector({k: p.grad for k, p in named.items()},
                               leaves),
            flax_vector({k: p.detach() - before[k]
                                for k, p in named.items()}, leaves),
            launches, sums)


def golden_detector_step(manifest, arrays, case, dev, wrappers, count):
    """Case E on ``dev``: one bf16 step of ``tpudet3d_torch.detect.train``
    (reported), then the float32 training forward and the gradient of the
    port's loss on JAX's float32 forward outputs carried back through the
    float32 network (gated).  Returns the rules, the launches and the
    port's flat gradients by record key."""
    from ..core import read_py_config
    from ..detect.train import (create_detector_state,
                                make_detector_train_step)
    spec = manifest['train'][case]
    mspec = manifest['models'][spec['model']]
    cfg = read_py_config(spec['config'])
    items = detector_items(spec['batch'], spec['size'],
                                  spec['boxes'], spec['items_seed'])
    if digest(*items) != spec['sha256']:
        raise RuntimeError(f'the items of case {case} are not remade bit '
                           'for bit')
    imgs, boxes, labels, valid = (torch.from_numpy(x).to(dev)
                                  for x in items)
    model = golden_module(mspec, torch.bfloat16, arrays)
    state = create_detector_state(model, lr=spec['lr'],
                                  momentum=float(cfg.optim.momentum),
                                  wd=float(cfg.optim.wd), device=dev)
    loss = spec['loss']
    step = make_detector_train_step(
        state.model, state.optimizer, use_balance=loss['loss_balancing'],
        input_size=spec['size'], giou_weight=loss['giou_weight'],
        cascade_pos_thr=loss['cascade_pos_thr'])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    (state, metrics), n_step = drive(
        wrappers, lambda: step(state, imgs, boxes, labels, valid))
    named = dict(model.named_parameters())
    leaves = mspec['leaves']
    grads = {'bf16/grad': flax_vector(
        {k: p.grad for k, p in named.items()}, leaves)}
    res = golden_step_report(
        arrays, case, leaves, spec['sketch_seed'], metrics.double().cpu(),
        grads['bf16/grad'], flax_vector(
            {k: p.detach() - before[k] for k, p in named.items()}, leaves))
    fwd, terms, grads['f32/fixed_grad'], n_fixed = golden_detector_fixed(
        spec, mspec, arrays, case, (imgs, boxes, labels, valid), dev,
        wrappers)
    res['f32_forward'] = fwd
    res['f32_fixed_terms'] = continuous_rule(
        terms, arrays[f'{case}/f32/fixed_terms'],
        arrays[f'{case}/f64/fixed_terms'])
    res.update(golden_grad_rules(arrays, case, leaves, spec['sketch_seed'],
                                 grads))
    launches = {f'{case} bf16 step': n_step, f'{case} f32 fixed': n_fixed}
    if count:
        for k, v in launches.items():
            if v != [0] * 7:
                raise RuntimeError(f'phase 12 {k}: launches {v}, none on '
                                   'the path')
    res['ok'] = bool(res['grads_ok'] and fwd['ok'])
    return res, launches, grads


def golden_detector_fixed(spec, mspec, arrays, case, batch, dev, wrappers):
    """Case E's float32 gates: the training forward's outputs against
    JAX's, and the gradient of the port's ``ssd_loss`` taken on JAX's
    float32 forward outputs (so that the mined negatives and the
    cascade's re-assignment are those of one input) carried back through
    the port's float32 network.  Returns the forward's rule, the loss
    terms on JAX's outputs, the flat gradient and the launches."""
    from ..detect.anchors import generate_anchors
    from ..detect.losses import ssd_loss
    imgs, boxes, labels, valid = batch
    model = golden_module(mspec, torch.float32, arrays).to(dev)
    model.train()
    names = ('logits', 'deltas', 'deltas2')
    jax_outs = [torch.from_numpy(arrays[f'{case}/f32/fwd_{k}']).to(dev)
                .requires_grad_() for k in names]
    anchors = torch.from_numpy(generate_anchors(spec['size'])).to(dev)
    loss = spec['loss']
    total, parts = ssd_loss(
        jax_outs[0], jax_outs[1], anchors, boxes, labels, valid,
        cascade_deltas=jax_outs[2], giou_weight=loss['giou_weight'],
        cascade_pos_thr=loss['cascade_pos_thr'])
    ct = torch.autograd.grad(total, jax_outs)
    terms = torch.stack([total, parts['cls_loss'], parts['reg_loss'],
                         parts['num_pos']]).detach().double().cpu().numpy()
    params = dict(model.named_parameters())

    def backward():
        logits, (deltas, deltas2) = model(imgs, train=True)
        outs = (logits, deltas, deltas2)
        return outs, torch.autograd.grad(outs, list(params.values()), ct,
                                         allow_unused=True)

    (outs, g), launches = drive(wrappers, backward)
    fwd = {k: continuous_rule(
        o, arrays[f'{case}/f32/fwd_{k}'], arrays[f'{case}/f64/fwd_{k}'])
        for k, o in zip(names, outs)}
    fwd['ok'] = all(v['ok'] for v in fwd.values())
    g = {k: (x if x is not None else torch.zeros_like(p))
         for (k, p), x in zip(params.items(), g)}
    return fwd, terms, flax_vector(g, mspec['leaves']), launches


# the gated gradients of cases D and E; each is held against JAX's with
# JAX's next precision as its yardstick.  Case E's bf16 gradient is
# reported: JAX's own bf16 gradient lies further from its float32 one
# than the gradient's length, so the rule would pass a zero gradient
GOLDEN_GATED_GRADS = {'D': ('bf16/grad', 'f32/grad'),
                      'E': ('f32/fixed_grad',)}
GOLDEN_NEXT = {'bf16': 'f32', 'f32': 'f64'}


def golden_grad_rules(arrays, case, leaves, sketch_seed, grads):
    """The sketch rule of each gradient in ``grads`` (record key such as
    ``'f32/grad'`` → the port's flat vector in the Flax layout) against
    JAX's, with JAX's next precision as its yardstick; ``grads_ok`` over
    those :data:`GOLDEN_GATED_GRADS` names."""
    n = next(iter(grads.values())).size
    hashed = sketch_hash(n, sketch_seed)
    out = {}
    for key, vec in grads.items():
        prec, name = key.split('/')
        out[key] = sketch_rule(
            count_sketch(vec, hashed),
            arrays[f'{case}/{prec}/{name}_sketch'],
            arrays[f'{case}/{GOLDEN_NEXT[prec]}/{name}_sketch'])
        p = leaf_norms(vec, leaves)
        j = arrays[f'{case}/{prec}/{name}_norms']
        j_ref = arrays[f'{case}/{GOLDEN_NEXT[prec]}/{name}_norms']
        excess = np.abs(p - j) / (np.abs(j - j_ref) + SLACK * j
                                  + 1e-30)
        out[key]['leaf_excess'] = float(excess.max())
    out['grads_ok'] = all(out[k]['ok'] for k in GOLDEN_GATED_GRADS[case]
                          if k in out)
    return out


def golden_step_report(arrays, case, leaves, sketch_seed, terms, grad,
                       update):
    """The bf16 step's loss terms under the continuous rule and its
    update's sketch under the sketch rule, reported.  The terms are four
    to six scalars, each yardstick one draw of JAX's bf16 noise, which can
    land near 0 by chance; Adam's sign rule makes the update noisier than
    the gradient."""
    hashed = sketch_hash(grad.size, sketch_seed)
    ref = {p: {k: arrays[f'{case}/{p}/{k}'] for k in (
        'terms', 'update_sketch', 'update_norms')} for p in ('bf16', 'f32')}
    res = dict(terms=continuous_rule(terms, ref['bf16']['terms'],
                                            ref['f32']['terms']),
               update=sketch_rule(count_sketch(update, hashed),
                                         ref['bf16']['update_sketch'],
                                         ref['f32']['update_sketch']))
    p = leaf_norms(update, leaves)
    j, j32 = ref['bf16']['update_norms'], ref['f32']['update_norms']
    excess = np.abs(p - j) / (np.abs(j - j32) + SLACK * j + 1e-30)
    res['update_leaf_excess'] = float(excess.max())
    return res
