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
* frames (:func:`golden_frames`), regressor items (:func:`regressor_items`)
  and detector items (:func:`detector_items`);
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
  at full width.

This module is testing support: it imports numpy and torch and nothing of
JAX or of the JAX package.
"""

import hashlib
import json
import os.path as osp

import numpy as np
import torch

__all__ = ['FACTOR', 'SLACK', 'MATCH_IOU', 'MATCH_SHARE', 'BUCKETS',
           'VAR_FLOOR', 'FIXTURE', 'load_golden', 'digest', 'tree_digest',
           'leaf_kind', 'draw_leaf', 'remake_variables', 'golden_frames',
           'regressor_items', 'detector_items', 'sketch_hash',
           'count_sketch', 'flax_vector', 'leaf_norms', 'bf16_ulp',
           'continuous_rule', 'sketch_rule', 'match_rows', 'rows_rule',
           'dets_rule', 'pack_rows', 'unpack_rows']

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

def golden_frames(n, h, w, seed):
    """``[n,h,w,3]`` uint8 BGR frames: a blocky background of 16-pixel
    cells with noise on it, and 3 to 5 filled rectangles each, drawn by
    numpy slicing."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, (n, -(-h // 16), -(-w // 16), 3))
    frames = np.repeat(np.repeat(cells, 16, 1), 16, 2)[:, :h, :w]
    frames = frames + rng.randint(-12, 13, frames.shape)
    for f in frames:
        for _ in range(rng.randint(3, 6)):
            bh, bw = rng.randint(h // 8, h // 2), rng.randint(w // 8, w // 2)
            y0, x0 = rng.randint(0, h - bh), rng.randint(0, w - bw)
            f[y0:y0 + bh, x0:x0 + bw] = rng.randint(0, 256, 3)
    return np.clip(frames, 0, 255).astype(np.uint8)


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
