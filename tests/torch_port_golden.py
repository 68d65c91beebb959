"""The golden record of the JAX package's bf16 and int8 product route.

    python tests/torch_port_golden.py --out tests/fixtures/torch_port_golden

runs the JAX package on the CPU and writes ``manifest.json`` and
``golden.npz`` there; ``chip_smoke.py`` phase 12 remakes every input from
the manifest with ``tpudet3d_torch/utils/golden.py`` (no JAX) and holds
the port on the card against the record.  Regenerate it in the same
change as any change to a model, an engine default or a training step.

The cases, each at full width:

* A, the default build (``scripts/demo.py``'s ``build_engine``):
  MNv2-SSD-300 w1.0 with plain heads and MNv3-large-21k, 224² crops,
  ``max_detections`` 8, ``det_conf`` 0, over four 720p frames; the JAX
  engine in bf16 (the product) and in float32 with float32 preprocessing
  (the yardstick): the detector's logits and deltas, ``infer_batch``'s
  rows, and the regressor's pre-activation keypoints and class logits on
  the bf16 engine's own crop boxes (a fixed input).
* B, the flagship: the cascade MNv2-SSD-300 with EfficientNet-lite0, the
  same outputs.
  Beside them, the rows of the engine's second stage run on the bf16
  engine's detections (``bf16/dets``) in place of its own: the crop
  boxes, the refine passes and the packed rows of a fixed input.
* C, int8: both bf16 builds calibrated by ``calibrate_engine`` on the four
  frames (the float32 builds' scales beside them, and the bf16 builds'
  with their crops in float32, as the port crops; the detections the
  calibration cropped are recorded); the int8 rows and the int8 keypoints
  on A's and B's boxes (yardstick: the bf16 outputs).
* D, the regressor's train step (``configs/scene_regressor.py``, AdamW,
  batch 8 of 224², dropout 0, no augmentations) in bf16 and float32: the
  loss terms, the gradient's and the update's CountSketch and per-leaf
  norms, and the eval step's sums with the 3D IoU on the initial state;
  and the float32 gradient's yardstick, the same gradient in float64.
* E, the detector's train step (the cascade config, SGD at the warm-up's
  first learning rate, GIoU 2, batch 4 of 300²): the same but the eval;
  and, in float32 with float64 as its yardstick, the training forward's
  outputs and the gradient of the loss on the float32 outputs carried
  back through the network, so that the mined negatives and the
  cascade's re-assignment are those of one input.

The float64 records (``--x64``) come from a process of their own, since
JAX enables float64 for a whole process; the default command runs the
cases as five processes, three at a time, and merges them.  The
functions take the sizes as arguments, so that the cut record of
``tests/test_torch_port_golden.py`` (``--plan cut``) is made the same way.
"""

import argparse
import functools
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
for _p in (REPO, osp.dirname(osp.abspath(__file__))):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from tpudet3d_torch.utils import golden  # noqa: E402

# the seeds of every draw
SEEDS = dict(frames=15001, det_plain=15002, det_cascade=15003,
             reg_mnv3=15004, reg_el0=15005, items_D=15006, items_E=15007,
             sketch_D=15008, sketch_E=15009)
DET_CONFIG = 'configs/detection/mnv2_ssd_300_scene_cascade.py'
REG_CONFIG = 'configs/scene_regressor.py'
EL0_CONFIG = 'configs/scene_regressor_el0_ema.py'

# the full-width record
FULL = dict(
    frames=dict(n=4, h=720, w=1280, seed=SEEDS['frames']),
    models=dict(
        det_plain=dict(kind='detector', width_mult=1.0, cascade=False,
                       seed=SEEDS['det_plain'], source='scripts/demo.py'),
        det_cascade=dict(kind='detector', width_mult=1.0, cascade=True,
                         seed=SEEDS['det_cascade'], source=DET_CONFIG),
        reg_mnv3=dict(kind='regressor', name='mobilenetv3_large_21k',
                      size=224, seed=SEEDS['reg_mnv3'],
                      source='scripts/demo.py'),
        reg_el0=dict(kind='regressor', name='efficientnet-lite0', size=224,
                     seed=SEEDS['reg_el0'], source=EL0_CONFIG)),
    serving=dict(A=dict(detector='det_plain', regressor='reg_mnv3'),
                 B=dict(detector='det_cascade', regressor='reg_el0')),
    engine=dict(crop_size=[224, 224], det_conf=0.0, max_detections=8),
    train=dict(
        D=dict(kind='regressor', config=REG_CONFIG, model='reg_mnv3',
               batch=8, size=224, items_seed=SEEDS['items_D'],
               sketch_seed=SEEDS['sketch_D']),
        E=dict(kind='detector', config=DET_CONFIG, model='det_cascade',
               batch=4, size=300, boxes=8, items_seed=SEEDS['items_E'],
               sketch_seed=SEEDS['sketch_E'])))

# the cut record of tests/test_torch_port_golden.py: the detector at width
# 0.25, MobileNetV3-small in place of MNv3-large-21k, two 180×320 frames,
# 64² crops, 4 detections, small training batches
CUT = dict(
    frames=dict(FULL['frames'], n=2, h=180, w=320),
    models=dict(
        det_plain=dict(FULL['models']['det_plain'], width_mult=0.25),
        det_cascade=dict(FULL['models']['det_cascade'], width_mult=0.25,
                         size=64),
        reg_mnv3=dict(FULL['models']['reg_mnv3'], name='mobilenetv3_small',
                      size=64)),
    serving=dict(A=FULL['serving']['A']),
    engine=dict(FULL['engine'], crop_size=[64, 64], max_detections=4),
    train=dict(D=dict(FULL['train']['D'], batch=4, size=96),
               E=dict(FULL['train']['E'], batch=2, size=64)))
PLANS = dict(full=FULL, cut=CUT)
CUT_FIXTURE = osp.join(golden.FIXTURE, 'cut')
# the processes of one record: the cases of each, and float64
WORKERS = (('ABC', False), ('D', False), ('E', False), ('D', True),
           ('E', True))


# --- models and weights ----------------------------------------------------

def jax_detector(spec, dtype):
    from tpudet3d.detect import SSDDetector
    return SSDDetector(num_classes=9, width_mult=spec['width_mult'],
                       dtype=dtype, cascade=spec['cascade'])


def jax_regressor(spec, dtype):
    from tpudet3d.core import AttrDict
    from tpudet3d.models import build_model
    return build_model(AttrDict(model=dict(name=spec['name'],
                                           pretrained=False, num_classes=9,
                                           bf16=False)), dtype=dtype)


def init_args(spec):
    """The arguments of each model's ``init``."""
    if spec['kind'] == 'detector':
        size = spec.get('size', 300)
        return jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))
    key = jax.random.PRNGKey(0)
    s = spec['size']
    return ({'params': key, 'dropout': key}, jnp.zeros((1, s, s, 3)),
            jnp.zeros((1,), jnp.int32))


def jax_model(spec, dtype):
    return (jax_detector if spec['kind'] == 'detector'
            else jax_regressor)(spec, dtype)


def tree_leaves(tree):
    """``[collection, path, shape, kind]`` of every leaf, keys sorted at
    each level (the order of ``jax.tree_util``'s flattening)."""
    out = []

    def walk(node, collection, path):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict) or hasattr(v, 'items'):
                walk(dict(v), collection, path + [str(k)])
            else:
                shape = [int(d) for d in v.shape]
                out.append([collection, path + [str(k)], shape,
                            golden.leaf_kind(collection, path + [str(k)],
                                             shape)])

    for collection in sorted(tree):
        walk(dict(tree[collection]), collection, [])
    return out


def model_leaves(spec):
    """The leaves of the model's ``init`` tree (its shapes, by
    ``jax.eval_shape``: the tree ``flax_init`` returns, without compiling
    the init)."""
    model = jax_model(spec, jnp.float32)
    return tree_leaves(jax.eval_shape(model.init, *init_args(spec)))


def variables(spec, stats=None):
    """The model's variables: the draws of its leaves, with its calibrated
    statistics once it has them (``stats`` or the record's)."""
    if stats is None:
        stats = spec.get('stats_values')
    return golden.remake_variables(spec['leaves'], spec['seed'], stats)


def calibration_inputs(spec, frames):
    """The calibration batch: the frames as the detector sees them, or for
    a regressor two crops a frame (the frame and its centre half) as the
    engine normalises them; float32."""
    from tpudet3d.detect import INPUT_SIZE
    from tpudet3d.infer.engine import REG_MEAN, REG_STD
    from tpudet3d.ops.image import crop_and_resize, resize_bilinear
    rgb = jnp.asarray(frames[..., ::-1])
    if spec['kind'] == 'detector':
        size = spec.get('size', INPUT_SIZE)
        return jax.vmap(lambda f: resize_bilinear(
            f, (size, size), dtype=jnp.float32) / 255.0)(rgb)
    h, w = frames.shape[1:3]
    boxes = jnp.asarray([[0, 0, w, h], [w / 4, h / 4, 3 * w / 4, 3 * h / 4]],
                        jnp.float32)
    s = spec['size']
    crops = jax.vmap(lambda f: crop_and_resize(
        f, boxes, (s, s), compute_dtype=jnp.float32))(rgb)
    inv_std = (1.0 / (np.asarray(REG_STD) * 255)).astype(np.float32)
    scale = jnp.asarray(inv_std, jnp.bfloat16).astype(jnp.float32)
    offset = jnp.asarray(np.asarray(REG_MEAN) * 255 * inv_std,
                         jnp.bfloat16).astype(jnp.float32)
    return crops.reshape((-1, s, s, 3)) * scale - offset


def calibrated_stats(spec, frames):
    """Every batch norm's running mean and variance set to the statistics
    of its input over the calibration batch, each layer normalised by its
    own in one float32 training-mode forward (as trained weights'
    statistics match their activations), the variance plus
    ``golden.VAR_FLOOR``: the ``batch_stats`` leaves flattened in the
    manifest's order.  With the drawn statistics alone the random networks
    run away (MNv3-large-21k's keypoint pre-activations reach a standard
    deviation of 1550, the detector's scores 1 - 1e-6); with a floor of
    0.01 the channels of small spread amplify bf16's rounding until the
    detector's logits carry 17% of their spread in noise (0.4% at 1)."""
    v = variables(spec, stats=None)
    zeros = jax.tree_util.tree_map(np.zeros_like, v['batch_stats'])
    model = jax_model(spec, jnp.float32)
    x = calibration_inputs(spec, frames)
    args = (x,) if spec['kind'] == 'detector' else (
        x, jnp.zeros((x.shape[0],), jnp.int32))

    @jax.jit
    def batch_stats(params, zeros, *args):
        _, mutated = model.apply(
            {'params': params, 'batch_stats': zeros}, *args, train=True,
            rngs={'dropout': jax.random.PRNGKey(0)},
            mutable=['batch_stats'])
        return mutated['batch_stats']

    # momentum 0.9 from zeros: the running value is a tenth of the batch's
    stats = jax.device_get(batch_stats(v['params'], zeros, *args))
    out = []
    for collection, path, _, _ in spec['leaves']:
        if collection != 'batch_stats':
            continue
        node = stats
        for k in path:
            node = node[k]
        value = np.asarray(node, np.float64) / 0.1
        if path[-1] == 'var':
            value = value + golden.VAR_FLOOR
        out.append(value.astype(np.float32).ravel())
    return np.concatenate(out)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# --- serving ---------------------------------------------------------------

@contextmanager
def f32_preprocess():
    """The JAX engine's two preprocessing calls in float32 (they run in
    bf16 whatever the model dtype): the float32 yardstick is float32 end
    to end, as the port's float32 engine is."""
    import tpudet3d.infer.engine as engine_mod
    from tpudet3d.ops import image as jax_image
    resize, crop = jax_image.resize_bilinear, jax_image.crop_and_resize
    saved = engine_mod.resize_bilinear, engine_mod.crop_and_resize
    engine_mod.resize_bilinear = (
        lambda img, hw, dtype=None: resize(img, hw, jnp.float32))
    engine_mod.crop_and_resize = (
        lambda img, boxes, hw: crop(img, boxes, hw,
                                    compute_dtype=jnp.float32))
    try:
        yield
    finally:
        engine_mod.resize_bilinear, engine_mod.crop_and_resize = saved


def _pre_activation(m, x):
    """The regressor's heads before the sigmoid and its class logits, as
    ``MultiHeadRegressor.__call__`` computes them."""
    pooled = m._pooled(x, False).astype(jnp.float32)
    all_kp = jnp.einsum('bc,hcp->bhp', pooled, m.head_kernel) + m.head_bias
    return all_kp, m.cls_fc(m.cls_dropout(pooled, deterministic=True))


def engine_config(engine_kw, scales=(None, None)):
    from tpudet3d.infer import EngineConfig
    kw = dict(engine_kw, crop_size=tuple(engine_kw['crop_size']))
    return EngineConfig(**kw, det_int8_scales=scales[0],
                        reg_int8_scales=scales[1])


def build_jax_engine(det, dv, reg, rv, engine_kw, scales=(None, None)):
    from tpudet3d.infer import TwoStageEngine
    return TwoStageEngine(det, as_jax(dv), reg, as_jax(rv),
                          engine_config(engine_kw, scales))


def engine_rows(engine, frames, f32):
    """``infer_batch``'s rows ``[N, max_det, 25]``."""
    with ExitStack() as stack:
        if f32:
            stack.enter_context(f32_preprocess())
        results = engine.infer_batch(frames)
    return golden.pack_rows(results, engine.cfg.max_detections)


def serve(engine, frames, boxes, f32):
    """The engine's rows, the detector's logits and deltas, and the
    regressor's pre-activation keypoints and logits on ``boxes [N,M,4]``,
    under the engine's int8 scales when it has them."""
    from tpudet3d.infer.engine import REG_MEAN, REG_STD
    from tpudet3d.infer.quant import intercepting
    from tpudet3d.ops.image import crop_and_resize
    cfg = engine.cfg
    pre = jnp.float32 if f32 else jnp.bfloat16
    rows = engine_rows(engine, frames, f32)
    rgb = jnp.asarray(frames[..., ::-1])
    inv_std = (1.0 / (np.asarray(REG_STD) * 255)).astype(np.float32)
    scale = jnp.asarray(inv_std, jnp.bfloat16)
    offset = jnp.asarray(np.asarray(REG_MEAN) * 255 * inv_std, jnp.bfloat16)

    @jax.jit
    def heads(rgb, boxes):
        crops = jax.vmap(lambda f, b: crop_and_resize(
            f, b, tuple(cfg.crop_size), compute_dtype=pre))(rgb, boxes)
        crops = crops.reshape((-1,) + crops.shape[2:]) * scale - offset
        with intercepting(cfg.reg_int8_scales):
            return engine.reg_model.apply(engine.reg_vars, crops,
                                          method=_pre_activation)

    kp, cls = heads(rgb, jnp.asarray(boxes))
    logits, deltas = detect(engine, frames, f32)
    return dict(rows=rows, pre=np.asarray(kp, np.float32),
                cls=np.asarray(cls, np.float32),
                det_logits=np.asarray(logits, np.float32),
                det_deltas=np.asarray(deltas, np.float32),
                dets=decode(cfg, logits, deltas))


def detect(engine, frames, f32):
    """The engine's detector on ``frames`` as its program feeds it (bf16
    resizing, or float32 with ``f32``), under its int8 scales when it has
    them: the class logits and box deltas, float32 numpy."""
    from tpudet3d.detect import INPUT_SIZE
    from tpudet3d.infer.quant import intercepting
    from tpudet3d.ops.image import resize_bilinear
    cfg = engine.cfg
    pre = jnp.float32 if f32 else jnp.bfloat16

    @jax.jit
    def run(rgb):
        det_in = jax.vmap(lambda f: resize_bilinear(
            f, (INPUT_SIZE, INPUT_SIZE), dtype=pre) / 255.0)(rgb)
        with intercepting(cfg.det_int8_scales):
            return engine.det_model.apply(engine.det_vars, det_in,
                                          train=False)

    logits, deltas = run(jnp.asarray(frames[..., ::-1]))
    return np.asarray(logits, np.float32), np.asarray(deltas, np.float32)


def decode(cfg, logits, deltas):
    """The engine's decode and NMS of each frame's detector outputs, as
    its program calls it: ``[N, max_det, 6]``."""
    fn = _decoder(cfg.box_vote_iou, cfg.score_thr, cfg.nms_iou,
                  cfg.max_detections, cfg.soft_nms_sigma,
                  cfg.soft_nms_dup_iou)
    return np.asarray(fn(logits, deltas), np.float32)


@functools.lru_cache(maxsize=None)
def _decoder(box_vote_iou, score_thr, iou_thr, max_det, sigma, dup_iou):
    from tpudet3d.detect import decode_detections, generate_anchors
    anchors = jnp.asarray(generate_anchors())
    return jax.jit(jax.vmap(lambda lg, dl: decode_detections(
        lg, dl, anchors, box_vote_iou=box_vote_iou, score_thr=score_thr,
        iou_thr=iou_thr, max_per_img=max_det,
        pre_nms_k=max(4 * max_det, 32), soft_nms_sigma=sigma,
        soft_nms_dup_iou=dup_iou)))


def _closure(fn, name):
    """The value a closure of ``fn`` holds under ``name``."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def regress_rows(engine, frames, dets, f32):
    """``infer_batch``'s rows ``[N, max_det, 25]`` with the detections of
    its program's first stage replaced by ``dets [N, max_det, 6]``
    (detector pixels): the engine's own program traced with its
    ``decode_detections`` returning them, so that the crop boxes, the
    refine passes, the heads and the packing are the engine's."""
    import tpudet3d.infer.engine as engine_mod
    core = _closure(engine._pipeline_batch, 'pipeline_core')
    n, h, w = frames.shape[:3]
    margin = engine.cfg.crop_margin_px

    def one(frame, d):
        saved = engine_mod.decode_detections
        engine_mod.decode_detections = lambda *args, **kw: d
        try:
            return core(engine.det_vars, engine.reg_vars, frame, h, w,
                        margin)
        finally:
            engine_mod.decode_detections = saved

    with ExitStack() as stack:
        if f32:
            stack.enter_context(f32_preprocess())
        packed = np.asarray(jax.jit(jax.vmap(one))(
            jnp.asarray(frames), jnp.asarray(dets)))
    results = []
    for p in packed:
        r = p[p[:, 25] > 0]
        results.append(dict(boxes=r[:, :4], scores=r[:, 4],
                            det_labels=r[:, 5], kp=r[:, 6:24],
                            labels=r[:, 24]))
    return golden.pack_rows(results, engine.cfg.max_detections)


def calibration(engine, frames, f32_crops=False):
    """``calibrate_engine``'s ``(det_scales, reg_scales)`` and the
    detections it cropped ``[N, max_det, 6]``; with ``f32_crops`` its
    crops in float32 (its own are in bf16)."""
    import tpudet3d.detect as jax_detect
    from tpudet3d.infer.quant import calibrate_engine
    from tpudet3d.ops import image as jax_image
    decode, crop = jax_detect.decode_detections, jax_image.crop_and_resize
    seen = []

    def recording(*args, **kw):
        seen.append(np.asarray(decode(*args, **kw), np.float32))
        return seen[-1]

    jax_detect.decode_detections = recording
    if f32_crops:
        jax_image.crop_and_resize = lambda img, boxes, hw: crop(
            img, boxes, hw, compute_dtype=jnp.float32)
    try:
        scales = calibrate_engine(engine, frames)
    finally:
        jax_detect.decode_detections = decode
        jax_image.crop_and_resize = crop
    return scales, np.stack(seen)


def crop_boxes(rows, h, w):
    """The crop boxes of the rows ``[N, M, 25]``, the whole frame in place
    of a missing row: ``[N, M, 4]`` float32."""
    boxes = np.where(np.isnan(rows[..., :4]),
                     np.asarray([0, 0, w, h], np.float32), rows[..., :4])
    return boxes.astype(np.float32)


def serving_case(det_spec, reg_spec, frames, engine_kw):
    """Case A or B and its int8 half (C): ``(arrays, scales)``."""
    from tpudet3d.infer.quant import calibrate_engine
    dv = variables(det_spec)
    rv = variables(reg_spec)
    out, scales = {}, {}
    engines = {}
    for prec, dtype in (('bf16', jnp.bfloat16), ('f32', jnp.float32)):
        engines[prec] = build_jax_engine(
            jax_detector(det_spec, dtype), dv, jax_regressor(reg_spec, dtype),
            rv, engine_kw)
    # the bf16 engine's own crop boxes are the fixed input of every
    # regressor comparison
    boxes = crop_boxes(engine_rows(engines['bf16'], frames, False),
                       *frames.shape[1:3])
    out['boxes'] = boxes
    for prec in ('bf16', 'f32'):
        res = serve(engines[prec], frames, boxes, f32=prec == 'f32')
        for k, v in res.items():
            out[f'{prec}/{k}'] = v
        det_s, reg_s = calibrate_engine(engines[prec], frames)
        scales[prec] = dict(det=det_s, reg=reg_s)
    # the second stage on the bf16 engine's detections: a fixed input
    dets = out['bf16/dets']
    for prec in ('bf16', 'f32'):
        out[f'{prec}/regress_rows'] = regress_rows(engines[prec], frames,
                                                   dets, prec == 'f32')
    (det_s, reg_s), out['int8/calib_dets'] = calibration(
        engines['bf16'], frames, f32_crops=True)
    scales['bf16_f32_crops'] = dict(det=det_s, reg=reg_s)
    eng = engines['bf16']
    int8 = build_jax_engine(eng.det_model, dv, eng.reg_model, rv, engine_kw,
                            (scales['bf16']['det'], scales['bf16']['reg']))
    res = serve(int8, frames, boxes, f32=False)
    for k in ('rows', 'pre', 'cls', 'det_logits', 'det_deltas', 'dets'):
        out[f'int8/{k}'] = res[k]
    out['int8/regress_rows'] = regress_rows(int8, frames, dets, False)
    return out, scales


# --- training --------------------------------------------------------------

def sketch_of(vec, hashed):
    return golden.count_sketch(vec, hashed).astype(np.float32)


def flat_params(tree, leaves, dtype=np.float32):
    """A Flax ``params`` tree flattened in the manifest's order."""
    parts = []
    for collection, path, _, _ in leaves:
        if collection != 'params':
            continue
        node = tree
        for k in path:
            node = node[k]
        parts.append(np.asarray(node, dtype).ravel())
    return np.concatenate(parts)


def step_record(prefix, grads, update, leaves, hashed):
    g = flat_params(grads, leaves)
    u = flat_params(update, leaves)
    return {f'{prefix}/grad_sketch': sketch_of(g, hashed),
            f'{prefix}/update_sketch': sketch_of(u, hashed),
            f'{prefix}/grad_norms': golden.leaf_norms(g, leaves),
            f'{prefix}/update_norms': golden.leaf_norms(u, leaves)}


def regressor_grads(cfg, spec, items, dtype):
    """Case D's gradient at the initial state in ``dtype`` (float64 under
    x64: the parameters, the statistics and the batch cast to it):
    ``(terms [l1, add_loss, cross_entropy], gradient tree)``."""
    from tpudet3d import losses as jax_losses
    model = jax_regressor(spec, dtype).clone(dropout_rate=0.0)
    wide = jnp.float64 if dtype == jnp.float64 else jnp.float32
    v = jax.tree_util.tree_map(lambda x: jnp.asarray(x, wide),
                               variables(spec))
    imgs, kp = jnp.asarray(items[0], wide), jnp.asarray(items[1], wide)
    cats = jnp.asarray(items[2], jnp.int32)
    lm = jax_losses.LossManager(jax_losses.build_loss(cfg), cfg.loss.coeffs,
                                cfg.loss.alwa)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def grads(params):
        def loss_fn(params):
            (pkp, logits), _ = model.apply(
                {'params': params, 'batch_stats': v['batch_stats']}, imgs,
                cats, train=True, rngs={'dropout': key},
                mutable=['batch_stats'])
            loss, _ = lm.parse_losses(pkp, kp, logits, cats,
                                      jnp.zeros((), jnp.int32),
                                      lm.init_state())
            return loss, (pkp, logits)
        (loss, (pkp, logits)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        terms = [cr(pkp, kp) for cr in lm.reg_criterions] + \
            [cr(logits, cats) for cr in lm.class_criterions]
        return jnp.stack(terms), g

    terms, g = grads(v['params'])
    return np.asarray(terms, np.float64), jax.device_get(g)


def regressor_step(cfg, spec, items, dtype, hashed, prefix):
    """Case D in ``dtype``: the loss terms ``[loss, l1, add_loss,
    cross_entropy, ADD, SADD]``, the gradient's and the update's sketches
    and leaf norms, and the eval step's sums on the initial state."""
    from tpudet3d import losses as jax_losses
    from tpudet3d.train import optim as jax_optim
    from tpudet3d.train.state import TrainState
    from tpudet3d.train.steps import make_eval_step, make_train_step
    model = jax_regressor(spec, dtype).clone(dropout_rate=0.0)
    start = variables(spec)      # numpy: the step donates its state
    leaves = spec['leaves']
    v = as_jax(start)
    imgs, kp, cats = (jnp.asarray(items[0]), jnp.asarray(items[1]),
                      jnp.asarray(items[2], jnp.int32))
    lm = jax_losses.LossManager(jax_losses.build_loss(cfg), cfg.loss.coeffs,
                                cfg.loss.alwa)
    opt = jax_optim.build_optimizer(cfg)
    state = TrainState(params=v['params'], batch_stats=v['batch_stats'],
                       opt_state=opt.init(v['params']),
                       alwa=lm.init_state(), step=jnp.zeros((), jnp.int32),
                       ema_params=None)
    sums, _ = make_eval_step(model)(v['params'], v['batch_stats'], imgs, kp,
                                    cats, compute_iou=True)
    key = jax.random.PRNGKey(0)
    terms, g = regressor_grads(cfg, spec, items, dtype)
    new_state, metrics = make_train_step(model, lm, opt)(state, imgs, kp,
                                                         cats, key)
    update = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                    new_state.params, start['params'])
    m = np.asarray(metrics, np.float64)
    out = {f'{prefix}/terms': np.concatenate(
        [m[:1], np.asarray(terms, np.float64), m[1:3]]).astype(np.float32),
           f'{prefix}/eval': np.stack([np.asarray(s, np.float32)
                                       for s in sums])}
    out.update(step_record(prefix, g, jax.device_get(update), leaves,
                           hashed))
    return out


def regressor_x64(cfg, spec, items, hashed, prefix):
    """Case D's float64 yardstick of its float32 gradient: the terms and
    the gradient's sketch and leaf norms."""
    terms, g = regressor_grads(cfg, spec, items, jnp.float64)
    g = flat_params(g, spec['leaves'], np.float64)
    return {f'{prefix}/terms': terms,
            f'{prefix}/grad_sketch': golden.count_sketch(g, hashed),
            f'{prefix}/grad_norms': golden.leaf_norms(g, spec['leaves'])}


def detector_fixed(cfg, spec, items, dtype, hashed, prefix):
    """Case E's float32 gates in ``dtype`` (float32, or float64 under x64
    as their yardstick): the training forward's outputs ``[logits, deltas,
    deltas2]`` and the gradient of the loss taken on the float32 forward's
    outputs, carried back through the network in ``dtype`` (JAX's
    ``vjp``), so that its mined negatives and the cascade's re-assignment
    are those of one input; with the loss terms ``[total, cls, reg,
    num_pos]`` on those outputs."""
    from tpudet3d.detect.anchors import generate_anchors
    from tpudet3d.detect.losses import ssd_loss
    start = variables(spec)
    leaves = spec['leaves']
    size = int(items[0].shape[1])
    anchors = jnp.asarray(generate_anchors(size))
    tc = cfg.train_cfg
    kw = dict(giou_weight=float(tc.giou_weight),
              cascade_pos_thr=float(tc.cascade_pos_thr))
    boxes, labels, valid = (jnp.asarray(items[1]),
                            jnp.asarray(items[2], jnp.int32),
                            jnp.asarray(items[3]))

    def forward(dt):
        model = jax_detector(spec, dt)
        v = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dt), start)
        imgs = jnp.asarray(items[0], dt)

        def fwd(params):
            (logits, deltas), _ = model.apply(
                {'params': params, 'batch_stats': v['batch_stats']}, imgs,
                train=True, mutable=['batch_stats'])
            return (logits,) + tuple(deltas)
        return fwd, v['params']

    def loss(outs):
        total, parts = ssd_loss(outs[0], outs[1], anchors, boxes, labels,
                                valid, balance_params=None,
                                cascade_deltas=outs[2], **kw)
        return total, jnp.stack([total, parts['cls_loss'],
                                 parts['reg_loss'], parts['num_pos']])

    fwd32, params32 = forward(jnp.float32)
    outs32 = jax.jit(fwd32)(params32)
    ct, terms = jax.jit(jax.grad(loss, has_aux=True))(
        tuple(o.astype(dtype) for o in outs32))
    fwd, params = ((fwd32, params32) if dtype == jnp.float32
                   else forward(dtype))
    outs = jax.jit(fwd)(params)
    g = jax.jit(lambda p, ct: jax.vjp(fwd, p)[1](ct)[0])(
        params, tuple(c.astype(o.dtype) for c, o in zip(ct, outs)))
    g = flat_params(jax.device_get(g), leaves, np.float64)
    out = {f'{prefix}/fwd_{k}': np.asarray(o, np.float32) for k, o in
           zip(('logits', 'deltas', 'deltas2'), outs)}
    out.update({f'{prefix}/fixed_terms': np.asarray(terms, np.float64),
                f'{prefix}/fixed_grad_sketch': golden.count_sketch(g, hashed),
                f'{prefix}/fixed_grad_norms': golden.leaf_norms(g, leaves)})
    return out


def detector_lr(cfg):
    """The learning rate of the first step under ``warmup_step_lr``."""
    from tpudet3d.detect.train import warmup_step_lr
    return float(warmup_step_lr(
        base_lr=float(cfg.optim.lr),
        warmup_iters=int(cfg.scheduler.warmup_iters),
        warmup_ratio=float(cfg.scheduler.warmup_ratio),
        milestones=tuple(cfg.scheduler.steps),
        gamma=float(cfg.scheduler.gamma))(0))


def detector_step(cfg, spec, items, dtype, hashed, prefix):
    """Case E in ``dtype``: the step's metrics ``[total, cls, reg,
    num_pos]``, the gradient's and the update's sketches and leaf norms."""
    from tpudet3d.detect.anchors import generate_anchors
    from tpudet3d.detect.losses import ssd_loss
    from tpudet3d.detect.train import DetTrainState, make_detector_train_step
    model = jax_detector(spec, dtype)
    start = variables(spec)      # numpy: the step donates its state
    leaves = spec['leaves']
    v = as_jax(start)
    size = int(items[0].shape[1])
    opt = optax.inject_hyperparams(
        lambda learning_rate: optax.chain(
            optax.add_decayed_weights(float(cfg.optim.wd)),
            optax.sgd(learning_rate, momentum=float(cfg.optim.momentum))))(
        learning_rate=detector_lr(cfg))
    balance = {'s_cls': jnp.zeros(()), 's_reg': jnp.zeros(())}
    state = DetTrainState(
        params=v['params'], balance=balance, batch_stats=v['batch_stats'],
        opt_state=opt.init({'model': v['params'], 'balance': balance}),
        step=jnp.zeros((), jnp.int32))
    tc = cfg.train_cfg
    kw = dict(giou_weight=float(tc.giou_weight),
              cascade_pos_thr=float(tc.cascade_pos_thr))
    imgs, boxes, labels, valid = (jnp.asarray(items[0]),
                                  jnp.asarray(items[1]),
                                  jnp.asarray(items[2], jnp.int32),
                                  jnp.asarray(items[3]))
    anchors = jnp.asarray(generate_anchors(size))

    @jax.jit
    def grads(params):
        def loss_fn(params):
            (logits, deltas), _ = model.apply(
                {'params': params, 'batch_stats': v['batch_stats']}, imgs,
                train=True, mutable=['batch_stats'])
            deltas, deltas2 = deltas if isinstance(deltas, tuple) else (
                deltas, None)
            total, _ = ssd_loss(logits, deltas, anchors, boxes, labels,
                                valid, balance_params=None,
                                cascade_deltas=deltas2, **kw)
            return total
        return jax.grad(loss_fn)(params)

    g = grads(state.params)
    step = make_detector_train_step(
        model, opt, use_balance=bool(tc.loss_balancing), input_size=size,
        **kw)
    new_state, metrics = step(state, imgs, boxes, labels, valid)
    update = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                    new_state.params, start['params'])
    out = {f'{prefix}/terms': np.asarray(metrics, np.float32)}
    out.update(step_record(prefix, jax.device_get(g),
                           jax.device_get(update), leaves, hashed))
    return out


def train_items(spec):
    if spec['kind'] == 'regressor':
        return golden.regressor_items(spec['batch'], spec['size'],
                                      spec['items_seed'])
    return golden.detector_items(spec['batch'], spec['size'], spec['boxes'],
                                 spec['items_seed'])


def train_case(name, spec, model_spec, read_config, x64=False):
    """Case D or E in bf16 and float32, or with ``x64`` the float64
    yardsticks of its float32 gates."""
    cfg = read_config(osp.join(REPO, spec['config']))
    items = train_items(spec)
    leaves = model_spec['leaves']
    n = int(sum(np.prod(s) for c, _, s, _ in leaves if c == 'params'))
    hashed = golden.sketch_hash(n, spec['sketch_seed'])
    regressor = spec['kind'] == 'regressor'
    if x64:
        if regressor:
            return regressor_x64(cfg, model_spec, items, hashed,
                                 f'{name}/f64'), items
        return detector_fixed(cfg, model_spec, items, jnp.float64, hashed,
                              f'{name}/f64'), items
    fn = regressor_step if regressor else detector_step
    out = {}
    for prec, dtype in (('bf16', jnp.bfloat16), ('f32', jnp.float32)):
        out.update(fn(cfg, model_spec, items, dtype, hashed,
                      f'{name}/{prec}'))
    if not regressor:
        out.update(detector_fixed(cfg, model_spec, items, jnp.float32,
                                  hashed, f'{name}/f32'))
    return out, items


# --- the record ------------------------------------------------------------

def record(plan, cases=('A', 'B', 'C', 'D', 'E'), x64=False):
    """The manifest and the arrays of ``plan`` (``FULL`` or a cut copy);
    with ``x64`` only the float64 yardsticks of the cases D and E."""
    from tpudet3d.core import read_py_config
    from tpudet3d.infer import EngineConfig
    fr = plan['frames']
    frames = golden.golden_frames(fr['n'], fr['h'], fr['w'], fr['seed'])
    used = set()
    serving = [c for c in sorted(plan['serving'])
               if not x64 and (c in cases or 'C' in cases)]
    for c in serving:
        used.update(plan['serving'][c].values())
    for c in ('D', 'E'):
        if c in cases:
            used.add(plan['train'][c]['model'])
    models = {}
    for name in sorted(used):
        spec = dict(plan['models'][name])
        spec['leaves'] = model_leaves(spec)
        spec['stats_values'] = calibrated_stats(spec, frames)
        spec['stats'] = f'stats/{name}'
        spec['sha256'] = golden.tree_digest(variables(spec))
        models[name] = spec
    defaults = EngineConfig()
    engine = {k: (list(v) if isinstance(v, tuple) else v)
              for k, v in vars(defaults).items()
              if k not in ('det_int8_scales', 'reg_int8_scales')}
    engine.update(plan['engine'])
    manifest = dict(
        generator='python tests/torch_port_golden.py --out '
                  'tests/fixtures/torch_port_golden',
        rules=dict(factor=golden.FACTOR, slack=golden.SLACK,
                   match_iou=golden.MATCH_IOU,
                   match_share=golden.MATCH_SHARE, buckets=golden.BUCKETS),
        frames=dict(fr, sha256=golden.digest(frames)),
        models=models, engine=engine, serving={}, int8={}, train={})
    arrays = {}
    for name, spec in models.items():
        arrays[spec['stats']] = spec['stats_values']
    for c in serving:
        s = plan['serving'][c]
        out, scales = serving_case(models[s['detector']],
                                   models[s['regressor']], frames, engine)
        manifest['serving'][c] = dict(s)
        manifest['int8'][c] = scales
        for k, v in out.items():
            if k.startswith('int8/'):
                arrays[f'C/{c}/{k[5:]}'] = v
            else:
                arrays[f'{c}/{k}'] = v
    # float64 from here on: the weights above are drawn and calibrated
    # in float32 as in every other process
    jax.config.update('jax_enable_x64', x64)
    for c in ('D', 'E'):
        if c not in cases:
            continue
        spec = dict(plan['train'][c])
        out, items = train_case(c, spec, models[spec['model']],
                                read_py_config, x64)
        arrays.update(out)
        if x64:
            continue
        cfg = read_py_config(osp.join(REPO, spec['config']))
        spec['sha256'] = golden.digest(*items)
        spec['optim'] = dict(cfg.optim)
        if spec['kind'] == 'regressor':
            spec['loss'] = dict(names=list(cfg.loss.names),
                                coeffs=[list(x) for x in cfg.loss.coeffs])
            spec['terms'] = (['loss'] + list(cfg.loss.names)
                             + ['ADD', 'SADD'])
            spec['dropout'] = 0.0
            spec['augmentations'] = False
        else:
            tc = cfg.train_cfg
            spec['lr'] = detector_lr(cfg)
            spec['loss'] = dict(giou_weight=float(tc.giou_weight),
                                cascade_pos_thr=float(tc.cascade_pos_thr),
                                loss_balancing=bool(tc.loss_balancing))
            spec['terms'] = ['total', 'cls', 'reg', 'num_pos']
        manifest['train'][c] = spec
    return manifest, arrays, frames


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def write(out_dir, manifest, arrays):
    os.makedirs(out_dir, exist_ok=True)
    manifest = dict(manifest, models={
        k: {f: v for f, v in m.items() if f != 'stats_values'}
        for k, m in manifest['models'].items()})
    with open(osp.join(out_dir, 'manifest.json'), 'w') as f:
        json.dump(_jsonable(manifest), f, indent=1)
        f.write('\n')
    np.savez_compressed(osp.join(out_dir, 'golden.npz'), **arrays)


def merge(dirs, out_dir):
    """One record from the records under ``dirs`` (cases written apart),
    each model's weights the same in all."""
    manifest, arrays = None, {}
    for d in dirs:
        m, a = golden.load_golden(d)
        if manifest is None:
            manifest = m
        else:
            for name, spec in m['models'].items():
                have = manifest['models'].get(name)
                if have is not None and have['sha256'] != spec['sha256']:
                    raise ValueError(f'{name}: the records under {dirs} '
                                     'drew different weights')
            for k in ('models', 'serving', 'int8', 'train'):
                manifest[k].update(m[k])
        arrays.update(a)
    write(out_dir, manifest, arrays)
    return manifest, arrays


def run_workers(plan, out_dir, workers=WORKERS, jobs=3):
    """Every worker's record in a process of its own, ``jobs`` at a time,
    merged into ``out_dir``."""
    with tempfile.TemporaryDirectory() as tmp:
        def one(worker):
            cases, x64 = worker
            out = osp.join(tmp, cases + ('64' if x64 else ''))
            res = subprocess.run(
                [sys.executable, osp.abspath(__file__), '--worker',
                 '--plan', plan, '--cases', cases, '--out', out]
                + (['--x64'] if x64 else []), cwd=REPO,
                capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f'{worker}: {res.stderr[-3000:]}')
            return out

        with ThreadPoolExecutor(jobs) as ex:
            dirs = list(ex.map(one, workers))
        return merge(dirs, out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None,
                    help='default: the fixture of the plan')
    ap.add_argument('--plan', choices=sorted(PLANS), default='full')
    ap.add_argument('--worker', action='store_true',
                    help='write only --cases, in this process')
    ap.add_argument('--cases', default='ABCDE')
    ap.add_argument('--x64', action='store_true',
                    help='with --worker: the float64 yardsticks of D, E')
    args = ap.parse_args(argv)
    out = args.out or (golden.FIXTURE if args.plan == 'full'
                       else CUT_FIXTURE)
    t0 = time.perf_counter()
    if args.worker:
        jax.config.update('jax_platforms', 'cpu')
        manifest, arrays, _ = record(PLANS[args.plan], tuple(args.cases),
                                     args.x64)
        write(out, manifest, arrays)
        return
    manifest, arrays = run_workers(args.plan, out)
    size = sum(os.path.getsize(osp.join(out, f))
               for f in ('manifest.json', 'golden.npz'))
    print(f'wrote {out}: {len(arrays)} arrays, {size} bytes, '
          f'{time.perf_counter() - t0:.1f} s')


if __name__ == '__main__':
    main()
