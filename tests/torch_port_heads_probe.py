"""Can the golden record's free-running rows be gated?  JAX's own answer.

    python tests/torch_port_heads_probe.py --out probe.json
    python tests/torch_port_heads_probe.py --heads lr=0.01 steps=6000 \\
        labels=one --det-conf 0.6 0.9

Phase 12 of ``chip_smoke.py`` holds the port's ``infer_batch`` rows only
on the rows that JAX itself decides: those of its bf16 engine that pair
with its float32 engine's (``utils/golden.py`` ``rows_rule``), and for
int8 those of its int8 engine that pair with its bf16 engine's.  With the
record's random detector heads the top scores lie on a plateau and JAX's
own rows part, so the rows are reported, not gated.  This script trains
both record detectors' classification heads in JAX on the CPU and
measures, at the full-width plan of ``tests/torch_port_golden.py``:

* per serving case and ``det_conf``: rows and decided rows, bf16 against
  float32 and int8 against bf16, and the rows a frame;
* per detector and backbone level: the features' spread over the
  positions against the bf16 backbone's deviation from the float32 one;
* case E's gradient (the cascade detector's training step, the record's
  items at ``--batch``): ``|g_bf16 - g_f32|`` and ``|g_f32|``, with drawn
  and with trained heads.

The heads (``trained_heads``) are trained on the record's frames with
their planted rectangles (``golden.golden_boxes``) as ground truth: the
JAX package's ``assign_anchors`` and ``ssd_loss`` (hard-negative mining,
the uniform negative term) and optax's Adam, full batch, in float32 on
the backbone's features of each precision listed (each computed once as
that build's engine feeds the detector); the depthwise conv, its batch
norm's scale and bias and the 1×1 conv move, the backbone, the
regression heads and every batch norm's statistics stay at their drawn
and calibrated values.  ``--heads key=value`` overrides ``HEADS``.
"""

import argparse
import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import torch_port_golden as gen  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from tpudet3d_torch.utils import golden  # noqa: E402

# the heads' training: full-batch Adam steps, the labels (``brightness``:
# the fill's sum(BGR) in nine bins; ``one``: every rectangle class 0),
# the precisions whose features it sees, ssd_loss's pos_thr
HEADS = dict(steps=3000, lr=0.03, labels='brightness',
             precisions='float32,bfloat16', pos_thr=0.4)


def with_heads(v, heads):
    """The variables ``v`` with the ``params`` subtrees ``heads``."""
    return dict(v, params=dict(v['params'], **heads))


def backbone(spec, dtype, v, x):
    """The detector's backbone features of ``x`` computing in ``dtype``
    (inference mode)."""
    model = gen.jax_detector(spec, dtype)
    return jax.jit(lambda v, x: model.apply(
        v, x, False, method=lambda m, x, t: m.backbone(x, t)))(v, x)


def trained_heads(spec, frames, seed, heads=HEADS):
    """``{'cls_heads_i': params}`` of the detector ``spec`` trained on the
    frames (drawn with ``seed``) with their planted rectangles."""
    from tpudet3d.detect import generate_anchors, num_anchors_per_level
    from tpudet3d.detect.losses import ssd_loss
    from tpudet3d.detect.ssd import _DepthwiseHead
    from tpudet3d.ops.image import resize_bilinear
    v = gen.as_jax(gen.variables(spec))
    size = spec.get('size', 300)
    rgb = jnp.asarray(frames[..., ::-1])
    precisions = heads['precisions'].split(',')
    feats, deltas = [], []
    for name in precisions:
        dtype = jnp.dtype(name)
        model = gen.jax_detector(spec, dtype)
        x = jax.vmap(lambda f: resize_bilinear(
            f, (size, size), dtype=dtype) / 255.0)(rgb)
        feats.append([a.astype(jnp.float32)
                      for a in backbone(spec, dtype, v, x)])
        deltas.append(jax.jit(lambda v, x: model.apply(v, x)[1])(v, x))
    feats = [jnp.concatenate(f) for f in zip(*feats)]
    deltas = jnp.concatenate(deltas)
    n, h, w = frames.shape[:3]
    boxes, labels, valid = golden.golden_boxes(n, h, w, seed)
    if heads['labels'] == 'one':
        labels = 0 * labels
    boxes = boxes * np.asarray([size / w, size / h] * 2, np.float32)
    gt = tuple(jnp.asarray(np.concatenate([a] * len(precisions)))
               for a in (boxes, labels.astype(np.int32), valid))
    anchors = jnp.asarray(generate_anchors(size))
    names = [f'cls_heads_{i}' for i in range(len(num_anchors_per_level()))]
    modules = [_DepthwiseHead(model.num_classes + 1, k)
               for k in num_anchors_per_level()]
    stats = {k: v['batch_stats'][k] for k in names}

    def loss(params):
        logits = jnp.concatenate([
            m.apply({'params': params[k], 'batch_stats': stats[k]}, f)
            for m, k, f in zip(modules, names, feats)], axis=1)
        return ssd_loss(logits, deltas, anchors, *gt,
                        pos_thr=float(heads['pos_thr']))[0]

    opt = optax.adam(float(heads['lr']))

    @jax.jit
    def step(params, opt_state):
        updates, opt_state = opt.update(jax.grad(loss)(params), opt_state,
                                        params)
        return optax.apply_updates(params, updates), opt_state

    params = {k: v['params'][k] for k in names}
    opt_state = opt.init(params)
    for _ in range(int(heads['steps'])):
        params, opt_state = step(params, opt_state)
    return jax.device_get(params)


def feature_snr(spec, frames):
    """Per backbone output level of the detector: the features' spread
    over the positions (float32; the standard deviation about each
    image's and channel's mean), the standard deviation of the bf16
    backbone's features from the float32 one's on the same input, and
    their ratio."""
    from tpudet3d.ops.image import resize_bilinear
    v = gen.as_jax(gen.variables(spec))
    size = spec.get('size', 300)
    x = jax.vmap(lambda f: resize_bilinear(
        f, (size, size), dtype=jnp.float32) / 255.0)(
        jnp.asarray(frames[..., ::-1]))
    f32s, b16s = ([np.asarray(f, np.float64) for f in backbone(spec, dt, v, x)]
                  for dt in (jnp.float32, jnp.bfloat16))
    out = []
    for f32, b16 in zip(f32s, b16s):
        spread = float((f32 - f32.mean((1, 2), keepdims=True)).std())
        noise = float((b16 - f32).std())
        out.append(dict(spread=spread, bf16_noise=noise,
                        ratio=spread / noise))
    return out


def rows_agreement(ds, rs, dv, rv, frames, engine_kw):
    """bf16 against float32 and int8 against bf16: rows, decided, rows a
    frame."""
    from tpudet3d.infer.quant import calibrate_engine
    engines, rows = {}, {}
    for prec, dtype in (('bf16', jnp.bfloat16), ('f32', jnp.float32)):
        engines[prec] = gen.build_jax_engine(
            gen.jax_detector(ds, dtype), dv, gen.jax_regressor(rs, dtype),
            rv, engine_kw)
        rows[prec] = golden.unpack_rows(
            gen.engine_rows(engines[prec], frames, prec == 'f32'))
    eng = engines['bf16']
    int8 = gen.build_jax_engine(eng.det_model, dv, eng.reg_model, rv,
                                engine_kw, calibrate_engine(eng, frames))
    rows['int8'] = golden.unpack_rows(gen.engine_rows(int8, frames, False))
    out = {}
    for key, (a, b) in (('bf16_vs_f32', ('bf16', 'f32')),
                        ('int8_vs_bf16', ('int8', 'bf16'))):
        r = golden.rows_rule(rows[a], rows[a], rows[b])
        out[key] = dict(rows=r['rows'], decided=r['decided'],
                        per_frame=[len(x['scores']) for x in rows[a]])
    return out


def e_gradients(spec, heads, batch):
    """Case E's loss gradient at the initial state in bf16 and float32
    (flat, float64): ``(|g_bf16 - g_f32|, |g_f32|)``."""
    from tpudet3d.core import read_py_config
    from tpudet3d.detect.anchors import generate_anchors
    from tpudet3d.detect.losses import ssd_loss
    e = dict(gen.FULL['train']['E'], batch=batch)
    cfg = read_py_config(osp.join(gen.REPO, e['config']))
    tc = cfg.train_cfg
    imgs, boxes, labels, valid = (jnp.asarray(a) for a in gen.train_items(e))
    labels = labels.astype(jnp.int32)
    anchors = jnp.asarray(generate_anchors(e['size']))
    v = gen.variables(spec)
    if heads is not None:
        v = with_heads(v, heads)
    v = gen.as_jax(v)
    g = {}
    for prec, dtype in (('bf16', jnp.bfloat16), ('f32', jnp.float32)):
        model = gen.jax_detector(spec, dtype)

        def loss_fn(params):
            (logits, (d1, d2)), _ = model.apply(
                {'params': params, 'batch_stats': v['batch_stats']}, imgs,
                train=True, mutable=['batch_stats'])
            return ssd_loss(logits, d1, anchors, boxes, labels, valid,
                            cascade_deltas=d2,
                            giou_weight=float(tc.giou_weight),
                            cascade_pos_thr=float(tc.cascade_pos_thr))[0]

        g[prec] = gen.flat_params(jax.device_get(jax.jit(jax.grad(loss_fn))(
            v['params'])), spec['leaves'], np.float64)
    return (float(np.linalg.norm(g['bf16'] - g['f32'])),
            float(np.linalg.norm(g['f32'])))


def probe(heads, det_confs, batch):
    plan = gen.FULL
    fr = plan['frames']
    frames = golden.golden_frames(fr['n'], fr['h'], fr['w'], fr['seed'])
    out = dict(heads=heads, serving={}, E={})
    specs, trained = {}, {}
    for name in sorted({m for s in plan['serving'].values()
                        for m in s.values()}):
        spec = dict(plan['models'][name])
        spec['leaves'] = gen.model_leaves(spec)
        spec['stats_values'] = gen.calibrated_stats(spec, frames)
        specs[name] = spec
        if spec['kind'] == 'detector':
            out[f'{name}_features'] = feature_snr(spec, frames)
            print(name, 'features', out[f'{name}_features'], flush=True)
            t0 = time.perf_counter()
            trained[name] = trained_heads(spec, frames, fr['seed'], heads)
            out[f'{name}_train_s'] = time.perf_counter() - t0
    for case, s in sorted(plan['serving'].items()):
        ds, rs = specs[s['detector']], specs[s['regressor']]
        dv = with_heads(gen.variables(ds), trained[s['detector']])
        rv = gen.variables(rs)
        for conf in det_confs:
            kw = dict(plan['engine'], det_conf=conf)
            res = rows_agreement(ds, rs, dv, rv, frames, kw)
            out['serving'][f'{case} det_conf {conf}'] = res
            print(case, conf, json.dumps(res), flush=True)
    name = plan['train']['E']['model']
    for which, h in (('drawn', None), ('trained', trained[name])) * (
            batch > 0):
        dist, norm = e_gradients(specs[name], h, batch)
        out['E'][which] = dict(batch=batch, distance=dist, norm=norm)
        print('E', which, out['E'][which], flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--heads', nargs='*', default=[],
                    help='HEADS overrides, key=value')
    ap.add_argument('--det-conf', type=float, nargs='+', default=[0.6])
    ap.add_argument('--batch', type=int, default=16,
                    help="case E's batch for the gradient distance "
                         '(0: none)')
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)
    jax.config.update('jax_platforms', 'cpu')
    heads = dict(HEADS, **dict(kv.split('=', 1) for kv in args.heads))
    out = probe(heads, args.det_conf, args.batch)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
