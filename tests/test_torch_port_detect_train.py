"""The port's detector training against the JAX package's (f32, CPU, one
CPU thread, TF32 off).

The same numpy inputs and weights go to both packages.  Tolerances, and
why:

* ``assign_anchors``: exact, on random ground truth and on the edge cases
  (invalid rows over the anchors, a box with no overlap, two boxes sharing
  a best anchor, an image with no valid box, per-image anchors);
* ``ssd_loss``: the total, its parts and the gradients with respect to
  the logits, both stages' deltas and the balance pair within 1e-5 of
  each tensor's largest magnitude (float32 sums over 2044 anchors in
  another order; ``logsumexp``'s);
* the training forward of ``SSDDetector`` (width 0.5 at 64², plain and
  cascade): outputs within 1e-4 of their largest magnitude and running
  statistics within 1e-4 relative (Flax's batch variance is E[x²] − E[x]²,
  torch's centred: an ulp of E[x²] over the variance);
* 3 train steps of the cascade model at 64² (GIoU 2, balance on, SGD
  at lr 1e-3 with momentum 0.9 and weight decay, EMA 0.9), from init and
  from a JAX state after one step (momentum carried by
  ``load_jax_detector_state``, bit for bit), beside the port in float64
  (its heads' outputs and the loss stay float32): the first step's metrics
  within 1e-4 relative and its running statistics within 1e-4; then each
  of parameters, momentum buffers, EMA and running statistics, as one
  norm over the model, within 4× the port's own float32 rounding (its
  distance from the float64 port) plus 1e-6 of the distance moved, and
  the metrics within 1e-4 plus 4× theirs.  The mined negatives (a sort
  of per-anchor losses that lie close together) and the cascade's
  re-assignment are discrete: a float32 rounding swaps a few, so each
  package's first gradient lies 0.5–1% from float64's and the second
  step's 20–40% (measured); JAX's rounding is independent of the port's
  and was measured up to 2.4× the port's distance from float64.  The
  optimizer alone is held to optax's ``chain(add_decayed_weights,
  sgd(momentum))`` to 1e-6 on the same gradients;
* ``warmup_step_lr``: equal to JAX's float32 schedule at every milestone;
* ``average_precision`` exactly; ``DetectorEvaluator``'s rows within 1e-4
  px and 1e-6 in score, its ``results()`` within 1e-9;
* snapshots: bit for bit.
"""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudet3d.detect import SSDDetector as JaxSSD
from tpudet3d.detect import assigner as jax_assigner
from tpudet3d.detect import losses as jax_losses
from tpudet3d.detect import train as jax_train
from tpudet3d.detect.eval import DetectorEvaluator as JaxEvaluator
from tpudet3d.detect.eval import average_precision as jax_ap
from tpudet3d.utils.checkpoint import save_snap as jax_save_snap

from tpudet3d_torch.detect import (DetectorEvaluator, SSDDetector,
                                   assign_anchors, average_precision,
                                   generate_anchors, load_detector, ssd_loss)
from tpudet3d_torch.detect.train import (create_detector_state,
                                         make_detector_train_step,
                                         warmup_step_lr)
from tpudet3d_torch.utils.checkpoint import (resume_from, save_converted,
                                             save_snap)
from tpudet3d_torch.utils.convert import (jax_to_state_dict,
                                          load_jax_detector_state,
                                          load_jax_variables)
from torch_port_common import (REPO, flax_init, one_cpu_thread, perturb,
                               set_no_tf32)

sys.path.insert(0, osp.join(REPO, 'scripts'))
import snapshot_to_torch  # noqa: E402

LOSS_TOL = 1e-5
FWD_TOL, STATS_TOL = 1e-4, 1e-4
STEP_TOL = dict(metrics=1e-4, stats=1e-4)
STEP_NOISE = 4.0
ANCHORS = generate_anchors()                                   # [2044, 4]


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _close(a, b, tol, what):
    err = _rel(a, b)
    assert err <= tol, f'{what}: {err:.3g} > {tol}'


# --- assignment -----------------------------------------------------------

def _gt(seed, b=4, g=6, size=300):
    """Ground truth at the clustered anchors' scales; the last two rows of
    each image invalid."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(0.2, 0.8, (b, g, 2)) * size
    xy = rng.uniform(0, 1, (b, g, 2)) * (size - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[:, -2:] = False
    labels = rng.randint(0, 9, (b, g)).astype(np.int32)
    return boxes, labels, valid


def _edge_gt():
    boxes, labels, valid = _gt(1)
    boxes[0, 4] = ANCHORS[100]        # an invalid row right on an anchor
    boxes[1, 0] = [1000, 1000, 1010, 1010]     # no overlap with any anchor
    boxes[2, 1] = boxes[2, 0]                  # two boxes, one best anchor
    boxes[2, 2] = boxes[2, 0] + [0.5, 0, 0.5, 0]
    valid[3] = False                           # no valid box
    return boxes, labels, valid


ASSIGN_CASES = {'random': lambda: _gt(0), 'edges': _edge_gt}


def _jax_assign(anchors, boxes, valid, **kw):
    in_axes = (0 if anchors.ndim == 3 else None, 0, 0)
    out = jax.vmap(lambda a, b, v: jax_assigner.assign_anchors(a, b, v, **kw),
                   in_axes=in_axes)(jnp.asarray(anchors), jnp.asarray(boxes),
                                    jnp.asarray(valid))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize('batched', [False, True],
                         ids=['shared_anchors', 'per_image_anchors'])
@pytest.mark.parametrize('case', sorted(ASSIGN_CASES))
def test_assign_anchors_matches_jax(case, batched):
    boxes, _, valid = ASSIGN_CASES[case]()
    anchors, kw = ANCHORS, {}
    if batched:
        # the cascade's refined boxes: jittered anchors per image, at the
        # cascade's threshold
        rng = np.random.RandomState(7)
        anchors = (ANCHORS[None] + rng.normal(0, 6, (4,) + ANCHORS.shape)) \
            .astype(np.float32)
        kw = dict(pos_thr=0.5, neg_thr=0.5)
    ref_assigned, ref_pos = _jax_assign(anchors, boxes, valid, **kw)
    assigned, pos = assign_anchors(_t(anchors), _t(boxes),
                                   _t(valid, torch.bool), **kw)
    assert assigned.dtype == torch.int64
    np.testing.assert_array_equal(assigned.numpy(), ref_assigned)
    np.testing.assert_array_equal(pos.numpy(), ref_pos)
    assert (ref_assigned >= 0).sum() > 0
    if case == 'edges':
        assert not (ref_assigned[3] >= 0).any()        # no valid box
        assert not (ref_assigned == 4)[0].any()        # invalid row
        # a later one of the boxes sharing a best anchor claims it
        assert ref_assigned[2].max() >= 1


# --- the loss -------------------------------------------------------------

# (cascade, giou_weight, balance, uniform_neg_weight, an image with no box)
LOSS_CASES = {
    'plain': (False, 0.0, False, 0.1, False),
    'giou_balance': (False, 2.0, True, 0.0, False),
    'cascade_giou_balance': (True, 2.0, True, 0.1, False),
    'cascade_plain': (True, 0.0, False, 0.0, False),
    'no_positive_image': (True, 2.0, True, 0.1, True),
}


def _loss_inputs(seed, empty_image):
    rng = np.random.RandomState(seed)
    boxes, labels, valid = _gt(seed + 10, b=3)
    if empty_image:
        valid[1] = False
    logits = (rng.standard_normal((3, 2044, 10)) * 2).astype(np.float32)
    d1 = (rng.standard_normal((3, 2044, 4)) * 0.5).astype(np.float32)
    d2 = (rng.standard_normal((3, 2044, 4)) * 0.5).astype(np.float32)
    bal = np.asarray([0.3, -0.2], np.float32)
    return logits, d1, d2, bal, boxes, labels, valid


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
def test_ssd_loss_matches_jax(case):
    cascade, giou, balance, uneg, empty = LOSS_CASES[case]
    logits, d1, d2, bal, boxes, labels, valid = _loss_inputs(3, empty)
    kw = dict(giou_weight=giou, uniform_neg_weight=uneg)

    def jloss(lg, a, b, s):
        return jax_losses.ssd_loss(
            lg, a, jnp.asarray(ANCHORS), jnp.asarray(boxes),
            jnp.asarray(labels), jnp.asarray(valid),
            balance_params=(s[0], s[1]) if balance else None,
            cascade_deltas=b if cascade else None, **kw)

    (ref, ref_parts), ref_g = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(bal))
    args = [_t(x).requires_grad_() for x in (logits, d1, d2, bal)]
    lg, a, b, s = args
    total, parts = ssd_loss(
        lg, a, _t(ANCHORS), _t(boxes), _t(labels, torch.int64),
        _t(valid, torch.bool), balance_params=(s[0], s[1]) if balance
        else None, cascade_deltas=b if cascade else None, **kw)
    total.backward()
    _close(float(total.detach()), float(ref), LOSS_TOL, 'total')
    for k in ('cls_loss', 'reg_loss', 'num_pos'):
        _close(float(parts[k].detach()), float(ref_parts[k]), LOSS_TOL, k)
    for name, x, g in zip(('logits', 'deltas', 'deltas2', 'balance'), args,
                          ref_g):
        if np.abs(np.asarray(g)).max() == 0:
            assert x.grad is None or float(x.grad.abs().max()) == 0, name
            continue
        _close(x.grad.numpy(), np.asarray(g), LOSS_TOL, f'd/d{name}')
    assert float(ref_parts['num_pos']) > 0


# --- the detector's training forward and the train step --------------------

SIZE, BATCH = 64, 4


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    boxes, labels, valid = _gt(seed + 20, b=BATCH, g=4, size=SIZE)
    return imgs, boxes, labels, valid


@pytest.mark.parametrize('cascade', [False, True], ids=['plain', 'cascade'])
def test_training_forward_matches_flax(cascade):
    jmodel = JaxSSD(num_classes=9, width_mult=0.5, cascade=cascade)
    imgs = _batch()[0]
    variables = perturb(flax_init(jmodel, jnp.zeros((1, SIZE, SIZE, 3))), 4)
    (ref_logits, ref_deltas), mutated = jmodel.apply(
        variables, jnp.asarray(imgs), train=True, mutable=['batch_stats'])
    port = load_jax_variables(
        SSDDetector(num_classes=9, width_mult=0.5, cascade=cascade),
        variables)
    logits, deltas = port(_t(imgs), train=True)
    _close(logits.detach().numpy(), ref_logits, FWD_TOL, 'logits')
    if cascade:
        assert isinstance(deltas, tuple) and isinstance(ref_deltas, tuple)
        for i, (d, r) in enumerate(zip(deltas, ref_deltas)):
            _close(d.detach().numpy(), r, FWD_TOL, f'deltas stage {i + 1}')
    else:
        _close(deltas.detach().numpy(), ref_deltas, FWD_TOL, 'deltas')
    stats = jax_to_state_dict({'batch_stats': jax.device_get(
        mutated['batch_stats'])})
    own = port.state_dict()
    for k, v in stats.items():
        _close(own[k].numpy(), v.numpy(), STATS_TOL, k)
    # inference is unchanged by a training call on other weights
    with torch.no_grad():
        eval_out = port(_t(imgs))
    assert eval_out[1].shape == (BATCH, 88, 4)


LR, WD, MOMENTUM, EMA = 1e-3, 5e-4, 0.9, 0.9


@pytest.fixture(scope='module')
def jax_step():
    jmodel = JaxSSD(num_classes=9, width_mult=0.5, cascade=True)
    opt = optax.inject_hyperparams(
        lambda learning_rate: optax.chain(
            optax.add_decayed_weights(WD),
            optax.sgd(learning_rate, momentum=MOMENTUM)))(learning_rate=LR)
    step = jax_train.make_detector_train_step(
        jmodel, opt, use_balance=True, input_size=SIZE, ema_decay=EMA,
        giou_weight=2.0, cascade_pos_thr=0.5)
    return jmodel, opt, step


def _port_state(dtype=torch.float32):
    model = SSDDetector(num_classes=9, width_mult=0.5, cascade=True,
                        dtype=dtype)
    state = create_detector_state(model.to(dtype), lr=LR, momentum=MOMENTUM,
                                  wd=WD, ema_decay=EMA, device='cpu')
    step = make_detector_train_step(
        state.model, state.optimizer, use_balance=True, input_size=SIZE,
        ema_decay=EMA, giou_weight=2.0, cascade_pos_thr=0.5)
    return state, step


def jax_train_trace(js):
    """optax's momentum trace inside the injected chain's state."""
    return js.opt_state.inner_state[1][0].trace


def _port_tensors(state):
    """(kind, name) → float64 tensor: parameters (the balance pair too),
    momentum buffers and EMA."""
    named = dict(state.model.named_parameters(), **{
        f'balance.{k}': p for k, p in state.balance.items()})
    out = {}
    for k, p in named.items():
        out['param', k] = p.detach().double()
        buf = state.optimizer.state.get(p, {}).get('momentum_buffer')
        out['momentum', k] = (torch.zeros_like(p) if buf is None
                              else buf).double()
        if k in state.ema_params:
            out['ema', k] = state.ema_params[k].double()
    for k, v in state.model.state_dict().items():
        if 'running' in k:
            out['stats', k] = v.double()
    return out


def _jax_tensors(jstate):
    js = jax.device_get(jstate)
    trace = jax_train_trace(js)
    out = {}
    for kind, tree in (('param', js.params), ('momentum', trace['model']),
                       ('ema', js.ema_params)):
        for k, v in jax_to_state_dict({'params': tree}).items():
            out[kind, k] = v.double()
    for k, v in jax_to_state_dict({'batch_stats': js.batch_stats}).items():
        out['stats', k] = v.double()
    for k in ('s_cls', 's_reg'):
        out['param', f'balance.{k}'] = torch.tensor(float(js.balance[k]),
                                                    dtype=torch.float64)
        out['momentum', f'balance.{k}'] = torch.tensor(
            float(trace['balance'][k]), dtype=torch.float64)
    return out


def _dist(a, b, kind):
    return sum(float(((a[k] - b[k]) ** 2).sum()) for k in b
               if k[0] == kind) ** 0.5


def _check_step(port, port64, ref, start, what):
    """Each kind's distance between the port and JAX (the norm over all its
    tensors) within STEP_NOISE times the port's own float32 rounding, its
    distance from the float64 port, plus 1e-6 of how far the float64 port
    moved from ``start``."""
    for kind in ('param', 'momentum', 'ema', 'stats'):
        moved = _dist(port64, start, kind)
        noise = _dist(port, port64, kind)
        err = _dist(port, ref, kind)
        assert err <= STEP_NOISE * noise + 1e-6 * moved, (
            f'{what} {kind}: |port - JAX| {err:.3g}, |port - float64| '
            f'{noise:.3g}, moved {moved:.3g}')


@pytest.mark.parametrize('start', ['init', 'after_one_jax_step'])
def test_train_steps_match_jax(jax_step, start):
    jmodel, opt, jstep = jax_step
    # Flax's initialisers with random running statistics
    variables = flax_init(jmodel, jnp.zeros((1, SIZE, SIZE, 3)))
    variables.update(perturb({'batch_stats': variables['batch_stats']}, 6))
    jstate = jax_train.create_detector_state(
        jmodel, opt, jax.random.PRNGKey(0), input_size=SIZE, ema_decay=EMA)
    jstate = jstate.replace(params=variables['params'],
                            batch_stats=variables['batch_stats'],
                            ema_params=jax.tree_util.tree_map(
                                np.copy, variables['params']))
    batches = [_batch(s) for s in range(4)]
    if start != 'init':
        jstate, _ = jstep(jstate, *map(jnp.asarray, batches[3]))
    ports = []
    for dtype in (torch.float32, torch.float64):
        state, step = _port_state(dtype)
        load_jax_detector_state(state, jax.device_get(jstate))
        ports.append((state, step))
    (state, step), (state64, step64) = ports
    begin = _jax_tensors(jstate)
    got = _port_tensors(state)
    for k, v in begin.items():      # the converter carries every tensor
        assert torch.equal(got[k], v), k
    assert (_dist(got, {k: 0 * v for k, v in got.items()}, 'momentum')
            > 0) == (start != 'init')
    for i in range(3):
        imgs, boxes, labels, valid = batches[i]
        jstate, ref = jstep(jstate, jnp.asarray(imgs), jnp.asarray(boxes),
                            jnp.asarray(labels), jnp.asarray(valid))
        gt = (_t(boxes), _t(labels, torch.int64), _t(valid, torch.bool))
        state, metrics = step(state, _t(imgs), *gt)
        state64, metrics64 = step64(state64, _t(imgs).double(),
                                    gt[0].double(), *gt[1:])
        assert metrics.dtype == torch.float32 and metrics.shape == (4,)
        # from the second step on, the losses of float32 weights apart by
        # their rounding
        err = np.abs(metrics.numpy() - np.asarray(ref)).max()
        noise = (metrics.double() - metrics64.double()).abs().max().item()
        scale = np.abs(np.asarray(ref)).max()
        assert err <= STEP_TOL['metrics'] * scale + STEP_NOISE * noise, (
            f'step {i} metrics: {err:.3g}, float32 noise {noise:.3g}')
        ours, ref_t = _port_tensors(state), _jax_tensors(jstate)
        _check_step(ours, _port_tensors(state64), ref_t, begin, f'step {i}')
        if i == 0:
            # the first step's forward runs on the same weights
            for k in ref_t:
                if k[0] == 'stats':
                    _close(ours[k].numpy(), ref_t[k].numpy(),
                           STEP_TOL['stats'], f'step 0 {k[1]}')
        assert int(state.step) == int(jax.device_get(jstate.step))
    assert float(state.balance['s_cls']) != 0.0


def test_sgd_matches_optax_chain():
    """The optimizer alone, fed the same gradients at changing learning
    rates: ``SGD(momentum, weight_decay)`` is ``chain(add_decayed_weights,
    sgd(momentum))`` to 1e-6 relative, parameters and momentum."""
    rng = np.random.RandomState(9)
    shapes = {'w': (8, 5), 'b': (5,), 's': ()}
    params = {k: rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    opt = optax.inject_hyperparams(
        lambda learning_rate: optax.chain(
            optax.add_decayed_weights(WD),
            optax.sgd(learning_rate, momentum=MOMENTUM)))(learning_rate=LR)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    topt = torch.optim.SGD(tparams.values(), lr=LR, momentum=MOMENTUM,
                           weight_decay=WD)
    for it, lr in enumerate((0.01, 0.03, 0.005, 0.05)):
        grads = {k: (rng.standard_normal(v) * 3).astype(np.float32)
                 for k, v in shapes.items()}
        jopt.hyperparams['learning_rate'] = jnp.asarray(lr, jnp.float32)
        updates, jopt = opt.update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for g in topt.param_groups:
            g['lr'] = lr
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        topt.step()
        trace = jopt.inner_state[1][0].trace
        for k, p in tparams.items():
            _close(p.detach().numpy(), jparams[k], 1e-6, f'{it} {k}')
            _close(topt.state[p]['momentum_buffer'].numpy(), trace[k], 1e-6,
                   f'{it} {k} momentum')


def test_warmup_step_lr_matches_jax():
    kw = dict(base_lr=0.05, warmup_iters=300, warmup_ratio=1.0 / 3,
              milestones=(25, 30, 35), gamma=0.1, steps_per_epoch=16)
    ours, ref = warmup_step_lr(**kw), jax_train.warmup_step_lr(**kw)
    steps = [0, 1, 150, 299, 300, 301, 399, 400, 479, 480, 481, 559, 560,
             10_000]
    for s in steps:
        assert ours(s) == float(ref(s)), s


# --- validation -----------------------------------------------------------

def test_average_precision_matches_jax():
    rng = np.random.RandomState(2)
    for n, num_gt in ((0, 0), (1, 0), (5, 3), (40, 12), (40, 60)):
        scores = rng.uniform(0, 1, n)
        scores[n // 2:n // 2 + 3] = 0.5          # ties
        matched = rng.uniform(0, 1, n) < 0.4
        assert average_precision(scores, matched, num_gt) == \
            jax_ap(scores, matched, num_gt)


def test_detector_evaluator_matches_jax():
    from tpudet3d_torch.data.detection_dataset import SyntheticDetection
    jmodel = JaxSSD(num_classes=9, width_mult=0.25)
    variables = perturb(flax_init(jmodel, jnp.zeros((1, 300, 300, 3))), 8)
    port = load_jax_variables(SSDDetector(num_classes=9, width_mult=0.25),
                              variables)
    ds = SyntheticDetection(length=8, seed=4)
    ours = DetectorEvaluator(port, params=None)
    ref = JaxEvaluator(jmodel, jax.tree_util.tree_map(jnp.asarray, variables))
    for start in (0, 4):
        items = [ds[i] for i in range(start, start + 4)]
        imgs, boxes, labels, valid = (np.stack([it[k] for it in items])
                                      for k in range(4))
        x = (imgs[..., ::-1] / np.float32(255)).astype(np.float32)
        dets = ours.detect(_t(x))
        ref_dets = np.asarray(ref._forward(ref._variables, jnp.asarray(x)))
        keep = ref_dets[..., 4] > 0
        np.testing.assert_array_equal(dets[..., 4].numpy() > 0, keep)
        np.testing.assert_allclose(dets.numpy()[keep][:, :4],
                                   ref_dets[keep][:, :4], atol=1e-4, rtol=0)
        np.testing.assert_allclose(dets.numpy()[keep][:, 4],
                                   ref_dets[keep][:, 4], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(dets.numpy()[keep][:, 5],
                                      ref_dets[keep][:, 5])
        ours.add_batch(x, boxes, labels, valid, dets=dets)
        ref.add_batch(x, boxes, labels, valid)
    got, want = ours.results(), ref.results()
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    assert sum(len(v) for v in ours._records.values()) > 0


# --- snapshots ------------------------------------------------------------

def _trained_state(ema, seed=0, steps=1):
    model = SSDDetector(num_classes=9, width_mult=0.25, cascade=True)
    state = create_detector_state(model, lr=LR, momentum=MOMENTUM, wd=WD,
                                  ema_decay=EMA if ema else 0.0, device='cpu',
                                  generator=torch.Generator().manual_seed(
                                      seed))
    step = make_detector_train_step(state.model, state.optimizer,
                                    use_balance=True, input_size=SIZE,
                                    ema_decay=EMA if ema else 0.0,
                                    giou_weight=2.0)
    for i in range(steps):
        imgs, boxes, labels, valid = _batch(i)
        state, _ = step(state, _t(imgs), _t(boxes), _t(labels, torch.int64),
                        _t(valid, torch.bool))
    return state


def _same_tensors(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f'{what} {k}'


def _weights(state):
    return {k: v for k, v in state.model.state_dict().items()
            if not k.endswith('num_batches_tracked')}


@pytest.mark.parametrize('saved_ema,config_ema', [(True, True), (True, False),
                                                  (False, True)],
                         ids=['ema', 'ema_dropped', 'ema_started'])
def test_detector_snapshot_resume(tmp_path, saved_ema, config_ema):
    state = _trained_state(saved_ema, steps=2)
    save_snap(state, 3, str(tmp_path))
    fresh = _trained_state(config_ema, seed=1, steps=0)
    fresh, start = resume_from(fresh, str(tmp_path / 'snap_3.pt'))
    assert start == 4
    _same_tensors(_weights(fresh), _weights(state), 'weights')
    for k in ('s_cls', 's_reg'):
        assert torch.equal(fresh.balance[k], state.balance[k])
    assert int(fresh.step) == int(state.step) == 2
    sa, sb = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    assert sa['state'].keys() == sb['state'].keys()
    for i in sa['state']:
        assert torch.equal(sa['state'][i]['momentum_buffer'],
                           sb['state'][i]['momentum_buffer'])
    if not config_ema:
        assert fresh.ema_params is None
    elif saved_ema:
        _same_tensors(fresh.ema_params, state.ema_params, 'EMA')
    else:
        # the average starts from the restored weights
        _same_tensors(fresh.ema_params, {k: p.detach() for k, p in
                                         state.model.named_parameters()},
                      'EMA')
    # the trainer's snapshot serves as it is: the EMA (or the weights)
    served = load_detector(str(tmp_path / 'snap_3'), dtype=torch.float32,
                           device='cpu')
    want = dict(_weights(state), **(state.ema_params or {}))
    _same_tensors({k: v for k, v in served.state_dict().items()
                   if not k.endswith('num_batches_tracked')}, want, 'served')
    assert served.cascade and served.width_mult == 0.25


def test_jax_detector_snapshot_resumes_tolerantly(tmp_path, capsys):
    jmodel = JaxSSD(num_classes=9, width_mult=0.25, cascade=True)
    jstate = jax_train.create_detector_state(
        jmodel, optax.sgd(0.1, momentum=0.9), jax.random.PRNGKey(0),
        input_size=SIZE, ema_decay=EMA)
    jax_save_snap(jstate, 5, str(tmp_path))
    out, = snapshot_to_torch.main([str(tmp_path / 'snap_5')])
    state = _trained_state(True, steps=0)
    state, start = resume_from(state, out)
    assert start == 6
    assert 'falling back' in capsys.readouterr().out
    want = jax_to_state_dict(jax.device_get(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats}))
    _same_tensors(_weights(state), want, 'weights')
    # the optimizer and the balance pair stay fresh
    assert not state.optimizer.state and int(state.step) == 0
    assert all(float(p) == 0.0 for p in state.balance.values())


def test_regressor_snapshot_refused(tmp_path):
    state = _trained_state(False, steps=0)
    path = save_converted(str(tmp_path / 'snap_0.pt'), 'regressor', 0,
                          _weights(state))
    with pytest.raises(ValueError, match='regressor snapshot'):
        resume_from(state, path)
