"""The port's regressor training step against the JAX package (f32, CPU,
one CPU thread, TF32 off).

The same numpy inputs, weights and gradients go to both packages.
Tolerances, and why:

* losses: values and gradients to 1e-6 relative (float32 rounding of a
  mean over 144 terms);
* ALWA: the total loss, every ``AlwaState`` field and the gradients
  through the updated ``lam_cls`` to 1e-5 relative (``lam_cls = 1 −
  (cls − reg)/cls`` rounds at 1.0's ulp, 6e-8, which is 1.4e-6 of a
  ``lam_cls`` of 0.04);
* optimizers, fed the same gradients: parameters to 1e-6 relative; the
  schedulers exactly (the same Python arithmetic);
* training batch norm: output and input gradient to 1e-5, running
  statistics to 1e-6 relative.  Flax's variance is E[x²] − E[x]², torch's
  is centred: where a channel's |mean| is far above its spread, Flax's
  cancels (an ulp of E[x²] over the variance: 7e-4 of the output at
  batch 2 of an uncentred dense layer), so the head's test centres the
  dense layer's output (ROADMAP.md Queue 3);
* one whole train step of a cut MobileNetV3 at 32² (dropout 0 on both
  sides): loss and metrics to 1e-5 relative; every gradient to 1e-4 of
  its tensor's largest magnitude (a conv's reduction order; measured
  3e-5) plus 1e-6 of the model's largest gradient, the floor of a
  gradient that is 0 in exact arithmetic and rounding noise on either
  side (the bias of a batch norm whose output reaches the next batch
  norm linearly: ~5e-7 against 2.2); the running statistics and the ALWA
  state to 1e-5.  The parameters are bounded by Adam's sign rule: an
  element's update is ``lr·m̂/(√v̂ + eps)``, ``lr·g/(|g| + eps)`` on the
  first step, which does not depend on the gradient's scale, only on its
  sign and, later, on the ratios of its values, so a relative gradient
  error δ moves it by about ``lr·δ``; where a gradient is rounding noise
  its sign is a coin, and the two packages may move the element up to
  ``2·lr`` a step apart.  Each element's bound is 1e-6 plus ``lr`` times
  3× the sum of its gradients' relative errors so far, capped at 2 a
  step.  Before the second step the port takes JAX's parameters and EMA:
  from its own, whose noise elements may sit ``2·lr`` from JAX's, the
  second step's gradients would differ by up to 4e-3;
* the eval step: ADD, SADD, accuracy and counts to 1e-5 per sample, the
  IoU to 1e-2 per sample, the tolerances of tests/test_torch_port_box3d.py
  for the port's own lift: the float32 lift is ill-conditioned, and
  keypoints one ulp apart (the two forwards) lift to boxes whose IoUs
  differ by up to 4e-4 here.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudet3d import losses as jax_losses
from tpudet3d.core import AttrDict
from tpudet3d.models.layers import ConvBN as JaxConvBN
from tpudet3d.models.mobilenetv3 import MobileNetV3 as JaxMNv3
from tpudet3d.models.wrapper import MultiHeadRegressor as JaxRegressor
from tpudet3d.train import optim as jax_optim
from tpudet3d.train.state import TrainState as JaxTrainState
from tpudet3d.train.state import param_count as jax_param_count
from tpudet3d.train.steps import make_eval_step as jax_make_eval_step
from tpudet3d.train.steps import make_train_step as jax_make_train_step

from tpudet3d_torch import losses
from tpudet3d_torch.models import ConvBN, MobileNetV3, build_model
from tpudet3d_torch.models.wrapper import MultiHeadRegressor, dropout
from tpudet3d_torch.train import (build_optimizer, build_scheduler,
                                  create_train_state, current_learning_rate,
                                  eval_params, make_eval_step,
                                  make_train_step, param_count,
                                  set_learning_rate)
from tpudet3d_torch.utils.convert import jax_to_state_dict, load_jax_variables
from tpudet3d_torch.tools.cases import projected_box_keypoints
from torch_port_common import flax_init, one_cpu_thread, perturb, set_no_tf32

# a cut MobileNetV3-large: stride-1 and stride-2 blocks, 3×3 and 5×5
# depthwise convs, squeeze-excite, ReLU and hard-swish, the head's BN
SMALL_CFGS = ((3, 1, 16, 0, 0, 1), (3, 4, 24, 0, 0, 2), (5, 3, 40, 1, 0, 2),
              (3, 6, 80, 0, 1, 2), (3, 6, 112, 1, 1, 1))
SIZE, BATCH = 32, 4


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(t):
    return t.detach().float().numpy()


def _rel_close(a, b, rtol, what=''):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max() / scale
    assert err <= rtol, f'{what}: {err:.3g} of {scale:.3g} > {rtol}'


# --- losses -----------------------------------------------------------------

def _loss_inputs(seed=0, scale=1.0):
    """pred, target [8,9,2]: differences spread over 0.005–0.2 (both sides
    of wing's w = 0.05, of smooth-L1's beta 0.1) times ``scale``, never 0
    (JAX's norm gradient is NaN where pred == target)."""
    rng = np.random.RandomState(seed)
    pred = rng.uniform(0.2, 0.8, (8, 9, 2)).astype(np.float32)
    d = rng.uniform(0.005, 0.2, pred.shape) * rng.choice([-1, 1], pred.shape)
    d *= scale
    return pred, (pred + d).astype(np.float32)


def _boundary_inputs():
    """Dyadic values whose difference is exactly beta = 0.25 in half the
    elements."""
    pred = np.full((4, 9, 2), 0.5, np.float32)
    target = pred + np.where(np.arange(72).reshape(4, 9, 2) % 2, 0.25,
                             0.125).astype(np.float32)
    return pred, target


LOSS_CASES = {
    'l1': ('l1_loss', {}, _loss_inputs),
    'smoothl1': ('smooth_l1_loss', dict(beta=0.1), _loss_inputs),
    'smoothl1_at_beta': ('smooth_l1_loss', dict(beta=0.25), _boundary_inputs),
    'mse': ('mse_loss', {}, _loss_inputs),
    'add_loss': ('add_loss', {}, _loss_inputs),
    'diag_loss': ('diag_loss', {}, _loss_inputs),
    'wing': ('wing_loss', dict(w=0.05, eps=2.0), _loss_inputs),
    'wing_config': ('wing_loss', dict(w=5.18, eps=1.0), _loss_inputs),
}


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
def test_loss_matches_jax(case):
    name, kw, inputs = LOSS_CASES[case]
    pred, target = inputs()
    jfn = partial(getattr(jax_losses, name), **kw)
    ref, ref_g = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(target)))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    out = getattr(losses, name)(p, _t(target), **kw)
    out.backward()
    _rel_close(float(out.detach()), float(ref), 1e-6, 'value')
    _rel_close(_np(p.grad), ref_g, 1e-6, 'gradient')


def test_cross_entropy_and_diag_match_jax():
    rng = np.random.RandomState(3)
    logits = (rng.standard_normal((8, 9)) * 3).astype(np.float32)
    labels = rng.randint(0, 9, 8).astype(np.int32)
    ref, ref_g = jax.value_and_grad(jax_losses.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    x = _t(logits).requires_grad_()
    out = losses.cross_entropy_loss(x, _t(labels, torch.int64))
    out.backward()
    _rel_close(float(out), float(ref), 1e-6, 'value')
    _rel_close(_np(x.grad), ref_g, 1e-6, 'gradient')
    pred, _ = _loss_inputs()
    _rel_close(_np(losses.compute_diag(_t(pred))),
               jax_losses.compute_diag(jnp.asarray(pred)), 1e-6, 'diag')
    assert set(losses.LOSS_REGISTRY) == set(jax_losses.LOSS_REGISTRY)


def _loss_cfg(names, coeffs, alwa=None):
    return AttrDict(loss=dict(
        names=names, coeffs=coeffs, smoothl1_beta=0.2, w=5.18, eps=1.,
        alwa=alwa or dict(use=False, lam_cls=1., lam_reg=1., C=100,
                          compute_std=True)))


def test_build_loss_matches_jax_in_config_order():
    names = ['wing', 'cross_entropy', 'diag_loss', 'smoothl1', 'mse',
             'add_loss', 'l1']
    cfg = _loss_cfg(names, ([1.] * 6, [1.]))
    pred, target = _loss_inputs(1)
    logits = np.random.RandomState(4).standard_normal((8, 9)) \
        .astype(np.float32)
    labels = np.arange(8, dtype=np.int32)
    reg, cls = losses.build_loss(cfg)
    jreg, jcls = jax_losses.build_loss(cfg)
    assert (len(reg), len(cls)) == (len(jreg), len(jcls)) == (6, 1)
    for f, jf in zip(reg, jreg):
        _rel_close(float(f(_t(pred), _t(target))),
                   float(jf(jnp.asarray(pred), jnp.asarray(target))), 1e-6)
    _rel_close(float(cls[0](_t(logits), _t(labels, torch.int64))),
               float(jcls[0](jnp.asarray(logits), jnp.asarray(labels))), 1e-6)
    assert losses.AVAILABLE_LOSS == jax_losses.AVAILABLE_LOSS
    with pytest.raises(ValueError):
        losses.build_loss(_loss_cfg(['huber'], ([1.], [])))


@pytest.mark.parametrize('compute_std', [True, False], ids=['ver_1', 'ver_2'])
def test_loss_manager_alwa_matches_jax(compute_std):
    """C = 2 over 5 steps (it fires at steps 2 and 4): the total loss, its
    gradients and every AlwaState field after each step."""
    cfg = _loss_cfg(['l1', 'add_loss', 'cross_entropy'], ([1., .1], [1.]),
                    dict(use=True, lam_cls=1., lam_reg=1., C=2,
                         compute_std=compute_std))
    lm = losses.LossManager(losses.build_loss(cfg), cfg.loss.coeffs,
                            cfg.loss.alwa)
    jlm = jax_losses.LossManager(jax_losses.build_loss(cfg), cfg.loss.coeffs,
                                 cfg.loss.alwa)
    state, jstate = lm.init_state('cpu'), jlm.init_state()
    rng = np.random.RandomState(5)
    fired = 0
    for it in range(5):
        # both losses' scales alternate, so that the variances do not
        # cancel in Σx² − (Σx)²/n
        pred, target = _loss_inputs(10 + it, 2.0 if it % 2 else 0.5)
        # the classification loss dominates, so lam_cls must move
        logits = (rng.standard_normal((8, 9)) * (6 if it % 2 else 2)) \
            .astype(np.float32)
        labels = rng.randint(0, 9, 8).astype(np.int32)

        def jtotal(p, lg, jstate=jstate):
            return jlm.parse_losses(p, jnp.asarray(target), lg,
                                    jnp.asarray(labels), it, jstate)[0]

        ref_g = jax.grad(jtotal, argnums=(0, 1))(jnp.asarray(pred),
                                                jnp.asarray(logits))
        ref, jstate = jlm.parse_losses(jnp.asarray(pred), jnp.asarray(target),
                                       jnp.asarray(logits),
                                       jnp.asarray(labels), it, jstate)
        p, lg = _t(pred).requires_grad_(), _t(logits).requires_grad_()
        out, state = lm.parse_losses(p, _t(target), lg,
                                     _t(labels, torch.int64),
                                     torch.tensor(it, dtype=torch.int32),
                                     state)
        out.backward()
        _rel_close(float(out), float(ref), 1e-5, f'step {it} total')
        _rel_close(_np(p.grad), ref_g[0], 1e-5, f'step {it} d/dpred')
        _rel_close(_np(lg.grad), ref_g[1], 1e-5, f'step {it} d/dlogits')
        for field in ('lam_cls', 'lam_reg', 'sum_cls', 'sumsq_cls',
                      'sum_reg', 'sumsq_reg'):
            _rel_close(float(getattr(state, field)),
                       float(getattr(jstate, field)), 1e-5,
                       f'step {it} {field}')
        assert int(state.count) == int(jstate.count)
        assert state.count.dtype == torch.int32
        fired += int(state.count) == 0
    assert fired == 2 and float(state.lam_cls) < 1.0


# --- optimizers and schedulers -------------------------------------------------

OPTIM_CASES = {
    'adam': dict(name='adam'),
    'sgd_nesterov': dict(name='sgd', nesterov=True),
    'sgd': dict(name='sgd', nesterov=False),
    'rmsprop': dict(name='rmsprop'),
    'adadelta': dict(name='adadelta'),
}


def _optim_cfg(**kw):
    optim = dict(name='adam', lr=0.01, momentum=0.9, wd=0.01,
                 betas=(0.9, 0.999), rho=0.9, alpha=0.99, nesterov=True)
    optim.update(kw)
    return AttrDict(optim=optim, data=dict(max_epochs=40),
                    scheduler=dict(name='', gamma=0.6, exp_gamma=0.975,
                                   steps=[22, 30, 36]))


@pytest.mark.parametrize('case', sorted(OPTIM_CASES))
def test_optimizer_matches_optax(case):
    """The same gradients for 3 steps, the learning rate halved before the
    third through ``set_learning_rate``; one leaf has gradients of ~2e-5
    (where optax's sqrt(nu + eps) and torch's sqrt(nu) + eps part) and
    one has none on the second step (optax still decays and moves its
    moments)."""
    cfg = _optim_cfg(**OPTIM_CASES[case])
    rng = np.random.RandomState(6)
    shapes = {'a': (4, 3), 'b': (5,), 'small': (6,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = []
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        g['small'] *= 2e-5
        if step == 1:
            g['b'][:] = 0.0
        grads.append(g)

    opt = jax_optim.build_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    topt = build_optimizer(cfg, list(tparams.values()))
    for step, g in enumerate(grads):
        if step == 2:
            jstate = jax_optim.set_learning_rate(jstate, 0.005)
            set_learning_rate(topt, 0.005)
            assert current_learning_rate(topt) == 0.005
            assert jax_optim.current_learning_rate(jstate) == \
                float(np.float32(0.005))
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in
                                      g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = _t(g[k])
        topt.step()
        for k in shapes:
            _rel_close(_np(tparams[k]), jparams[k], 1e-6,
                       f'{case} step {step} {k}')


@pytest.mark.parametrize('name', ['cosine', 'exp', 'stepLR', 'multistepLR'])
def test_scheduler_matches_jax(name):
    cfg = _optim_cfg()
    cfg.scheduler.name = name
    ours, ref = build_scheduler(cfg), jax_optim.build_scheduler(cfg)
    assert [ours(e) for e in range(40)] == [ref(e) for e in range(40)]
    cfg.scheduler.name = ''
    assert build_scheduler(cfg) is None


# --- training batch norm and dropout ----------------------------------------------

def test_conv_bn_training_matches_flax():
    """ConvBN in training mode at batch 2: output, input gradient and the
    new running statistics (a biased/unbiased mix-up doubles the var's
    step at batch 2 of a 1×1 map)."""
    rng = np.random.RandomState(7)
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32) + 0.5
    w = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    model = JaxConvBN(features=8, kernel_size=3, strides=2)
    v = perturb(flax_init(model, jnp.asarray(x)), seed=7)

    def f(xx, v=v):
        out, mut = model.apply(v, xx, train=True, mutable=['batch_stats'])
        return jnp.sum(out * w), (out, mut)

    (_, (ref, mut)), ref_g = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    port = load_jax_variables(ConvBN(4, 8, 3, 2), v)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    out = port(xt, train=True)
    (out * _t(w).permute(0, 3, 1, 2)).sum().backward()
    _rel_close(_np(out.permute(0, 2, 3, 1)), ref, 1e-5, 'output')
    _rel_close(_np(xt.grad.permute(0, 2, 3, 1)), ref_g, 1e-5, 'input grad')
    bs = mut['batch_stats']['BatchNorm_0']
    _rel_close(_np(port.BatchNorm_0.running_mean), bs['mean'], 1e-6, 'mean')
    _rel_close(_np(port.BatchNorm_0.running_var), bs['var'], 1e-6, 'var')


def test_head_bn_training_matches_flax():
    """MNv3's head (Dense → BN over [B, C] → hard-swish) at batch 2."""
    cfgs = SMALL_CFGS[:1]
    model = JaxMNv3(cfgs=cfgs, mode='large')
    v = perturb(flax_init(model, jnp.zeros((2, 16, 16, 3))), seed=8)
    rng = np.random.RandomState(8)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    dense = v['params']['head_dense']
    dense['bias'] = -(pooled @ dense['kernel']).mean(0).astype(np.float32)
    w = rng.standard_normal((2, 1280)).astype(np.float32)

    def f(p, v=v):
        out, mut = model.apply(v, p, train=True, method=JaxMNv3.head,
                               mutable=['batch_stats'])
        return jnp.sum(out * w), (out, mut)

    (_, (ref, mut)), ref_g = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(pooled))
    port = load_jax_variables(MobileNetV3(cfgs=cfgs, mode='large'), v)
    p = _t(pooled).requires_grad_()
    out = port.head(p, train=True)
    (out * _t(w)).sum().backward()
    _rel_close(_np(out), ref, 1e-5, 'output')
    _rel_close(_np(p.grad), ref_g, 1e-5, 'input grad')
    bs = mut['batch_stats']['head_bn']
    _rel_close(_np(port.head_bn.running_mean), bs['mean'], 1e-6, 'mean')
    _rel_close(_np(port.head_bn.running_var), bs['var'], 1e-6, 'var')


def test_dropout_mask_scale_and_seed():
    x = torch.ones(200_000)
    out = dropout(x, 0.5, torch.Generator().manual_seed(3))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0))
    again = dropout(x, 0.5, torch.Generator().manual_seed(3))
    other = dropout(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(out, again) and not torch.equal(out, other)
    out3 = dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert abs((out3 != 0).float().mean().item() - 0.75) < 0.01
    assert torch.allclose(out3[out3 != 0], torch.tensor(1 / 0.75))
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.5, None)


# --- the whole train step and the eval step ----------------------------------------

def _step_cfg():
    cfg = _optim_cfg(name='adam', lr=1e-3, wd=1e-4)
    cfg.update(_loss_cfg(['l1', 'add_loss', 'cross_entropy'],
                         ([1., .1], [1.]),
                         # fires at step 1 of 2 (C = 1 with compute_std
                         # would give NaN gradients in JAX: ROADMAP.md)
                         dict(use=True, lam_cls=1., lam_reg=1., C=1,
                              compute_std=False)))
    return cfg


@pytest.fixture(scope='module')
def regressor():
    """(flax module, perturbed numpy variables, port module factory) of a
    cut MNv3 regressor with dropout 0; the head biases are the logits of
    box projections, so that the keypoints lift to boxes."""
    model = JaxRegressor(backbone=JaxMNv3(cfgs=SMALL_CFGS, mode='large'),
                         dropout_rate=0.0)
    key = jax.random.PRNGKey(0)
    v = perturb(flax_init(model, jnp.zeros((1, SIZE, SIZE, 3)),
                          jnp.zeros((1,), jnp.int32),
                          rngs={'params': key, 'dropout': key}), seed=9)
    kp = projected_box_keypoints(9, seed=9)
    v['params']['head_bias'] = np.log(kp / (1 - kp)).reshape(9, 18) \
        .astype(np.float32)
    v['params']['head_kernel'] = v['params']['head_kernel'] * 0.05

    def port():
        return load_jax_variables(MultiHeadRegressor(
            MobileNetV3(cfgs=SMALL_CFGS, mode='large'), dropout_rate=0.0), v)

    return model, v, port, kp


def _batch(seed=11):
    rng = np.random.RandomState(seed)
    imgs = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    cats = np.array([0, 3, 5, 3], np.int32)
    kp = projected_box_keypoints(BATCH, seed=seed)
    return imgs, kp, cats


def _jax_grads(model, lm, state, imgs, kp, cats):
    """The gradients of the JAX step's loss (its ``loss_fn``, jitted)."""
    def grads(params, batch_stats, alwa, step):
        def loss_fn(params):
            (pkp, logits), _ = model.apply(
                {'params': params, 'batch_stats': batch_stats}, imgs, cats,
                train=True, rngs={'dropout': jax.random.PRNGKey(0)},
                mutable=['batch_stats'])
            return lm.parse_losses(pkp, kp, logits, cats, step, alwa)[0]
        return jax.grad(loss_fn)(params)
    return jax.jit(grads)(state.params, state.batch_stats, state.alwa,
                          state.step)


def _params_sd(tree):
    return jax_to_state_dict({'params': jax.device_get(tree)})


def test_train_step_matches_jax(regressor):
    """Two steps of AdamW with ALWA (firing on the second) and an EMA of
    decay 0.9: loss, metrics, every gradient, the new parameters, running
    statistics, ALWA state and EMA."""
    model, v, port_factory, _ = regressor
    cfg = _step_cfg()
    lr, decay = float(cfg.optim.lr), 0.9
    jlm = jax_losses.LossManager(jax_losses.build_loss(cfg), cfg.loss.coeffs,
                                 cfg.loss.alwa)
    opt = jax_optim.build_optimizer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, v['params'])
    jstate = JaxTrainState(
        params=params, batch_stats=jax.tree_util.tree_map(
            jnp.asarray, v['batch_stats']),
        opt_state=opt.init(params), alwa=jlm.init_state(),
        step=jnp.zeros((), jnp.int32),
        ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jstep = jax_make_train_step(model, jlm, opt, ema_decay=decay)

    port = port_factory()
    lm = losses.LossManager(losses.build_loss(cfg), cfg.loss.coeffs,
                            cfg.loss.alwa)
    state = create_train_state(port, build_optimizer(cfg, port.parameters()),
                               lm, ema_decay=decay, device='cpu')
    step = make_train_step(port, lm, state.optimizer, ema_decay=decay)
    assert param_count(port) == jax_param_count(v['params'])
    imgs, kp, cats = _batch()
    moved = {}        # name → the bound on |Δ Adam direction| so far
    for i in range(2):
        ref_g = _params_sd(_jax_grads(model, jlm, jstate, imgs, kp, cats))
        jstate, ref_m = jstep(jstate, imgs, kp, cats, jax.random.PRNGKey(i))
        state, m = step(state, _t(imgs), _t(kp), _t(cats, torch.int64),
                        torch.Generator().manual_seed(i))
        _rel_close(_np(m), np.asarray(ref_m), 1e-5, f'step {i} metrics')
        g_max = max(float(np.abs(g.numpy()).max()) for g in ref_g.values())
        for name, p in port.named_parameters():
            g, r = _np(p.grad), ref_g[name].numpy()
            err = np.abs(g - r)
            assert err.max() <= 1e-4 * np.abs(r).max() + 1e-6 * g_max, \
                f'step {i} d{name}: {err.max():.3g}'
            # Adam's direction is scale-free in the gradients: its change
            # is about the gradients' relative change, capped at 2; the
            # JAX step's own gradients differ from these by the noise
            # floor (another compilation)
            rel = (err + 1e-6 * g_max) / (np.maximum(np.abs(g), np.abs(r))
                                          + 1e-8)
            moved[name] = np.minimum(moved.get(name, 0.0) + 3 * rel,
                                     2.0 * (i + 1))
        ref_p = _params_sd(jstate.params)
        ref_e = _params_sd(jstate.ema_params)
        for name, p in port.named_parameters():
            bound = 1e-6 + lr * moved[name]
            assert np.all(np.abs(_np(p) - ref_p[name].numpy()) <= bound), \
                f'step {i} {name}'
            # the EMA is a convex combination of the parameters so far
            assert np.all(np.abs(_np(state.ema_params[name])
                                 - ref_e[name].numpy()) <= bound), \
                f'step {i} EMA {name}'
        ref_bs = jax_to_state_dict({'batch_stats': jax.device_get(
            jstate.batch_stats)})
        sd = port.state_dict()
        for name, r in ref_bs.items():
            _rel_close(_np(sd[name]), r, 1e-5, f'step {i} {name}')
        for field in ('lam_cls', 'lam_reg', 'sum_cls', 'sumsq_cls',
                      'sum_reg', 'sumsq_reg'):
            _rel_close(float(getattr(state.alwa, field)),
                       float(getattr(jstate.alwa, field)), 1e-5,
                       f'step {i} {field}')
        assert int(state.alwa.count) == int(jstate.alwa.count)
        assert int(state.step) == int(jstate.step) == i + 1
        # the second step starts from JAX's parameters and EMA, which
        # differ from the port's only where the sign rule moved noise
        # apart, so that its gradients compare as tightly as the first's;
        # the port's optimizer moments carry over
        with torch.no_grad():
            for name, p in port.named_parameters():
                p.copy_(ref_p[name])
                state.ema_params[name].copy_(ref_e[name])
    assert float(state.alwa.lam_cls) != 1.0           # ALWA fired
    # every parameter moved the same way in both; the EMA lags them
    assert all(not torch.equal(state.ema_params[k], p)
               for k, p in port.named_parameters())
    assert eval_params(state) is state.ema_params


def test_unused_parameters_decay_as_optax():
    """With one class the logits are the categories and ``cls_fc`` takes
    no gradient; AdamW still decays it, as optax decays every leaf."""
    cfg = _step_cfg()
    cfg.model = dict(name='mobilenetv3_small', num_classes=1, bf16=False)
    cfg.update(_loss_cfg(['l1', 'add_loss'], ([1., .1], [])))
    state = create_train_state(cfg, device='cpu',
                               generator=torch.Generator().manual_seed(0))
    fc = state.model.cls_fc.weight
    before = fc.detach().clone()
    step = make_train_step(state.model, state.loss_manager, state.optimizer)
    imgs, kp, cats = _batch()
    state, m = step(state, _t(imgs), _t(kp), _t(cats, torch.int64),
                    torch.Generator().manual_seed(0))
    assert torch.equal(fc.grad, torch.zeros_like(fc))
    lr, wd = float(cfg.optim.lr), float(cfg.optim.wd)
    torch.testing.assert_close(fc.detach(), before * (1 - lr * wd),
                               rtol=1e-7, atol=0)
    assert float(m[3]) == float((cats == 0).mean())


def _eval_pair(regressor, compute_iou, other_params):
    """The port's and JAX's eval steps on one batch of 4 whose last sample
    is padding (weight 0); ``other_params`` evaluates perturbed parameters
    (as an EMA would be) in place of the module's own."""
    model, v, port_factory, class_kp = regressor
    port = port_factory()
    imgs, _, cats = _batch(12)
    # the ground truth near each class's box, as after some training
    kp = (class_kp[cats] + np.random.RandomState(12).normal(
        0, 0.003, (BATCH, 9, 2))).astype(np.float32)
    weights = np.array([1, 1, 1, 0], np.float32)
    params = v['params']
    if other_params:
        params = perturb(v, seed=13)['params']
        params['head_bias'] = v['params']['head_bias']
    ref, _ = jax_make_eval_step(model)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, v['batch_stats']), imgs, kp,
        cats, weights, compute_iou=compute_iou)
    eval_step = make_eval_step(port)
    out, (pkp, _) = eval_step(_params_sd(params) if other_params else None,
                              _t(imgs), _t(kp), _t(cats, torch.int64),
                              _t(weights), compute_iou=compute_iou)
    return [_np(o) for o in out], [np.asarray(r) for r in ref]


@pytest.mark.parametrize('compute_iou', [True, False])
@pytest.mark.parametrize('other_params', [False, True], ids=['own', 'ema'])
def test_eval_step_matches_jax(regressor, compute_iou, other_params):
    out, ref = _eval_pair(regressor, compute_iou, other_params)
    for o, r, what, tol in zip(out, ref, ('add', 'sadd', 'iou', 'acc', 'count'),
                               (1e-5, 1e-5, 1e-2, 1e-5, 1e-5)):
        np.testing.assert_allclose(o, r, rtol=0, atol=tol * 3, err_msg=what)
    np.testing.assert_array_equal(out[4], [1, 0, 0, 1, 0, 1, 0, 0, 0])
    if compute_iou:
        assert out[2].sum() > 1.5          # the boxes overlap
    else:
        assert not out[2].any()


def test_serving_unchanged_by_a_training_call():
    """A module from ``build_model`` stays in eval mode; its rows do not
    move when another instance runs in training mode, nor when the module
    itself is switched to ``train()`` (the mode flag is never read)."""
    cfg = AttrDict(model=dict(name='mobilenetv3_small', num_classes=9,
                              bf16=False))
    a = build_model(cfg, generator=torch.Generator().manual_seed(0))
    b = build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert not a.training and not b.training
    imgs, kp, cats = _batch()
    x = _t(imgs)
    with torch.no_grad():
        rows = a(x)
        pre = a(x, pre_activation=True)
    stats = b.backbone.blocks_0.BatchNorm_0.running_var.clone()
    b(x, cats=_t(cats, torch.int64), train=True,
      generator=torch.Generator().manual_seed(0))
    assert not torch.equal(b.backbone.blocks_0.BatchNorm_0.running_var,
                           stats)
    with torch.no_grad():
        for out in (a(x), copy.deepcopy(a).train()(x)):
            assert all(torch.equal(o, r) for o, r in zip(out, rows))
        assert all(torch.equal(o, r) for o, r in
                   zip(a(x, pre_activation=True), pre))
    assert not a.training
