"""Training traffic: the port's regressor train step (``make_train_step``
with the config's device augmentations fused in, as the trainer runs it),
back to back on batches of uint8 crops, keypoints and labels made on the
card, from a pool of seeded batches that cycle.  The host loader is left
out: its threads, not the card, would set the pace.

The traffic file gives ``batch``, ``size``, ``pool`` and the process's
host ``threads`` (as for serving); the configuration file the regressor
and its ``train`` settings (the repository config's ``model``,
``optim``, ``loss`` and ``train_data_pipeline``).

Set-up builds the train state once, drives it through its first three
steps, which go through the window's own call on the pool's first three
batches, and hands that same state to the window.  ``correct`` follows
those three steps with the float32 reference from the same weights, the
same batches and the same generator's draws (augmentations and dropout),
and works out, each a share (see :func:`leaf_gaps`):

* each step's loss (``loss_gap``, the first step's ``loss_gap_first``);
* the first step's gradient as AdamW received it, worked out from its
  first moment after one step, leaf by leaf (``grad_gap`` at the worst
  leaf, ``grad_gap_median`` at the median one);
* the parameters' change over the three steps (``update_gap``), the
  EMA's (``ema_gap``) and the running statistics' (``bn_stat_gap``,
  ``bn_stat_gap_median``).

The configuration's ``limits`` name the numbers compared; the others are
printed beside them.
"""

import math
import time

import numpy as np
import torch

from reference import models as ref_models
from reference import train as ref_train

from . import inputs, weights, yardstick
from .common import busy_intervals, cuda, split as _split
from .common import traced as traced_calls

SETUP_STEPS = 3
HOST_STEPS = 2    # steps traced with the host's operations too
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam, and is left out
GRAD_FLOOR = 1e-3


def aug_params(tcfg):
    """The reference's augmentation settings from the config's
    ``train_data_pipeline``, which must be the sequence it computes."""
    steps = [(name, dict(kw)) for name, kw in tcfg['train_data_pipeline']]
    names = [n for n, _ in steps]
    expect = ['convert_color', 'horizontal_flip',
              'random_brightness_contrast', 'random_rotate', 'normalize',
              'to_tensor']
    if names != expect:
        raise ValueError(f'the reference computes {expect}, not {names}')
    kw = dict(steps)
    bc = kw['random_brightness_contrast']
    return dict(flip_p=kw['horizontal_flip']['p'],
                brightness=bc.get('brightness_limit', 0.2),
                contrast=bc.get('contrast_limit', 0.2), bc_p=bc['p'],
                angle=kw['random_rotate']['angle_limit'],
                rotate_p=kw['random_rotate']['p'],
                mean=kw['normalize']['mean'], std=kw['normalize']['std'])


def loss_coeffs(tcfg):
    loss = tcfg['loss']
    if list(loss['names']) != ['l1', 'add_loss', 'cross_entropy'] \
            or loss['alwa']['use']:
        raise ValueError('the reference computes l1 + ADD + cross entropy '
                         'without ALWA')
    (c_l1, c_add), (c_ce,) = loss['coeffs']
    return c_l1, c_add, c_ce


def reference_model(cfg, seed, imgs, device):
    """The float32 reference regressor with the benchmark's weights, drawn
    and calibrated on ``imgs`` (uint8 BGR) as the step normalises them,
    and its ``state_dict`` on the host."""
    reg = ref_models.MultiHeadRegressor(cfg['regressor']['backbone'],
                                        cfg['regressor']['num_classes'],
                                        cfg['regressor']['dropout_rate'])
    aug = aug_params(cfg['train'])
    mean = torch.tensor(aug['mean'], device=device) * 255.0
    std = torch.tensor(aug['std'], device=device) * 255.0
    x = (imgs.float().flip(-1) - mean) / std
    sd = weights.make(reg, inputs.stream_seed(seed, 'weights_reg'), device,
                      x)
    return reg, {k: _host(v) for k, v in sd.items()}


def build_state(cfg, sd, device):
    """The port's train state and step with the benchmark's weights."""
    from tpudet3d_torch.core.config import AttrDict
    from tpudet3d_torch.data.transforms import build_augmentations
    from tpudet3d_torch.train.state import create_train_state
    from tpudet3d_torch.train.steps import make_train_step
    tcfg = AttrDict(cfg['train'])
    state = create_train_state(tcfg, device=device,
                               generator=torch.Generator().manual_seed(0))
    state.model.load_state_dict(sd)
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            state.ema_params[k].copy_(p)
    # the loader is left out, so the geometric warp runs on the card too
    aug = build_augmentations(tcfg, host_geometric=False)[0]
    step = make_train_step(state.model, state.loss_manager, state.optimizer,
                           augment_fn=aug, ema_decay=state.ema_decay)
    return state, step


def leaf_gaps(prog, ref, keep=None):
    """Each leaf's ``|‖prog‖ - ‖ref‖|`` over the larger of its ``‖ref‖``
    and the median leaf's (leaves in ``keep`` only, when given), by
    name."""
    names = [k for k in ref if keep is None or k in keep]
    pn = np.array([float(prog[k].double().norm()) for k in names])
    rn = np.array([float(ref[k].double().norm()) for k in names])
    med = float(np.median(rn)) if len(rn) else 0.0
    gap = np.abs(pn - rn) / np.maximum(np.maximum(rn, med), 1e-30)
    return dict(zip(names, np.where(np.isnan(gap), np.inf, gap)))


def summarise(name, gaps, out):
    """``out[name]``: the worst leaf's gap; ``out[name + '_median']``: the
    median leaf's; ``out[name + '_leaf']``: the worst leaf."""
    worst = max(gaps, key=gaps.get) if gaps else None
    out[name] = float(gaps[worst]) if gaps else 0.0
    out[name + '_median'] = float(np.median(list(gaps.values()))) \
        if gaps else 0.0
    out[name + '_leaf'] = worst


def run(ctx):
    """One run of a training cell."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    batch, size = tr['batch'], tr['size']
    torch.set_num_threads(tr['threads'])
    marks = [('start', time.perf_counter())]
    pool = inputs.train_pool(ctx.seed, tr['pool'], batch, size,
                             cfg['regressor']['num_classes'], dev)
    marks.append(('inputs', time.perf_counter()))
    ref, init = reference_model(cfg, ctx.seed,
                                pool[0][0][:tr['calibration_images']], dev)
    marks.append(('weights', time.perf_counter()))
    ref.cpu()
    cuda(dev, torch.cuda.empty_cache)
    cuda(dev, torch.cuda.reset_peak_memory_stats, dev)
    state, step = build_state(cfg, init, dev)
    gen = torch.Generator(device=dev).manual_seed(
        inputs.stream_seed(ctx.seed, 'augment'))
    beta1 = float(cfg['train']['optim']['betas'][0])
    marks.append(('program', time.perf_counter()))
    prog = first_steps(step, state, pool, gen, beta1)
    cuda(dev, torch.cuda.synchronize, dev)
    marks.append(('first steps', time.perf_counter()))
    setup_s = time.perf_counter() - ctx.t0

    steps = SETUP_STEPS
    start = time.perf_counter()
    while True:
        step(state, *pool[steps % len(pool)], gen)
        steps += 1
        if time.perf_counter() - start >= ctx.seconds:
            break
    cuda(dev, torch.cuda.synchronize, dev)
    window_s = time.perf_counter() - start
    done = steps - SETUP_STEPS

    trace = None
    if ctx.trace:
        trace = traced(step, state, pool, gen, steps, cfg, tr, window_s,
                       done, ctx.trace_calls, dev)
    peak = cuda(dev, torch.cuda.max_memory_allocated, dev) or 0
    del state, step
    cuda(dev, torch.cuda.empty_cache)
    numbers = judge(ref, init, pool, prog, cfg, ctx.seed, dev, ctx.control)
    e2e = {'train_images_per_s': done * batch / window_s, 'setup_s': setup_s}
    return dict(e2e=e2e, attempted=done * batch, numbers=numbers,
                memory_peak_bytes=int(peak), trace=trace,
                window=dict(steps=done, window_s=window_s,
                            setup=_split(ctx.t0, marks)))


def first_steps(step, state, pool, gen, beta1):
    """The state's first :data:`SETUP_STEPS` steps, through the window's own
    call on the pool's first batches; what the program made of them, on
    the host: each step's loss, the first gradient as AdamW received it
    (its first moment after one step), and the parameters, the EMA and
    the running statistics after the last."""
    named = list(state.model.named_parameters())
    metrics = []
    for i in range(SETUP_STEPS):
        metrics.append(step(state, *pool[i], gen)[1])
        if i == 0:
            grads = {k: _host(state.optimizer.state[p]['exp_avg'])
                     / (1.0 - beta1) for k, p in named}
    return dict(
        losses=[float(m[0]) for m in metrics],
        grads=grads,
        params={k: _host(p) for k, p in named},
        ema={k: _host(v) for k, v in state.ema_params.items()},
        stats={k: _host(v)
               for k, v in state.model.named_buffers() if 'running' in k})


def judge(ref, init, pool, prog, cfg, seed, dev, control=None):
    """The reference's three steps from the same start; the numbers of
    the module's docstring.  With ``control='fp8'`` the reference's own
    float8 run stands in the program's place."""
    tcfg = cfg['train']
    aug, coeffs = aug_params(tcfg), loss_coeffs(tcfg)
    opt = dict(lr=float(tcfg['optim']['lr']),
               betas=tuple(tcfg['optim']['betas']),
               wd=float(tcfg['optim']['wd']),
               ema_decay=float(tcfg['optim']['ema_decay']))

    def follow(lower):
        ref.load_state_dict(init)
        ref.to(dev)
        trainer = ref_train.Trainer(ref, opt, lower)
        gen = torch.Generator(device=dev).manual_seed(
            inputs.stream_seed(seed, 'augment'))
        losses = []
        for i in range(SETUP_STEPS):
            loss, g = trainer.step(*pool[i], gen, aug, coeffs)
            losses.append(loss)
            if i == 0:
                grads = {k: _host(v) for (k, _), v in
                         zip(ref.named_parameters(), g)}
        return dict(
            losses=losses, grads=grads,
            params={k: _host(p) for k, p in ref.named_parameters()},
            ema={k: _host(e) for (k, _), e in
                 zip(ref.named_parameters(), trainer.ema)},
            stats={k: _host(v) for k, v in ref.named_buffers()
                   if 'running' in k})

    r = follow(None)
    if control == 'fp8':
        prog = follow('fp8')
    gnorm = {k: float(v.double().norm()) for k, v in r['grads'].items()}
    med = float(np.median(list(gnorm.values())))
    keep = {k for k, v in gnorm.items() if v >= GRAD_FLOOR * med}

    def moved(state, key):
        return {k: state[key][k].double() - init[k].double()
                for k in state[key]}

    losses = [abs(p - q) / abs(q) if q else math.inf
              for p, q in zip(prog['losses'], r['losses'])]
    out = dict(loss_gap=max(x if x == x else math.inf for x in losses),
               loss_gap_first=losses[0] if losses[0] == losses[0]
               else math.inf)
    summarise('grad_gap', leaf_gaps(prog['grads'], r['grads'], keep), out)
    summarise('update_gap', leaf_gaps(moved(prog, 'params'),
                                      moved(r, 'params'), keep), out)
    summarise('ema_gap', leaf_gaps(moved(prog, 'ema'), moved(r, 'ema'),
                                   keep), out)
    summarise('bn_stat_gap', leaf_gaps(moved(prog, 'stats'),
                                       moved(r, 'stats')), out)
    out.update(leaves_compared=len(keep), leaves=len(gnorm))
    return out


def traced(step, state, pool, gen, steps, cfg, tr, window_s, done, n, dev):
    """``n`` more steps under ``torch.profiler``; the operations and
    ``bounds`` (the backbone file's kernels' least times, as for serving)
    are of a step over ``tr['batch']`` rows."""
    def call(i):
        step(state, *pool[(steps + i) % len(pool)], gen)

    device, traced_s, bd = traced_calls(call, n, HOST_STEPS, dev,
                                        'train_step')
    size = tr['size']
    with torch.device('meta'):
        reg = ref_models.MultiHeadRegressor(cfg['regressor']['backbone'],
                                            cfg['regressor']['num_classes'])
        flops = yardstick.train_flops(*yardstick.forward_flops(
            reg, torch.empty(tr['batch'], size, size, 3)))
    itemsize = torch.empty((), dtype=getattr(torch, cfg['dtype'])) \
        .element_size()
    return dict(kind='train', events=device, units=n,
                items_per_unit=tr['batch'],
                busy_s=sum(e - s for s, e in busy_intervals(device)) / 1e6,
                window_s=traced_s, unit_wall_s=window_s / done,
                flops_per_unit=flops,
                bounds=yardstick.backbone_bounds(
                    cfg['regressor']['backbone'], tr['batch'], (size, size),
                    itemsize, True, n),
                breakdown=bd)


def _host(t):
    """A copy of ``t`` on the host, never a view of the live state."""
    return t.detach().to('cpu', copy=True)
