"""The port's training loop, evaluator, snapshots and CLI against the JAX
package (CPU, f32, one CPU thread, TF32 off).

Tolerances, and why:

* the loop (``Trainer`` over ``BatchLoader`` batches with the flagship
  pipeline's augmentations fused into the step, every random step at
  p = 0 so that ``_maybe`` runs and keeps every sample, dropout 0): the
  batches bit for bit; the learning rate each epoch exactly (JAX keeps
  it in float32); every step's loss and running metrics to 1e-5
  relative, tests/test_torch_port_train.py's step tolerance (measured:
  1.3e-7 on the first of 8 steps, at most 1.4e-6 after, though
  parameters that Adam's sign rule moved apart on rounding noise feed
  the later forwards); every final parameter and EMA element within
  1e-6 + 2 · Σ lr_t = 1.28e-2 (Adam moves an element by about lr a step
  whatever its gradient's scale, so two runs whose gradients differ in
  sign on noise elements part by at most 2·lr a step; measured 4.6e-3);
* ``Evaluator.val`` on the same weights and batches: ADD, SADD and
  accuracy to 1e-5 relative, the IoU to 1e-2 (the float32 lift of
  keypoints one ulp apart, tests/test_torch_port_box3d.py), the table's
  rows and columns the same;
* snapshots: bit for bit (``save_snap`` → ``resume_from``), the EMA toggle
  and the tolerant restore of a converted JAX snapshot exactly.
"""

import io
import os
import os.path as osp
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet3d import losses as jax_losses
from tpudet3d.core import AttrDict
from tpudet3d.core import meters as jax_meters
from tpudet3d.core import read_py_config as jax_read_py_config
from tpudet3d.data import dataset as jax_dataset
from tpudet3d.data import host_transforms as jax_host
from tpudet3d.data import loader as jax_loader
from tpudet3d.data import transforms as jax_tf
from tpudet3d.eval.evaluator import Evaluator as JaxEvaluator
from tpudet3d.models.mobilenetv3 import MobileNetV3 as JaxMNv3
from tpudet3d.models.wrapper import MultiHeadRegressor as JaxRegressor
from tpudet3d.train import optim as jax_optim
from tpudet3d.train.pipeline import setup_training as jax_setup_training
from tpudet3d.train.state import TrainState as JaxTrainState
from tpudet3d.train.steps import make_eval_step as jax_make_eval_step
from tpudet3d.train.steps import make_train_step as jax_make_train_step
from tpudet3d.train.trainer import Trainer as JaxTrainer
from tpudet3d.utils.checkpoint import save_snap as jax_save_snap

from tpudet3d_torch import losses
from tpudet3d_torch.core import AverageMeter, TextTable
from tpudet3d_torch.data import dataset, host_transforms, loader, transforms
from tpudet3d_torch.eval.evaluator import Evaluator
from tpudet3d_torch.infer import TwoStageEngine, build_engine
from tpudet3d_torch.models import MobileNetV3, build_model
from tpudet3d_torch.models.wrapper import MultiHeadRegressor
from tpudet3d_torch.tools import main as cli
from tpudet3d_torch.train import (build_optimizer, build_scheduler,
                                  create_train_state, current_learning_rate,
                                  make_eval_step, make_train_step)
from tpudet3d_torch.train.pipeline import HostToDevice, setup_training
from tpudet3d_torch.train.trainer import Trainer
from tpudet3d_torch.utils.checkpoint import (load_converted,
                                             load_pretrained_weights,
                                             resume_from, save_snap)
from tpudet3d_torch.utils.convert import jax_to_state_dict, load_jax_variables
from chip_smoke import projected_box_keypoints
from torch_port_common import (REPO, config_file, flax_init, one_cpu_thread,
                               perturb, set_no_tf32)

sys.path.insert(0, osp.join(REPO, 'scripts'))
import snapshot_to_torch  # noqa: E402

# the cut MobileNetV3-large of tests/test_torch_port_train.py
SMALL_CFGS = ((3, 1, 16, 0, 0, 1), (3, 4, 24, 0, 0, 2), (5, 3, 40, 1, 0, 2),
              (3, 6, 80, 0, 1, 2), (3, 6, 112, 1, 1, 1))
SIZE, BATCH, LENGTH, EPOCHS, EMA = 32, 8, 32, 2, 0.9
NORM = dict(mean=[0.5931, 0.4690, 0.4229], std=[0.2471, 0.2214, 0.2157])


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


def loop_cfg():
    """The flagship pipeline with its random steps at p = 0, AdamW,
    multistepLR stepping at epoch 1, ALWA off."""
    return AttrDict(
        optim=dict(name='adam', lr=1e-3, momentum=0.9, wd=1e-4,
                   betas=(0.9, 0.999), rho=0.9, alpha=0.99, nesterov=True),
        scheduler=dict(name='multistepLR', gamma=0.6, exp_gamma=0.975,
                       steps=[1]),
        data=dict(max_epochs=EPOCHS),
        loss=dict(names=['l1', 'add_loss', 'cross_entropy'],
                  coeffs=([1., .1], [.2]), smoothl1_beta=0.2, w=5.18, eps=1.,
                  alwa=dict(use=False, lam_cls=1., lam_reg=1., C=100,
                            compute_std=True)),
        train_data_pipeline=[('convert_color', {}),
                             ('horizontal_flip', dict(p=0.0)),
                             ('random_brightness_contrast', dict(p=0.0)),
                             ('random_rotate', dict(angle_limit=10., p=0.0)),
                             ('normalize', NORM),
                             ('to_tensor', dict(img_shape=(SIZE, SIZE)))],
        test_data_pipeline=[('convert_color', {}), ('normalize', NORM),
                            ('to_tensor', dict(img_shape=(SIZE, SIZE)))])


@pytest.fixture(scope='module')
def weights():
    """A cut MNv3 regressor (dropout 0) with perturbed numpy variables whose
    head biases are the logits of box projections, so that its keypoints
    lift to boxes; and a second, perturbed parameter set as an EMA."""
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
    ema = perturb(v, seed=13)['params']
    ema['head_bias'] = v['params']['head_bias']
    return model, v, ema


def port_model(v):
    return load_jax_variables(MultiHeadRegressor(
        MobileNetV3(cfgs=SMALL_CFGS, mode='large'), dropout_rate=0.0), v)


def jax_state(v, opt, lm, ema=None):
    params = jax.tree_util.tree_map(jnp.asarray, v['params'])
    return JaxTrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v['batch_stats']),
        opt_state=opt.init(params), alwa=lm.init_state(),
        step=jnp.zeros((), jnp.int32),
        ema_params=jax.tree_util.tree_map(
            jnp.asarray, ema if ema is not None else v['params']))


class Recording:
    """A loader that keeps every batch it hands out."""

    def __init__(self, inner):
        self.inner, self.batches = inner, []

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        for b in self.inner:
            self.batches.append(b)
            yield b


class Scalars:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, global_step=None):
        self.rows.append((tag, float(value), global_step))

    def series(self, tag):
        return [(s, v) for t, v, s in self.rows if t == tag]


def _loaders(mode='train', length=LENGTH, seed=5):
    """The port's and JAX's loaders over the same SyntheticObjectron."""
    cfg = loop_cfg()
    kw = dict(length=length, mode=mode, resize=(SIZE, SIZE))
    shuffle, drop = mode == 'train', mode == 'train'
    out = []
    for ds_mod, host_mod, ld_mod in ((dataset, host_transforms, loader),
                                     (jax_dataset, jax_host, jax_loader)):
        host = (host_mod.build_host_pipeline(cfg.train_data_pipeline, seed)
                if mode == 'train' else None)
        out.append(Recording(ld_mod.BatchLoader(
            ds_mod.SyntheticObjectron(**kw), BATCH, shuffle=shuffle,
            drop_last=drop, num_threads=2, seed=seed, host_transform=host)))
    return out


def test_loop_matches_jax_trainer(weights, tmp_path):
    model, v, _ = weights
    cfg = loop_cfg()
    jlm = jax_losses.LossManager(jax_losses.build_loss(cfg), cfg.loss.coeffs,
                                 cfg.loss.alwa)
    opt = jax_optim.build_optimizer(cfg)
    jtrain_aug, _ = jax_tf.build_augmentations(cfg)
    ours_loader, ref_loader = _loaders()
    assert ours_loader.inner.host_transform is not None
    ref_log, log = Scalars(), Scalars()
    ref = JaxTrainer(
        train_step=jax_make_train_step(model, jlm, opt, augment_fn=jtrain_aug,
                                       ema_decay=EMA),
        state=jax_state(v, opt, jlm), train_loader=ref_loader,
        lr_schedule=jax_optim.build_scheduler(cfg), writer=ref_log,
        max_epoch=EPOCHS, log_path=str(tmp_path), save_chkpt=False,
        print_freq=100)

    port = port_model(v)
    lm = losses.LossManager(losses.build_loss(cfg), cfg.loss.coeffs,
                            cfg.loss.alwa)
    state = create_train_state(port, build_optimizer(cfg, port.parameters()),
                               lm, ema_decay=EMA, device='cpu')
    train_aug, _ = transforms.build_augmentations(cfg)
    ours = Trainer(
        train_step=make_train_step(port, lm, state.optimizer,
                                   augment_fn=train_aug, ema_decay=EMA),
        state=state, train_loader=ours_loader,
        lr_schedule=build_scheduler(cfg), writer=log, max_epoch=EPOCHS,
        log_path=str(tmp_path), put_fn=HostToDevice('cpu'),
        generator=torch.Generator().manual_seed(0), save_chkpt=False,
        print_freq=100)
    lrs = []
    for epoch in range(EPOCHS):
        ref.train(epoch, epoch == EPOCHS - 1)
        ours.train(epoch, epoch == EPOCHS - 1)
        lr = current_learning_rate(state.optimizer)
        assert np.float32(lr) == jax_optim.current_learning_rate(
            ref.state.opt_state)
        lrs.append(lr)
    assert lrs == [1e-3, 6e-4]

    steps = EPOCHS * (LENGTH // BATCH)
    assert len(ours_loader.batches) == len(ref_loader.batches) == steps
    for a, b in zip(ours_loader.batches, ref_loader.batches):
        for x, y in zip(a[:3], b[:3]):
            assert np.array_equal(x, y)
        assert a[3] == b[3] == BATCH
    for tag in ('Train/loss', 'Train/ADD', 'Train/SADD', 'Train/ACC'):
        got, want = log.series(tag), ref_log.series(tag)
        assert [s for s, _ in got] == [s for s, _ in want] == \
            list(range(steps))
        for (s, g), (_, w) in zip(got, want):
            assert abs(g - w) <= 1e-5 * max(abs(w), 1e-3), (tag, s, g, w)
    assert int(state.step) == steps
    bound = 1e-6 + 2 * sum(lrs) * (LENGTH // BATCH)
    ref_p = jax_to_state_dict({'params': jax.device_get(ref.state.params)})
    ref_e = jax_to_state_dict({'params': jax.device_get(
        ref.state.ema_params)})
    moved = 0
    for name, p in port.named_parameters():
        err = (p.detach() - ref_p[name]).abs().max().item()
        assert err <= bound, (name, err)
        assert (state.ema_params[name] - ref_e[name]).abs().max().item() \
            <= bound, name
        moved += not torch.equal(p.detach(), torch.from_numpy(
            np.asarray(jax_to_state_dict({'params': v['params']})[name])))
    assert moved > 0


def _table_cells(text):
    """The rows of the last printed table, split into cells."""
    lines = [ln for ln in text.splitlines() if ln.startswith('|')]
    return [[c.strip() for c in ln.strip('|').split('|')] for ln in lines]


@pytest.mark.parametrize('compute_iou', [True, False])
def test_evaluator_val_matches_jax(weights, compute_iou):
    """12 validation items at batch 8 (a padded tail of 4) through the test
    pipeline; the EMA is what both validate."""
    model, v, ema = weights
    cfg = loop_cfg()
    ours_loader, ref_loader = _loaders('val', length=12)
    _, jtest = jax_tf.build_augmentations(cfg)
    jlm = jax_losses.LossManager(jax_losses.build_loss(cfg), cfg.loss.coeffs,
                                 cfg.loss.alwa)
    jstate = jax_state(v, jax_optim.build_optimizer(cfg), jlm, ema)
    ref = JaxEvaluator(eval_step=jax_make_eval_step(model),
                       state_fn=lambda: jstate, val_loader=ref_loader,
                       test_loader=None, test_transform=jax.jit(jtest))
    port = port_model(v)
    lm = losses.LossManager(losses.build_loss(cfg), cfg.loss.coeffs,
                            cfg.loss.alwa)
    state = create_train_state(port, build_optimizer(cfg, port.parameters()),
                               lm, ema_decay=EMA, device='cpu')
    ema_sd = jax_to_state_dict({'params': ema})
    for k in state.ema_params:
        state.ema_params[k].copy_(ema_sd[k])
    _, test_aug = transforms.build_augmentations(cfg)
    ours = Evaluator(eval_step=make_eval_step(port), state_fn=lambda: state,
                     val_loader=ours_loader, test_loader=None,
                     test_transform=test_aug, put_fn=HostToDevice('cpu'))
    texts = []
    for ev in (ours, ref):
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = ev.val(epoch=3, compute_iou=compute_iou)
        texts.append((res, buf.getvalue()))
    (got, text), (want, ref_text) = texts
    assert ours_loader.batches[-1][3] == ref_loader.batches[-1][3] == 4
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-5, 1e-2)):
        assert abs(g - w) <= tol * max(abs(w), 1.0), (got, want)
    rows, ref_rows = _table_cells(text), _table_cells(ref_text)
    assert len(rows) == len(ref_rows) == 11
    assert rows[0] == ref_rows[0]
    assert len(rows[0]) == (5 if compute_iou else 4)
    for r, q in zip(rows[1:], ref_rows[1:]):
        assert r[0] == q[0]
        for i, (a, b) in enumerate(zip(r[1:], q[1:])):
            tol = 1e-2 if i == 3 else 2e-4    # '.4f' cells round
            assert abs(float(a) - float(b)) <= tol, (r, q)
    assert 'epoch: 3' in text


def test_meters_and_table_match_jax():
    ours, ref = AverageMeter(), jax_meters.AverageMeter()
    for val, n in ((1.5, 2), (np.float32(0.25), 3), (7, 1)):
        ours.update(val, n)
        ref.update(val, n)
    assert (ours.val, ours.avg, ours.sum, ours.count) == \
        (ref.val, ref.avg, ref.sum, ref.count)
    rows = [['Average metrics', np.float32(0.14255956), 0.5, 3],
            ['a much longer category', 12.0, np.float64(1e-5), 'x']]
    t, r = TextTable(['name', 'ADD', 'SADD', 'n']), \
        jax_meters.TextTable(['name', 'ADD', 'SADD', 'n'])
    for row in rows:
        t.add_row(row)
        r.add_row(row)
    assert str(t) == str(r)
    with pytest.raises(ValueError):
        t.add_row([1])


def test_trainer_raises_on_non_finite_metrics(tmp_path):
    class Loader:
        def __len__(self):
            return 2

        def __iter__(self):
            for _ in range(2):
                yield (np.zeros((2, 4, 4, 3), np.uint8),
                       np.zeros((2, 9, 2), np.float32),
                       np.zeros(2, np.int32), 2)

    state = type('S', (), {'optimizer': torch.optim.SGD(
        [torch.nn.Parameter(torch.zeros(1))], lr=0.1)})()

    def step(state, imgs, kps, cats, gen):
        return state, torch.tensor([float('nan'), 0.0, 0.0, 1.0])

    trainer = Trainer(train_step=step, state=state, train_loader=Loader(),
                      lr_schedule=None, writer=None, max_epoch=1,
                      log_path=str(tmp_path), put_fn=HostToDevice('cpu'),
                      generator=torch.Generator())
    with pytest.raises(FloatingPointError,
                       match=r'non-finite training metrics at step 0: '
                             r'loss=nan ADD=0.0 SADD=0.0 acc=1.0 \(lr=0.1\)'):
        trainer.train(0, True)


# --- snapshots --------------------------------------------------------------

def _trained_state(v, ema_decay, steps=2, seed=0):
    """A port state that has taken ``steps`` train steps (the optimizer
    holds moments, the EMA differs from the weights)."""
    cfg = loop_cfg()
    port = port_model(v)
    lm = losses.LossManager(losses.build_loss(cfg), cfg.loss.coeffs,
                            cfg.loss.alwa)
    state = create_train_state(port, build_optimizer(cfg, port.parameters()),
                               lm, ema_decay=ema_decay, device='cpu')
    step = make_train_step(port, lm, state.optimizer, ema_decay=ema_decay)
    rng = np.random.RandomState(seed)
    for i in range(steps):
        imgs = torch.from_numpy(rng.standard_normal(
            (4, SIZE, SIZE, 3)).astype(np.float32))
        kp = torch.from_numpy(projected_box_keypoints(4, seed=seed + i))
        state, _ = step(state, imgs, kp, torch.tensor([0, 3, 5, 3]),
                        torch.Generator().manual_seed(i))
    return state


def _fields(state):
    sd = {k: v.clone() for k, v in state.model.state_dict().items()
          if not k.endswith('num_batches_tracked')}
    opt = state.optimizer.state_dict()['state']
    return dict(sd=sd, opt={i: {k: torch.as_tensor(t).clone() for k, t in
                                s.items()} for i, s in opt.items()},
                alwa={k: getattr(state.alwa, k).clone() for k in
                      ('lam_cls', 'lam_reg', 'sum_cls', 'sumsq_cls',
                       'sum_reg', 'sumsq_reg', 'count')},
                step=state.step.clone(),
                ema=None if state.ema_params is None else
                {k: t.clone() for k, t in state.ema_params.items()})


def _assert_same(a, b, keys=('sd', 'opt', 'alwa', 'step', 'ema')):
    for key in keys:
        x, y = a[key], b[key]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
            continue
        assert x.keys() == y.keys(), key
        for k in x:
            if isinstance(x[k], dict):
                for kk in x[k]:
                    assert torch.equal(x[k][kk], y[k][kk]), (key, k, kk)
            else:
                assert torch.equal(x[k], y[k]), (key, k)


def test_save_snap_resume_exact(weights, tmp_path, capsys):
    _, v, _ = weights
    state = _trained_state(v, EMA)
    saved = _fields(state)
    path = save_snap(state, 3, str(tmp_path))
    assert path.endswith('snap_3.pt')
    raw = torch.load(path, weights_only=True)
    assert raw['kind'] == 'regressor' and raw['epoch'] == 3
    assert {'optimizer', 'alwa', 'step'} <= raw.keys()
    snap = load_converted(path, kind='regressor')
    for k, t in snap['ema_params'].items():     # EMA and the same statistics
        assert torch.equal(t, saved['ema'].get(k, saved['sd'][k]))
    fresh = _trained_state(v, EMA, steps=0)
    _, start = resume_from(fresh, str(tmp_path / 'snap_3.pt'))
    assert start == 4 and 'Loaded full train state' in capsys.readouterr().out
    _assert_same(_fields(fresh), saved)
    # the optimizer goes on as it would have
    step = make_train_step(fresh.model, fresh.loss_manager, fresh.optimizer,
                           ema_decay=EMA)
    step2 = make_train_step(state.model, state.loss_manager, state.optimizer,
                            ema_decay=EMA)
    imgs = torch.ones((4, SIZE, SIZE, 3))
    kp = torch.from_numpy(projected_box_keypoints(4, seed=1))
    cats = torch.tensor([1, 2, 3, 4])
    step(fresh, imgs, kp, cats, torch.Generator().manual_seed(5))
    step2(state, imgs, kp, cats, torch.Generator().manual_seed(5))
    _assert_same(_fields(fresh), _fields(state))


@pytest.mark.parametrize('saved_ema,config_ema', [(True, False),
                                                  (False, True)],
                         ids=['drop', 'seed'])
def test_resume_toggles_ema(weights, tmp_path, capsys, saved_ema,
                            config_ema):
    _, v, _ = weights
    state = _trained_state(v, EMA if saved_ema else 0.0)
    saved = _fields(state)
    save_snap(state, 0, str(tmp_path))
    fresh = _trained_state(v, EMA if config_ema else 0.0, steps=0)
    _, start = resume_from(fresh, str(tmp_path / 'snap_0'))
    assert start == 1 and 'toggled' in capsys.readouterr().out
    _assert_same(_fields(fresh), saved, ('sd', 'opt', 'alwa', 'step'))
    if config_ema:
        for k, p in fresh.model.named_parameters():
            assert torch.equal(fresh.ema_params[k], p.detach())
    else:
        assert fresh.ema_params is None


def test_resume_converted_jax_snapshot(tmp_path, capsys):
    """A JAX ``save_snap`` converted by ``scripts/snapshot_to_torch.py``
    has no optimizer: the tolerant path restores weights, statistics and
    EMA exactly, reports the fresh optimizer and resumes at epoch + 1."""
    cfg_path = config_file(tmp_path / 'cfg.py', 'scene_regressor.py',
                           "data['resize'] = (32, 32)",
                           "data['train_batch_size'] = 2",
                           "model['name'] = 'mobilenetv3_small'",
                           "model['bf16'] = False",
                           "optim['ema_decay'] = 0.99",
                           f"output_dir = {str(tmp_path / 'out')!r}")
    jcfg = jax_read_py_config(cfg_path)
    jstate = jax_setup_training(jcfg, with_loaders=False).state
    rng = np.random.RandomState(3)
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(
            lambda x: np.asarray(x) + rng.normal(0, .02, np.shape(x))
            .astype(np.float32), jax.device_get(jstate.params)),
        ema_params=jax.tree_util.tree_map(
            lambda x: np.asarray(x) - 0.01, jax.device_get(jstate.params)))
    jax_save_snap(jstate, 6, jcfg.output_dir)
    snapshot_to_torch.main([osp.join(jcfg.output_dir, 'snap_6')])
    capsys.readouterr()
    state = create_train_state(jax_read_py_config(cfg_path), device='cpu')
    _, start = resume_from(state, osp.join(jcfg.output_dir, 'snap_6'))
    out = capsys.readouterr().out
    assert start == 7
    assert 'falling back to weight+stats restore' in out
    assert 'optimizer and ALWA state not restored' in out
    want = jax_to_state_dict({
        'params': jax.device_get(jstate.params),
        'batch_stats': jax.device_get(jstate.batch_stats)})
    got = state.model.state_dict()
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    ema = jax_to_state_dict({'params': jax.device_get(jstate.ema_params)})
    for k, t in state.ema_params.items():
        assert torch.equal(t, ema[k]), k
    assert int(state.step) == 0 and not state.optimizer.state


def test_load_pretrained_weights_reports_and_raises(weights, tmp_path,
                                                    capsys):
    _, v, _ = weights
    state = _trained_state(v, EMA)
    save_snap(state, 1, str(tmp_path))
    snap = load_converted(str(tmp_path / 'snap_1.pt'))
    # another head: 8 classes, so the classifier is skipped
    other = torch.load(str(tmp_path / 'snap_1.pt'), weights_only=True)
    other['params'] = {k: (t[:8] if k.startswith('cls_fc') else t)
                       for k, t in snap['params'].items()}
    torch.save(other, str(tmp_path / 'other.pt'))
    fresh = _trained_state(v, EMA, steps=0)
    load_pretrained_weights(fresh, str(tmp_path / 'other.pt'))
    out = capsys.readouterr().out
    assert re.search(r'skipped 2 unmatched leaves', out)
    sd = fresh.model.state_dict()
    for k, t in snap['params'].items():
        if not k.startswith('cls_fc'):
            assert torch.equal(sd[k], t), k
    assert not fresh.optimizer.state      # weights only
    other['params'] = {'nothing.' + k: t for k, t in
                       snap['params'].items()}
    torch.save(other, str(tmp_path / 'none.pt'))
    with pytest.raises(RuntimeError, match='no matching layers'):
        load_pretrained_weights(fresh, str(tmp_path / 'none.pt'))


def test_build_engine_serves_port_snapshot(tmp_path):
    """``build_engine`` finds the newest ``save_snap`` of ``output_dir`` and
    serves its EMA; its rows equal an engine of the same modules."""
    cfg_path = config_file(tmp_path / 'cfg.py', 'scene_regressor.py',
                           "model['name'] = 'mobilenetv3_small'",
                           "model['bf16'] = False",
                           "optim['ema_decay'] = 0.9",
                           f"output_dir = {str(tmp_path / 'out')!r}")
    cfg = jax_read_py_config(cfg_path)
    state = create_train_state(cfg, device='cpu',
                               generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for k, e in state.ema_params.items():
            e.add_(0.01)
    save_snap(state, 0, cfg.output_dir)
    save_snap(state, 2, cfg.output_dir)
    engine = build_engine(cfg_path, det_conf=0.0, device='cpu')
    served = engine.reg_model.state_dict()
    for k, t in state.model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(served[k], state.ema_params.get(k, t)), k
    reg = build_model(cfg)
    reg.load_state_dict(dict(state.model.state_dict(), **state.ema_params))
    memory = TwoStageEngine(engine.det_model, reg, engine.cfg, device='cpu')
    frames = np.random.RandomState(0).randint(0, 256, (2, 120, 160, 3)) \
        .astype(np.uint8)
    got, want = engine.infer_batch(frames), memory.infer_batch(frames)
    assert sum(len(r['scores']) for r in got) > 0
    for r, q in zip(got, want):
        for k in r:
            assert np.array_equal(r[k], q[k]), k


# --- the CLI ----------------------------------------------------------------

def _cli_config(tmp_path, name, *extra):
    return config_file(
        tmp_path / f'{name}.py', 'scene_regressor_el0_ema.py',
        "data.update(resize=(32, 32), train_batch_size=8, val_batch_size=8, "
        "max_epochs=2, synthetic=True, synthetic_length=24, num_workers=2)",
        "model.update(name='mobilenetv3_small', bf16=False)",
        "utils.update(save_freq=1, eval_freq=1, print_freq=1)",
        f"output_dir = {str(tmp_path / 'out')!r}", *extra)


def _run_cli(monkeypatch, capsys, *argv):
    monkeypatch.setattr(cli, 'make_writer', lambda d: None)
    cli.main(list(argv))
    return capsys.readouterr().out


def test_cli_trains_resumes_and_evaluates(tmp_path, monkeypatch, capsys):
    out_dir = tmp_path / 'out'
    text = _run_cli(monkeypatch, capsys, '--config',
                    _cli_config(tmp_path, 'train'), '--device', 'cpu')
    files = os.listdir(out_dir)
    assert {'dumped_config.py', 'snap_0.pt', 'snap_1.pt'} <= set(files)
    logs = [f for f in files if f.startswith('train.log-')]
    assert len(logs) == 1
    assert open(out_dir / logs[0]).read() == text   # the stdout tee
    # the visual test draws the 6 test items, truth and prediction
    assert len([f for f in files if f.startswith('tested_image_')]) == 12
    assert 'epoch: [0/2][0/3]' in text and 'epoch: [1/2][2/3]' in text
    assert text.count('Computed val metrics') == 2
    assert text.count('IOU') == 1                  # on the last epoch only
    # resume from epoch 0: validates first, then trains epoch 1 alone
    resume = _cli_config(tmp_path, 'resume',
                         f"model['resume'] = {str(out_dir / 'snap_0.pt')!r}",
                         f"output_dir = {str(tmp_path / 'out2')!r}")
    text = _run_cli(monkeypatch, capsys, '--config', resume, '--device',
                    'cpu', '--wo_saving_checkpoint')
    assert 'Loaded full train state; last epoch = 1' in text
    assert text.index('Computed val metrics') < text.index('epoch: [1/2]')
    assert 'epoch: [0/2]' not in text
    assert not [f for f in os.listdir(tmp_path / 'out2')
                if f.startswith('snap_')]
    # the evaluation regime: validation with the IoU and the visual test
    evaluate = _cli_config(tmp_path, 'eval',
                           "regime['type'] = 'evaluation'",
                           f"model['load_weights'] = "
                           f"{str(out_dir / 'snap_1.pt')!r}",
                           f"output_dir = {str(tmp_path / 'out3')!r}")
    text = _run_cli(monkeypatch, capsys, '--config', evaluate, '--device',
                    'cpu')
    assert 'Run evaluating protocol' in text and 'IOU' in text
    assert 'Successfully loaded' in text and 'epoch: [' not in text
    files = os.listdir(tmp_path / 'out3')
    assert any(f.startswith('test.log-') for f in files)
    assert len([f for f in files if f.startswith('tested_image_')]) == 12


def test_setup_training_reference_weights(tmp_path, capsys, monkeypatch):
    cfg_path = _cli_config(tmp_path, 'pre', "model['pretrained'] = True")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv('TPUDET3D_PRETRAINED_DIR', raising=False)
    cfg = jax_read_py_config(cfg_path)
    pipe = setup_training(cfg, device='cpu', with_loaders=False)
    assert 'training from random init' in capsys.readouterr().out
    assert pipe.train_loader is None and pipe.device == torch.device('cpu')
    cfg.model.load_weights = str(tmp_path / 'imagenet.pth')
    with pytest.raises(NotImplementedError, match='Queue 1 item 4'):
        setup_training(cfg, device='cpu', with_loaders=False)
