"""Data parallelism of the port (``tpudet3d_torch/parallel``) on the CPU:
two processes of a ``gloo`` group, each fed the rows ``rank::2`` of every
global batch, against one process over the whole batch and against the
JAX package's step over a 2-device mesh; the synchronised batch norm;
a group of one process bit for bit with no group; the evaluators' sums and
mAP under two processes; sharded serving.

The bounds are the JAX package's own (``tests/test_parallel_equivalence.py``):
the loss at step 0 within rtol 1e-4, the parameters after it within a
leaf-wise relative error of 5e-2 (SGD, whose update is linear in the
gradient), the detector's losses over its steps within rtol 5e-2.  Mining
and assignment are discrete, so the detector's parameters are held as a
whole: the update's distance within 5e-2 of the update's norm.  The processes are spawned and
joined with a timeout by ``tpudet3d_torch.parallel.spawn_group``, which
phase 11 of ``chip_smoke.py`` uses on the card; their work is in
``tests/torch_port_parallel_worker.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_parallel_worker as worker
from tpudet3d_torch.parallel import spawn_group
from tpudet3d_torch.tools.cases import projected_box_keypoints, update_err
from torch_port_common import flax_init, one_cpu_thread, perturb

from tpudet3d import losses as jax_losses
from tpudet3d.core import AttrDict
from tpudet3d.data.detection_dataset import SyntheticDetection as JaxSynthDet
from tpudet3d.detect import SSDDetector as JaxSSD
from tpudet3d.detect.train import create_detector_state as jax_det_state
from tpudet3d.detect.train import make_detector_train_step as jax_det_step
from tpudet3d.models.mobilenetv3 import MobileNetV3 as JaxMNv3
from tpudet3d.models.wrapper import MultiHeadRegressor as JaxRegressor
from tpudet3d.parallel import make_mesh, replicate, shard_batch
from tpudet3d.train.state import TrainState as JaxTrainState
from tpudet3d.train.steps import make_train_step as jax_make_train_step
from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.models import MobileNetV3
from tpudet3d_torch.models.wrapper import MultiHeadRegressor
from tpudet3d_torch.parallel import sharding
from tpudet3d_torch.utils.convert import jax_to_state_dict, load_jax_variables

SIZE, REG_BATCH, DET_BATCH = 32, 8, 8
SPAWN_TIMEOUT = 240           # seconds for a whole group's work
TASKS = ('regressor', 'regressor_plain', 'detector', 'detector_plain',
         'sync_bn', 'evaluator')


def spawn(tmpdir, world, tasks):
    """Each rank's results of ``tasks`` from a ``world``-process gloo group
    on the CPU; fails when a process fails or outlives the timeout."""
    return spawn_group(world, 'gloo', 'cpu', worker.run,
                       (str(tmpdir), tuple(tasks)), tmpdir, SPAWN_TIMEOUT)


def _jax_regressor():
    model = JaxRegressor(backbone=JaxMNv3(cfgs=worker.SMALL_CFGS,
                                          mode='large'), dropout_rate=0.0)
    key = jax.random.PRNGKey(0)
    v = perturb(flax_init(model, jnp.zeros((1, SIZE, SIZE, 3)),
                          jnp.zeros((1,), jnp.int32),
                          rngs={'params': key, 'dropout': key}), seed=9)
    kp = projected_box_keypoints(9, seed=9)
    v['params']['head_bias'] = np.log(kp / (1 - kp)).reshape(9, 18) \
        .astype(np.float32)
    v['params']['head_kernel'] = v['params']['head_kernel'] * 0.05
    return model, v


def _inputs(tmpdir):
    """Weights and batches for every task, written for the workers."""
    rng = np.random.RandomState(21)
    jreg, v = _jax_regressor()
    port = load_jax_variables(MultiHeadRegressor(
        MobileNetV3(cfgs=worker.SMALL_CFGS, mode='large')), v)
    torch.save(port.state_dict(), tmpdir / 'regressor.pt')
    steps = worker.REG_STEPS
    kp = projected_box_keypoints(steps * REG_BATCH, seed=5)
    reg_batch = dict(
        imgs=rng.uniform(0, 255, (steps, REG_BATCH, SIZE, SIZE, 3))
        .astype(np.float32),
        kp=(kp * SIZE).reshape(steps, REG_BATCH, 9, 2).astype(np.float32),
        cats=rng.randint(0, 9, (steps, REG_BATCH)).astype(np.int64))
    np.savez(tmpdir / 'regressor_batch.npz', **reg_batch)

    jdet = JaxSSD(num_classes=9, width_mult=0.5)
    dv = perturb(flax_init(jdet, jnp.zeros((1, worker.DET_SIZE,
                                            worker.DET_SIZE, 3))), seed=4)
    det = load_jax_variables(SSDDetector(num_classes=9, width_mult=0.5), dv)
    torch.save(det.state_dict(), tmpdir / 'detector.pt')
    ds = JaxSynthDet(length=worker.DET_STEPS * DET_BATCH,
                     input_size=worker.DET_SIZE, max_boxes=4)
    items = [ds[i] for i in range(len(ds))]
    det_batch = {k: np.stack([it[j] for it in items]).reshape(
        worker.DET_STEPS, DET_BATCH, *items[0][j].shape)
        for j, k in enumerate(('imgs_u8', 'boxes', 'labels', 'valid'))}
    det_batch['imgs'] = (det_batch['imgs_u8'] / 255.0).astype(np.float32)
    np.savez(tmpdir / 'detector_batch.npz', **det_batch)

    np.savez(tmpdir / 'bn.npz',
             x4=(rng.standard_normal((8, 6, 5, 4)) * 2 + 3).astype(np.float32),
             w4=rng.standard_normal((8, 6, 5, 4)).astype(np.float32),
             x2=(rng.standard_normal((8, 6)) - 1).astype(np.float32),
             w2=rng.standard_normal((8, 6)).astype(np.float32),
             gamma=rng.uniform(0.5, 1.5, 6).astype(np.float32),
             beta=rng.normal(0, 0.1, 6).astype(np.float32))

    n_img, max_det = 6, 10
    dets = np.zeros((2, n_img, max_det, 6), np.float32)
    xy = rng.uniform(0, 200, (2, n_img, max_det, 2))
    dets[..., :2] = xy
    dets[..., 2:4] = xy + rng.uniform(10, 80, (2, n_img, max_det, 2))
    dets[..., 4] = np.round(rng.uniform(0, 1, (2, n_img, max_det)), 2)
    dets[..., 5] = rng.randint(0, 3, (2, n_img, max_det))
    gt = dets[..., :4].copy()[:, :, :4] + rng.normal(0, 5, (2, n_img, 4, 4))
    np.savez(tmpdir / 'eval.npz',
             imgs=rng.standard_normal((2, 8, SIZE, SIZE, 3)).astype(np.float32),
             kp=projected_box_keypoints(16, seed=7).reshape(2, 8, 9, 2)
             .astype(np.float32),
             cats=rng.randint(0, 9, (2, 8)).astype(np.int64),
             true_n=np.array([8, 5]),
             dets=dets, gt_boxes=gt.astype(np.float32),
             gt_labels=rng.randint(0, 3, (2, n_img, 4)).astype(np.int64),
             gt_valid=rng.uniform(0, 1, (2, n_img, 4)) < 0.8)
    return (jreg, v), (jdet, dv)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX models, one process's results (no group) and each rank's
    results of two processes."""
    tmpdir = tmp_path_factory.mktemp('dp')
    jax_parts = _inputs(tmpdir)
    with one_cpu_thread():
        single = {t: worker.TASKS[t](str(tmpdir)) for t in TASKS}
    ranks = spawn(tmpdir, 2, TASKS)
    return jax_parts, single, ranks, tmpdir


def _max_rel_err(a, b):
    errs = []
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        errs.append(float(np.max(np.abs(x - y) / np.maximum(np.abs(y),
                                                            1e-3))))
    return max(errs)


def _same_on_ranks(ranks, task, fields):
    for f in fields:
        for k, v in ranks[0][task][f].items():
            assert torch.equal(v, ranks[1][task][f][k]), f'{task} {f} {k}'


def test_regressor_two_processes_match_one(runs):
    _, single, ranks, _ = runs
    one, two = single['regressor'], ranks[0]['regressor']
    np.testing.assert_allclose(two['metrics'][0][0], one['metrics'][0][0],
                               rtol=1e-4)
    np.testing.assert_allclose(np.stack(two['metrics']),
                               np.stack(one['metrics']), rtol=5e-2)
    assert _max_rel_err(two['params_1'], one['params_1']) < 5e-2
    for f in ('stats', 'ema', 'momentum'):
        assert _max_rel_err(two[f], one[f]) < 5e-2, f
    for k, v in one['alwa'].items():
        np.testing.assert_allclose(two['alwa'][k].numpy(), v.numpy(),
                                   rtol=1e-4, err_msg=k)
    # the state every rank keeps stays equal on both
    _same_on_ranks(ranks, 'regressor',
                   ('params', 'stats', 'ema', 'momentum', 'alwa'))
    for r in ranks:
        np.testing.assert_array_equal(np.stack(r['regressor']['metrics']),
                                      np.stack(two['metrics']))


def test_detector_two_processes_match_one(runs):
    _, single, ranks, _ = runs
    one, two = single['detector'], ranks[0]['detector']
    loss_1 = np.stack(one['metrics'])[:, 0]
    loss_2 = np.stack(two['metrics'])[:, 0]
    np.testing.assert_allclose(loss_2[0], loss_1[0], rtol=1e-4)
    np.testing.assert_allclose(loss_2, loss_1, rtol=5e-2)
    # mining and assignment are discrete, so a leaf can move differently
    # (as JAX's 1 vs 8 devices); the update as a whole stays within 5e-2
    start = torch.load(runs[3] / 'detector.pt')
    assert update_err(two['params_1'], one['params_1'], start) < 5e-2
    _same_on_ranks(ranks, 'detector', ('params', 'stats'))


def test_regressor_two_processes_match_jax_mesh(runs, devices):
    """Step 0 of the port's two processes against the JAX package's step
    over a 2-device mesh at the same global batch (dropout 0, no
    augmentations: the packages' random streams differ)."""
    (jmodel, v), _ = runs[0]
    two = runs[2][0]['regressor_plain']
    tmpdir = runs[3]
    batch = np.load(tmpdir / 'regressor_batch.npz')
    cfg = AttrDict(loss=dict(names=['l1', 'add_loss', 'cross_entropy'],
                             coeffs=([1., .1], [1.]), smoothl1_beta=0.2,
                             w=5.18, eps=1., alwa=worker._alwa()))
    jlm = jax_losses.LossManager(jax_losses.build_loss(cfg), cfg.loss.coeffs,
                                 cfg.loss.alwa)
    opt = optax.sgd(worker.LR, momentum=0.9)
    params = jax.tree_util.tree_map(jnp.asarray, v['params'])
    mesh = make_mesh(devices[:2])
    jstate = replicate(JaxTrainState(
        params=params, batch_stats=jax.tree_util.tree_map(
            jnp.asarray, v['batch_stats']),
        opt_state=opt.init(params), alwa=jlm.init_state(),
        step=jnp.zeros((), jnp.int32),
        ema_params=jax.tree_util.tree_map(jnp.copy, params)), mesh)
    jstep = jax_make_train_step(jmodel, jlm, opt, ema_decay=0.9)
    imgs = (batch['imgs'][0] - 127.5) / 64.0
    args = [shard_batch(a, mesh) for a in (
        imgs.astype(np.float32), batch['kp'][0] / SIZE,
        batch['cats'][0].astype(np.int32))]
    jstate, m = jstep(jstate, *args, jax.random.PRNGKey(0))
    # the worker's plain variant normalises as above
    np.testing.assert_allclose(two['metrics'][0][0], float(np.asarray(m)[0]),
                               rtol=1e-4)
    ref = jax_to_state_dict({'params': jax.device_get(jstate.params)})
    assert _max_rel_err(two['params'], ref) < 5e-2


def test_detector_two_processes_match_jax_mesh(runs, devices):
    _, (jdet, dv) = runs[0]
    two = runs[2][0]['detector_plain']
    batch = np.load(runs[3] / 'detector_batch.npz')
    mesh = make_mesh(devices[:2])
    opt = optax.sgd(worker.LR, momentum=0.9)
    jstate = jax_det_state(jdet, opt, jax.random.PRNGKey(0),
                           input_size=worker.DET_SIZE, batch=2)
    jstate = replicate(jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, dv['params']),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, dv['batch_stats']),
        opt_state=opt.init({'model': jax.tree_util.tree_map(
            jnp.asarray, dv['params']), 'balance': jstate.balance})), mesh)
    step = jax_det_step(jdet, opt, use_balance=True,
                        input_size=worker.DET_SIZE)
    arrays = [shard_batch(batch[k][0], mesh)
              for k in ('imgs', 'boxes', 'labels', 'valid')]
    jstate, m = step(jstate, *arrays)
    np.testing.assert_allclose(two['metrics'][0][0], float(np.asarray(m)[0]),
                               rtol=1e-4)
    ref = jax_to_state_dict({'params': jax.device_get(jstate.params)})
    start = torch.load(runs[3] / 'detector.pt')
    assert update_err(two['params'], ref, start) < 5e-2


def test_sync_batch_norm_matches_one_process(runs):
    """Forward, the gradients and the running statistics of the
    synchronised batch norm against one process over the concatenated
    batch, at 1e-5."""
    _, single, ranks, _ = runs
    for name in ('x4', 'x2'):
        one = single['sync_bn'][name]
        for r, res in enumerate(ranks):
            got = res['sync_bn'][name]
            for f in ('y', 'dx'):
                np.testing.assert_allclose(got[f].numpy(),
                                           one[f][r::2].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=f'{name} {f}')
            for f in ('mean', 'var'):
                np.testing.assert_allclose(got[f].numpy(), one[f].numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f'{name} {f}')
        for f in ('dgamma', 'dbeta'):
            total = sum(res['sync_bn'][name][f] for res in ranks)
            np.testing.assert_allclose(total.numpy(), one[f].numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f'{name} {f}')


def test_evaluators_two_processes_match_one(runs):
    _, single, ranks, _ = runs
    for res in ranks:
        np.testing.assert_allclose(res['evaluator']['val'],
                                   single['evaluator']['val'], rtol=1e-6)
        np.testing.assert_array_equal(res['evaluator']['map'],
                                      single['evaluator']['map'])
    assert single['evaluator']['map'][-1] > 0


def test_world_of_one_is_bit_for_bit(tmp_path, runs):
    """A group of one process computes exactly what no group does."""
    _, single, _, tmpdir = runs
    (res,) = spawn(tmpdir, 1, ('regressor', 'sync_bn'))
    for k, v in single['regressor']['params'].items():
        assert torch.equal(res['regressor']['params'][k], v), k
    np.testing.assert_array_equal(np.stack(res['regressor']['metrics']),
                                  np.stack(single['regressor']['metrics']))
    for name in ('x4', 'x2'):
        for f, v in single['sync_bn'][name].items():
            assert torch.equal(res['sync_bn'][name][f], v), (name, f)


def test_no_group_without_parallel_settings(monkeypatch):
    for var in ('WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(var, raising=False)
    cfg = AttrDict(data_parallel=dict(use_parallel=True, num_devices=None))
    assert sharding.maybe_init_distributed(cfg, 'cpu') == torch.device('cpu')
    assert sharding.world() == 1 and sharding.rank() == 0
    assert sharding.local_batch_slice(8) == slice(0, 8, 1)
    off = AttrDict(data_parallel=dict(use_parallel=False,
                                      coordinator_address='127.0.0.1:1',
                                      num_processes=2, process_id=0))
    assert sharding.maybe_init_distributed(off, 'cpu') == torch.device('cpu')
    assert not torch.distributed.is_initialized()
    nccl = AttrDict(data_parallel=dict(coordinator_address='127.0.0.1:1',
                                       num_processes=2, process_id=0))
    with pytest.raises(ValueError, match='nccl'):
        sharding.maybe_init_distributed(nccl, 'cpu', backend='nccl')
    wrong = AttrDict(data_parallel=dict(
        coordinator_address='127.0.0.1:1', num_processes=2, process_id=0,
        num_devices=4))
    with pytest.raises(ValueError, match='num_devices'):
        sharding.maybe_init_distributed(wrong, 'cpu')


def test_sharded_serving_matches_unsharded():
    from tpudet3d_torch.infer.build import build_detector
    from tpudet3d_torch.infer.engine import EngineConfig, TwoStageEngine
    from tpudet3d_torch.models import build_model
    cfg = AttrDict(model=dict(name='mobilenetv3_small', num_classes=9,
                              bf16=False))
    eng = TwoStageEngine(build_detector(width_mult=0.25,
                                        dtype=torch.float32),
                         build_model(cfg),
                         EngineConfig(det_conf=0.0, crop_size=(64, 64)),
                         device='cpu')
    frames = np.random.RandomState(0).randint(0, 256, (4, 96, 128, 3)) \
        .astype(np.uint8)
    with one_cpu_thread():
        ref = eng.infer_batch(frames)
        assert eng.shard(['cpu', 'cpu']) is eng
        out = eng.infer_batch(frames)
        for a, b in zip(ref, out):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        with pytest.raises(ValueError, match='3 % 2'):
            eng.infer_batch(frames[:3])
    # a replica on another device is a copy of both models and the
    # anchors there (here a copy on the same device serves the same rows)
    rep = eng._replica(torch.device('cpu'))
    assert rep.det_model is not eng.det_model and rep._replicas is None
    with one_cpu_thread():
        rows = rep._pipeline_batch(rep._upload(frames), 96, 128)
        np.testing.assert_array_equal(
            rows.numpy(), eng._pipeline_batch(eng._upload(frames), 96,
                                              128).numpy())
    # a new model drops the replicas, as JAX's det_vars setter
    eng.reg_model = eng.reg_model
    assert eng._replicas is None
