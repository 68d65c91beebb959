"""The port's detector data path, self-labelling and CLIs against the JAX
package's (CPU, cv2 present here).

The same seeds, files and weights go to both packages.  Tolerances:

* ``SyntheticDetection`` (easy and hard), ``DetectionDataset`` (a COCO
  JSON with JPEGs written here), ``SceneDetection``, the host Expand +
  MinIoURandomCrop, ``_DetBatchLoader`` batches over two epochs,
  ``write_eval_shards`` and ``SceneCrops(det_boxes=...)`` items over two
  epochs: bit for bit (the same numpy and cv2 calls in the same order),
  with cv2 and with ``_HAS_CV2`` patched off in both packages where the
  JAX package gates on it;
* the device augmentations: the port's ``apply`` is given the draws JAX
  makes (re-derived here from JAX's keys with the ``jax.random.split``
  sequence of ``det_transforms.py``) and matches JAX's images within 1e-5
  of their largest magnitude (the grey mean's order of summation) and its
  boxes exactly;
* ``match_boxes_to_gt`` exactly; ``generate_selflabel_boxes``' npz on one
  converted snapshot, both detectors run in float32: the same keys, the
  same valid mask and the boxes within 1e-3 px;
* the CLIs: the files, the log lines and ``--resume auto`` at epoch + 1.
"""

import importlib.util
import json
import os
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudet3d.data import det_host_transforms as jax_host
from tpudet3d.data import det_transforms as jax_aug
from tpudet3d.data import detection_dataset as jax_ds
from tpudet3d.data import selflabel as jax_selflabel
from tpudet3d.data import synthetic_scene as jax_scene
from tpudet3d.detect import SSDDetector as JaxSSD
import tpudet3d.detect as jax_detect
from tpudet3d.detect.train import create_detector_state as jax_create_state
from tpudet3d.utils.checkpoint import save_snap as jax_save_snap

import tpudet3d_torch.detect as port_detect
from tpudet3d_torch.data import det_host_transforms, det_transforms
from tpudet3d_torch.data import detection_dataset, selflabel, synthetic_scene
from tpudet3d_torch.tools import selflabel_boxes as selflabel_cli
from tpudet3d_torch.tools import train_detector as train_cli
from torch_port_common import REPO, config_file, one_cpu_thread, perturb

sys.path.insert(0, osp.join(REPO, 'scripts'))
import snapshot_to_torch  # noqa: E402

AUG_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_settings():
    with one_cpu_thread():
        yield


def same_item(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def no_cv2(monkeypatch, *modules):
    for m in modules:
        monkeypatch.setattr(m, '_HAS_CV2', False)


# --- datasets -------------------------------------------------------------

@pytest.mark.parametrize('cv2', [True, False], ids=['cv2', 'no_cv2'])
@pytest.mark.parametrize('hard', [False, True], ids=['easy', 'hard'])
def test_synthetic_detection_matches_jax(monkeypatch, cv2, hard):
    if not cv2:
        no_cv2(monkeypatch, detection_dataset, jax_ds)
    kw = dict(length=6, input_size=96, max_boxes=4, seed=3, hard=hard)
    ours, ref = (detection_dataset.SyntheticDetection(**kw),
                 jax_ds.SyntheticDetection(**kw))
    assert len(ours) == len(ref) == 6
    for i in range(6):
        same_item(ours[i], ref[i])
    # without cv2 nothing is drawn over the dim noise
    assert (ours[0][0].max() >= 64) == cv2


def _coco_root(tmp_path):
    import cv2 as cv
    rng = np.random.RandomState(0)
    (tmp_path / 'annotations').mkdir()
    (tmp_path / 'images').mkdir()
    for mode in ('train', 'test'):
        images, anns = [], []
        for i in range(3):
            h, w = (120, 160) if i % 2 else (90, 70)
            name = f'images/{mode}_{i}.jpg'
            cv.imwrite(str(tmp_path / name),
                       rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            images.append({'id': i + 1, 'file_name': name, 'height': h,
                           'width': w})
            for j in range(i + 1):
                bw, bh = rng.uniform(5, w / 2), rng.uniform(10, h / 2)
                anns.append({'image_id': i + 1, 'category_id': 1 + j,
                             'bbox': [rng.uniform(0, w / 2),
                                      rng.uniform(0, h / 2), bw, bh]})
        with open(tmp_path / 'annotations' / f'objectron_{mode}.json',
                  'w') as f:
            json.dump({'images': images, 'annotations': anns}, f)
    return tmp_path


@pytest.mark.parametrize('mode', ['train', 'test'])
def test_detection_dataset_matches_jax(tmp_path, mode):
    root = _coco_root(tmp_path)
    kw = dict(mode=mode, input_size=64, min_size=17, max_boxes=2)
    ours, ref = (detection_dataset.DetectionDataset(root, **kw),
                 jax_ds.DetectionDataset(root, **kw))
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        same_item(ours[i], ref[i])


def _scene(mod, length=4):
    return mod.SyntheticScene(length=length, frame_hw=(120, 160), seed=23)


@pytest.mark.parametrize('cv2', [True, False], ids=['cv2', 'no_cv2'])
def test_scene_detection_matches_jax(monkeypatch, cv2):
    if not cv2:
        no_cv2(monkeypatch, synthetic_scene, jax_scene)
    ours = synthetic_scene.SceneDetection(_scene(synthetic_scene),
                                          input_size=96)
    ref = jax_scene.SceneDetection(_scene(jax_scene), input_size=96)
    for i in range(len(ref)):
        same_item(ours[i], ref[i])
    assert synthetic_scene.REGRESSOR_TO_DETECTOR_CLS == \
        jax_scene.REGRESSOR_TO_DETECTOR_CLS


def test_write_eval_shards_byte_identical(tmp_path):
    kw = dict(per_class=3, frame_hw=(96, 128), seed=5)
    synthetic_scene.write_eval_shards(str(tmp_path / 'ours'),
                                      ['bike', 'cup'], **kw)
    jax_scene.write_eval_shards(str(tmp_path / 'ref'), ['bike', 'cup'], **kw)
    for cls in ('bike', 'cup'):
        a = (tmp_path / 'ours' / cls / 'shard-00000').read_bytes()
        b = (tmp_path / 'ref' / cls / 'shard-00000').read_bytes()
        assert len(b) > 0 and a == b


# --- the host pipeline and the loader ---------------------------------------

def test_det_host_pipeline_matches_jax():
    ours = det_host_transforms.build_detection_host_pipeline(96, seed=4)
    ref = jax_host.build_detection_host_pipeline(96, seed=4)
    ds = jax_ds.SyntheticDetection(length=6, input_size=96, max_boxes=4)
    changed = 0
    for epoch in (0, 3):
        for index in range(6):
            item = ds[index]
            a, b = ours(epoch, index, *item), ref(epoch, index, *item)
            same_item(a, b)
            changed += not np.array_equal(a[1], item[1])
    assert changed > 0
    assert det_host_transforms.build_detection_host_pipeline(
        96, enable=False) is None


def test_det_host_pipeline_without_cv2(monkeypatch):
    no_cv2(monkeypatch, det_host_transforms, jax_host)
    assert det_host_transforms.build_detection_host_pipeline() is None
    assert jax_host.build_detection_host_pipeline() is None


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        'train_detector_cli', osp.join(REPO, 'scripts', 'train_detector.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('host', [True, False], ids=['host_aug', 'plain'])
def test_det_batch_loader_matches_jax(host):
    """10 hard items at batch 4 over two epochs, shuffled with drop_last
    (the training loader) and in order with a padded tail (validation)."""
    ds = detection_dataset.SyntheticDetection(length=10, input_size=64,
                                              max_boxes=4, hard=True)
    ref_ds = jax_ds.SyntheticDetection(length=10, input_size=64, max_boxes=4,
                                       hard=True)
    fn = det_host_transforms.build_detection_host_pipeline(64, seed=5) \
        if host else None
    ref_fn = jax_host.build_detection_host_pipeline(64, seed=5) \
        if host else None
    jax_cli = _jax_cli()
    for kw in (dict(shuffle=True, drop_last=True),
               dict(shuffle=False, drop_last=False)):
        ours = train_cli._DetBatchLoader(ds, 4, num_threads=3,
                                         host_transform=fn, **kw)
        ref = jax_cli._DetBatchLoader(ref_ds, 4, num_threads=3,
                                      host_transform=ref_fn, **kw)
        n = 0
        for _ in range(2):
            got, want = list(ours), list(ref)
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                assert len(g) == len(w) == 5 and g[4] == w[4]
                for x, y in zip(g[:4], w[:4]):
                    assert x.dtype == y.dtype and np.array_equal(x, y)
                n += 1
        assert n == 2 * (2 if kw['drop_last'] else 3)


# --- the device augmentations -----------------------------------------------

def _jax_draws(key, n, flip_p):
    """The draws of ``det_transforms.build_detector_augmentations``' train
    mode, from its keys."""
    out = {k: [] for k in ('brightness', 'contrast', 'saturation', 'hue',
                           'rot', 'flip')}
    u = jax.random.uniform
    for k in jax.random.split(key, n):
        k1, k2, k3, _ = jax.random.split(k, 4)
        p1, p2, p3, p4 = jax.random.split(k1, 4)
        out['brightness'].append(u(p1, minval=-32.0, maxval=32.0))
        out['contrast'].append(u(p2, minval=0.5, maxval=1.5))
        out['saturation'].append(u(p3, minval=0.5, maxval=1.5))
        out['hue'].append(u(p4, (3,), minval=-18.0, maxval=18.0))
        out['rot'].append(u(k2))
        out['flip'].append(u(k3) < flip_p)
    return {k: torch.from_numpy(np.asarray(jnp.stack(v)))
            for k, v in out.items()}


@pytest.mark.parametrize('rot_p', [0.0, 0.5, 1.0])
@pytest.mark.parametrize('train', [True, False], ids=['train', 'test'])
def test_detector_augmentations_match_jax(train, rot_p):
    n, size = 16, 48
    ds = jax_ds.SyntheticDetection(length=n, input_size=size, max_boxes=4)
    items = [ds[i] for i in range(n)]
    imgs = np.stack([it[0] for it in items])
    boxes = np.stack([it[1] for it in items])
    key = jax.random.PRNGKey(3)
    ref_imgs, ref_boxes = jax.jit(jax_aug.build_detector_augmentations(
        flip_p=0.5, rot_p=rot_p, train=train))(
        jnp.asarray(imgs), jnp.asarray(boxes), key)
    aug = det_transforms.build_detector_augmentations(0.5, rot_p, train)
    params = _jax_draws(key, n, 0.5) if train else {}
    out, out_boxes = aug.apply(torch.from_numpy(imgs),
                               torch.from_numpy(boxes), params)
    ref_imgs = np.asarray(ref_imgs)
    err = np.abs(out.numpy() - ref_imgs).max() / np.abs(ref_imgs).max()
    assert err <= AUG_TOL, err
    np.testing.assert_array_equal(out_boxes.numpy(), np.asarray(ref_boxes))
    if train and rot_p:
        assert not np.array_equal(out_boxes.numpy(), boxes)


def test_detector_augmentations_draw_on_the_generator():
    aug = det_transforms.build_detector_augmentations(0.5, 0.5)
    imgs = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8)
    boxes = torch.tensor([[[2.0, 3.0, 20.0, 30.0]]]).expand(8, 1, 4)
    a = aug(imgs, boxes, torch.Generator().manual_seed(1))
    b = aug(imgs, boxes, torch.Generator().manual_seed(1))
    c = aug(imgs, boxes, torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    p = aug.sample(1000, torch.Generator().manual_seed(0), 'cpu')
    assert p['hue'].shape == (1000, 3) and p['flip'].dtype == torch.bool
    assert float(p['brightness'].abs().max()) <= 32.0
    assert 0.4 < float(p['flip'].float().mean()) < 0.6


# --- self-labelling -------------------------------------------------------

def test_match_boxes_to_gt_matches_jax():
    rng = np.random.RandomState(1)
    for p, g in ((0, 0), (0, 3), (4, 0), (6, 3), (3, 6), (12, 5)):
        gt = rng.uniform(0, 100, (g, 2))
        gt = np.concatenate([gt, gt + rng.uniform(10, 60, (g, 2))], 1)
        pred = (gt[rng.randint(0, max(g, 1), p)] if g else
                rng.uniform(0, 100, (p, 4))) + rng.normal(0, 8, (p, 4))
        for thr in (0.25, 0.5):
            a = selflabel.match_boxes_to_gt(pred, gt, thr)
            b = jax_selflabel.match_boxes_to_gt(pred, gt, thr)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.fixture(scope='module')
def det_snapshot(tmp_path_factory):
    """A JAX cascade detector (width 0.25, weights and statistics moved off
    their init) as an orbax snapshot and its converted file."""
    root = tmp_path_factory.mktemp('det')
    model = JaxSSD(num_classes=9, width_mult=0.25, cascade=True)
    state = jax_create_state(model, optax.sgd(0.1), jax.random.PRNGKey(0))
    variables = perturb({'params': jax.device_get(state.params),
                         'batch_stats': jax.device_get(state.batch_stats)},
                        seed=2)
    jax_save_snap(state.replace(**variables), 7, str(root))
    out, = snapshot_to_torch.main([str(root / 'snap_7')])
    return str(root / 'snap_7'), out


def test_generate_selflabel_boxes_matches_jax(tmp_path, monkeypatch,
                                              det_snapshot):
    orbax_dir, converted = det_snapshot
    # float32 on both sides: bf16 rounds differently in each package
    jax_load, port_load = jax_detect.load_detector, port_detect.load_detector
    monkeypatch.setattr(jax_detect, 'load_detector', lambda p, dtype=None,
                        **kw: jax_load(p, dtype=jnp.float32, **kw))
    monkeypatch.setattr(port_detect, 'load_detector', lambda p, dtype=None,
                        **kw: port_load(p, dtype=torch.float32, **kw))
    kw = dict(score_thr=0.05, iou_match=0.25, batch=4)
    ours = selflabel.generate_selflabel_boxes(
        _scene(synthetic_scene, 6), converted, str(tmp_path / 'ours.npz'),
        device='cpu', **kw)
    ref = jax_selflabel.generate_selflabel_boxes(
        _scene(jax_scene, 6), orbax_dir, str(tmp_path / 'ref.npz'), **kw)
    assert ours == ref and ref[1] > 0
    a, b = np.load(tmp_path / 'ours.npz'), np.load(tmp_path / 'ref.npz')
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        if k == 'boxes':
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, rtol=0)
        else:
            np.testing.assert_array_equal(a[k], b[k])
    boxes, valid = selflabel.load_selflabel_boxes(
        str(tmp_path / 'ours.npz'), _scene(synthetic_scene, 6))
    assert boxes.shape == (6, 3, 4) and valid.shape == (6, 3)
    with pytest.raises(ValueError, match='regenerate'):
        selflabel.load_selflabel_boxes(str(tmp_path / 'ours.npz'),
                                       _scene(synthetic_scene, 5))


def _write_boxes(path, scene):
    """Every object's GT extent, shifted, as self-label boxes; one box
    degenerate (under 8 px after the margin) and one object unmatched."""
    h, w = scene.frame_hw
    boxes = np.zeros((len(scene), scene.max_objects, 4), np.float32)
    valid = np.zeros((len(scene), scene.max_objects), bool)
    for i in range(len(scene)):
        s = scene.sample(i)
        kps = s['kps2d'] * np.asarray([w, h], np.float32)
        gt = np.concatenate([kps.min(1), kps.max(1)], 1)
        boxes[i, :len(gt)] = gt + 4.0
        valid[i, :len(gt)] = True
    boxes[0, 0] = [50, 50, 49, 51]
    valid[1, 0] = False
    np.savez(path, boxes=boxes, valid=valid, seed=scene.seed,
             length=len(scene), frame_hw=np.asarray(scene.frame_hw),
             score_thr=0.05, iou_match=0.25)
    return path


def test_scene_crops_with_det_boxes_match_jax(tmp_path):
    path = _write_boxes(str(tmp_path / 'boxes.npz'), _scene(jax_scene))
    kw = dict(resize=(32, 24), det_boxes=path, selflabel_p=0.6)
    ours = synthetic_scene.SceneCrops(_scene(synthetic_scene), **kw)
    ref = jax_scene.SceneCrops(_scene(jax_scene), **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            same_item(ours[i], ref[i])
    # out of training, or without boxes, the ground-truth crops
    val = synthetic_scene.SceneCrops(_scene(synthetic_scene), mode='val',
                                     **kw)
    ref_val = jax_scene.SceneCrops(_scene(jax_scene), mode='val', **kw)
    same_item(val[3], ref_val[3])


# --- the CLIs ---------------------------------------------------------------

def _det_config(tmp_path):
    return config_file(
        tmp_path / 'det_cfg.py', 'detection/mnv2_ssd_300_synthetic_hard.py',
        "data.update(train_batch_size=4, val_batch_size=4, "
        "synthetic_length=8, max_epochs=2, num_workers=2)",
        "model.update(width_mult=0.25, bf16=False)",
        "scheduler.update(warmup_iters=2)",
        "utils.update(print_freq=1, save_freq=1)",
        f"output_dir = {str(tmp_path / 'out')!r}")


def _logs(out):
    return ''.join(open(osp.join(out, f)).read() for f in sorted(
        os.listdir(out)) if f.startswith('det_train.log'))


def test_train_detector_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _det_config(tmp_path)
    out = str(tmp_path / 'out')
    train_cli.main(['--config', cfg, '--device', 'cpu'])
    assert sorted(f for f in os.listdir(out) if f.startswith('snap_')) == \
        ['snap_0.pt', 'snap_1.pt']
    log = _logs(out)
    assert 'det epoch [0/2][0] loss' in log and 'det epoch [1/2][1]' in log
    assert 'val epoch 1: mAP@0.5' in log
    # --resume auto continues after the newest snapshot
    train_cli.main(['--config', cfg, '--device', 'cpu', '--resume', 'auto',
                    '--max_epochs', '3'])
    assert osp.isfile(osp.join(out, 'snap_2.pt'))
    log = _logs(out)
    assert 'resuming detector training at epoch 2' in log
    assert 'det epoch [2/3][0]' in log and 'det epoch [0/3]' not in log
    snap = torch.load(osp.join(out, 'snap_2.pt'), weights_only=True)
    assert snap['kind'] == 'detector' and int(snap['step']) == 6

    # the trained snapshot self-labels a scene config's training scenes
    scene_cfg = config_file(
        tmp_path / 'reg_cfg.py', 'scene_regressor_selflabel.py',
        "data.update(synthetic_length=3, scene_cache='')")
    npz = str(tmp_path / 'boxes.npz')
    matched, total = selflabel_cli.main([
        '--config', scene_cfg, '--det_checkpoint', osp.join(out, 'snap_2'),
        '--out', npz, '--batch', '2', '--device', 'cpu'])
    assert total > 0 and 0 <= matched <= total
    z = np.load(npz)
    assert z['boxes'].shape == (3, 3, 4) and int(z['length']) == 3
