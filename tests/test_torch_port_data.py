"""The port's data path against the JAX package's (CPU, cv2 present here).

The same seeds, files and configs go to both packages.  Tolerances:

* datasets (``SyntheticObjectron``, ``SyntheticScene``, ``SceneCrops``,
  ``Objectron``), the host transforms and ``BatchLoader`` batches: bit for
  bit (the same numpy and cv2 calls in the same order), with cv2 and with
  ``_HAS_CV2`` patched off in both packages;
* the device augmentations: the port's ``apply`` is given the parameters
  JAX draws (this file reproduces them from JAX's keys with the
  ``jax.random.split`` sequence of ``apply_pipeline``, ``_maybe`` and each
  transform), and its images and keypoints must match JAX's output within
  1e-5 of their largest magnitude after ``normalize`` / ``to_tensor``
  (measured: at most 1.6e-6, ``color_jitter``'s HSV round trip and the
  contrast mean's order of summation), and a device warp
  (``random_rotate``, ``random_rescale`` with ``host_geometric=False``)
  within 1e-6 × max(h, w): the port inverts the affine in closed form
  where JAX's ``jnp.linalg.inv`` pivots, and an ulp of a source
  coordinate (which grows with the image) times the noise images'
  gradient (up to 255 a pixel) moves a bilinear sample; measured 4.2e-7
  to 5.2e-7 × max(h, w) at 24×32, 40×48 and 64×64 over 4 seeds of 32
  samples.
"""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet3d.core import AttrDict, read_py_config as jax_read_py_config
from tpudet3d.data import dataset as jax_dataset
from tpudet3d.data import host_transforms as jax_host
from tpudet3d.data import loader as jax_loader
from tpudet3d.data import synthetic_scene as jax_scene
from tpudet3d.data import transforms as jax_tf

from tpudet3d_torch.data import dataset, host_transforms, loader
from tpudet3d_torch.data import synthetic_scene, transforms
from torch_port_common import REPO, one_cpu_thread

AUG_TOL = 1e-5
WARP_TOL = 1e-6      # × max(h, w)
NORM = dict(mean=[0.5931, 0.4690, 0.4229], std=[0.2471, 0.2214, 0.2157])


@pytest.fixture(autouse=True)
def _cpu_settings():
    with one_cpu_thread():
        yield


def same_item(a, b):
    """Two dataset items (tuples of arrays, ints and coordinate tuples)
    equal bit for bit, dtypes included."""
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
@pytest.mark.parametrize('mode', ['train', 'test'])
def test_synthetic_objectron_matches_jax(monkeypatch, cv2, mode):
    if not cv2:
        no_cv2(monkeypatch, dataset, jax_dataset)
    kw = dict(length=12, mode=mode, resize=(48, 40), seed=3)
    ours, ref = dataset.SyntheticObjectron(**kw), \
        jax_dataset.SyntheticObjectron(**kw)
    assert len(ours) == len(ref) == 12
    for i in range(len(ref)):
        same_item(ours[i], ref[i])
    img = ours[0][0]
    # without cv2 the image is the noise alone (values below 64)
    assert (img.max() >= 64) == cv2
    cats = dataset.SyntheticObjectron(category_list=['bike', 'book'],
                                      length=8)
    assert cats.num_classes == 2 and all(cats[i][2] < 2 for i in range(8))


def test_jitter_margins_match_jax():
    for seed, idx, epoch in ((0, 0, 0), (23, 17, 1), (940, 123456, 39)):
        assert np.array_equal(dataset.jitter_margins(seed, idx, epoch),
                              jax_dataset.jitter_margins(seed, idx, epoch))


def _scenes(cache=''):
    kw = dict(length=4, frame_hw=(120, 160), seed=23, cache_dir=cache)
    return synthetic_scene.SyntheticScene(**kw), \
        jax_scene.SyntheticScene(**kw)


def _same_sample(a, b):
    for k in ('img', 'kps2d', 'kps3d', 'labels'):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for x, y in zip(a['plane'], b['plane']):
        assert np.array_equal(x, y)


@pytest.mark.parametrize('cv2', [True, False], ids=['cv2', 'no_cv2'])
def test_synthetic_scene_matches_jax(monkeypatch, cv2):
    if not cv2:
        no_cv2(monkeypatch, synthetic_scene, jax_scene)
    ours, ref = _scenes()
    for i in range(len(ref)):
        _same_sample(ours.sample(i), ref.sample(i))


def test_scene_cache_and_crops_match_jax(tmp_path):
    """Cached and rendered scenes agree (both packages write and read the
    cache), and SceneCrops items in train mode over two epochs (the crop
    jitter moves with the epoch) and in val and test mode."""
    ours, ref = _scenes(str(tmp_path / 'cache'))
    plain, _ = _scenes()
    for i in range(len(ref)):
        got = ours.sample(i)                    # renders, stores
        _same_sample(got, ref.sample(i))        # JAX reads the port's file
        _same_sample(ours.sample(i), plain.sample(i))   # the port reads it
    assert len(list((tmp_path / 'cache').iterdir())) == len(ref)
    for mode in ('train', 'val', 'test'):
        kw = dict(resize=(32, 48), mode=mode)
        crops = synthetic_scene.SceneCrops(ours, **kw)
        ref_crops = jax_scene.SceneCrops(ref, **kw)
        assert len(crops) == len(ref_crops) == 8
        epochs = (0, 1) if mode == 'train' else (0,)
        items = []
        for epoch in epochs:
            crops.set_epoch(epoch)
            ref_crops.set_epoch(epoch)
            for i in range(len(ref_crops)):
                same_item(crops[i], ref_crops[i])
            items.append(crops[1])
        if mode == 'train':
            assert not np.array_equal(items[0][1], items[1][1])


def test_scene_crops_without_cv2_or_with_det_boxes(monkeypatch):
    scene, _ = _scenes()
    # train crops load their self-labelled boxes at once, as in the JAX
    # package (tests/test_torch_port_detect_data.py holds the crops)
    with pytest.raises(FileNotFoundError):
        synthetic_scene.SceneCrops(scene, det_boxes='boxes.npz')
    with pytest.raises(FileNotFoundError):
        jax_scene.SceneCrops(_scenes()[1], det_boxes='boxes.npz')
    # val crops take no self-labelled boxes, as in the JAX package
    synthetic_scene.SceneCrops(scene, mode='val', det_boxes='boxes.npz')
    no_cv2(monkeypatch, synthetic_scene)
    with pytest.raises(RuntimeError, match='cv2'):
        synthetic_scene.SceneCrops(scene)[0]


def _objectron_root(tmp_path):
    """A tiny converted dataset: 4 JPEG frames, 6 annotations of 4
    classes, some keypoints outside the frame (clipped to [3, dim-3])."""
    import cv2
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(4):
        h, w = (96, 128) if i % 2 else (120, 90)
        name = f'frames/img_{i}.jpg'
        (tmp_path / 'frames').mkdir(exist_ok=True)
        cv2.imwrite(str(tmp_path / name),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i, file_name=name, height=h, width=w))
    for a in range(6):
        img = images[a % 4]
        kp = rng.uniform(-5, [img['width'] + 5, img['height'] + 5], (9, 2))
        anns.append(dict(id=a, image_id=img['id'],
                         category_id=[1, 2, 7, 9, 2, 4][a],
                         keypoints=kp.ravel().tolist()))
    (tmp_path / 'annotations').mkdir()
    for split in ('train', 'test'):
        with open(tmp_path / 'annotations' / f'objectron_{split}.json',
                  'w') as f:
            json.dump(dict(images=images, annotations=anns), f)
    return str(tmp_path)


@pytest.mark.parametrize('mode,categories,jitter', [
    ('train', 'all', False), ('train', 'all', True), ('val', 'all', False),
    ('test', ['book', 'chair', 'cup'], False), ('test', 'all', False)])
def test_objectron_matches_jax(tmp_path, mode, categories, jitter):
    root = _objectron_root(tmp_path)
    kw = dict(mode=mode, resize=(40, 56), category_list=categories,
              crop_jitter=jitter, seed=3)
    ours, ref = dataset.Objectron(root, **kw), jax_dataset.Objectron(root, **kw)
    assert len(ours) == len(ref) == (6 if categories == 'all' else 3)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            got, want = ours[i], ref[i]
            same_item(got, want)
            if mode == 'test':
                x0, y0, x1, y1 = got[4]
                assert 0 <= x0 < x1 <= got[0].shape[1]
                assert 0 <= y0 < y1 <= got[0].shape[0]
    if categories != 'all':
        # the nearest class of a reduced list: book, cup, book → 1, 2, 1
        assert [ours[i][3] for i in range(3)] == [1, 2, 1]
    with pytest.raises(RuntimeError, match='mode'):
        dataset.Objectron(root, mode='eval')


def test_objectron_without_cv2(tmp_path, monkeypatch):
    ds = dataset.Objectron(_objectron_root(tmp_path))
    no_cv2(monkeypatch, dataset)
    with pytest.raises(RuntimeError, match='cv2'):
        ds[0]


# --- host transforms ------------------------------------------------------

HOST_PIPE = [('convert_color', {}),
             ('random_rotate', dict(angle_limit=25., p=0.6)),
             ('random_rescale', dict(scale_limit=(-0.2, 0.1), p=0.7)),
             ('normalize', NORM)]


def test_host_transforms_match_jax():
    ours = host_transforms.build_host_pipeline(HOST_PIPE, seed=4)
    ref = jax_host.build_host_pipeline(HOST_PIPE, seed=4)
    rng = np.random.RandomState(1)
    moved = 0
    for epoch in (0, 3):
        for index in range(6):
            img = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
            kps = rng.uniform(0, 40, (9, 2)).astype(np.float32)
            (a, ka), (b, kb) = (ours(epoch, index, img, kps),
                                ref(epoch, index, img, kps))
            assert np.array_equal(a, b) and np.array_equal(ka, kb)
            assert ka.dtype == kb.dtype
            moved += not np.array_equal(ka, kps)
    assert moved > 0
    assert host_transforms.build_host_pipeline([('normalize', NORM)]) is None


def test_host_transforms_without_cv2(monkeypatch):
    no_cv2(monkeypatch, host_transforms, jax_host)
    assert host_transforms.build_host_pipeline(HOST_PIPE) is None
    assert jax_host.build_host_pipeline(HOST_PIPE) is None


# --- the loader -------------------------------------------------------------

def _same_batches(ours, ref, epochs=2):
    n = 0
    for _ in range(epochs):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours) == len(ref)
        for g, w in zip(got, want):
            assert len(g) == len(w) == 4
            for x, y in zip(g[:3], w[:3]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert g[3] == w[3]
            n += 1
    return n


@pytest.mark.parametrize('shuffle,drop_last,pad', [
    (True, True, True), (True, False, True), (False, False, True),
    (False, False, False)])
def test_batch_loader_matches_jax(shuffle, drop_last, pad):
    """13 items at batch 4 over two epochs, the crop jitter of SceneCrops
    (set_epoch) and the host warps keyed by the epoch."""
    scene, ref_scene = _scenes()
    host = host_transforms.build_host_pipeline(HOST_PIPE, seed=2)
    ref_host = jax_host.build_host_pipeline(HOST_PIPE, seed=2)
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_threads=3,
              prefetch=2, seed=9, pad_partial=pad)
    ds = synthetic_scene.SceneCrops(scene, resize=(24, 32))
    ref_ds = jax_scene.SceneCrops(ref_scene, resize=(24, 32))
    ours = loader.BatchLoader(_Cut(ds, 7), 4, host_transform=host, **kw)
    ref = jax_loader.BatchLoader(_Cut(ref_ds, 7), 4, host_transform=ref_host,
                                 **kw)
    n = _same_batches(ours, ref)
    assert n == 2 * (1 if drop_last else 2)
    last = list(ours)[-1]
    if not drop_last:
        assert last[3] == 3 and last[0].shape[0] == (4 if pad else 3)


class _Cut:
    """The first n items of a dataset (set_epoch passed through)."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i >= self.n:
            raise IndexError(i)
        return self.ds[i]

    def set_epoch(self, epoch):
        self.ds.set_epoch(epoch)


class _Failing:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 6:
            raise ValueError('item 6 is broken')
        return np.zeros((2, 2, 3), np.uint8), np.zeros((9, 2), np.float32), 0


def test_batch_loader_reraises_worker_errors():
    for cls in (loader.BatchLoader, jax_loader.BatchLoader):
        with pytest.raises(ValueError, match='item 6'):
            list(cls(_Failing(), 2, num_threads=2))
    # an abandoned iterator stops its producer
    it = iter(loader.BatchLoader(dataset.SyntheticObjectron(length=64,
                                                            resize=(8, 8)),
                                 2, prefetch=1))
    next(it)
    it.close()


def test_batch_loader_reads_its_process_slice(monkeypatch):
    """Without a process group one process reads every index; in a group
    of 2, rank 1 reads every other index of the same shuffled stream."""
    assert loader._process_slice() == (1, 0)
    ds = dataset.SyntheticObjectron(length=10, resize=(8, 8))
    whole = loader.BatchLoader(ds, 2, shuffle=True, seed=3)
    whole_idx = np.concatenate(whole._index_batches())
    monkeypatch.setattr(loader, '_process_slice', lambda: (2, 1))
    half = loader.BatchLoader(ds, 2, shuffle=True, seed=3, pad_partial=False)
    assert np.array_equal(np.concatenate(half._index_batches()),
                          whole_idx[1::2])


def test_build_loader_matches_jax(tmp_path):
    """The synthetic and scene configs: train shuffled with drop_last and
    the host warps, val shuffled with seed + 1, test in order."""
    for synthetic in (True, 'scene'):
        path = tmp_path / f'cfg_{synthetic}.py'
        path.write_text('\n'.join([
            f'exec(open({osp.join(REPO, "configs", "scene_regressor_el0_ema.py")!r}).read())',
            "data['resize'] = (24, 32)", "data['train_batch_size'] = 6",
            "data['val_batch_size'] = 4", "data['num_workers'] = 2",
            f"data['synthetic'] = {synthetic!r}",
            "data['synthetic_length'] = 14", "data['scene_cache'] = ''"]))
        cfg = jax_read_py_config(str(path))
        ours = loader.build_loader(cfg, seed=5)
        ref = jax_loader.build_loader(cfg, seed=5)
        assert ours[0].host_transform is not None
        for o, r, shuffle, drop in zip(ours, ref, (True, True, False),
                                       (True, False, False)):
            assert (o.shuffle, o.drop_last) == (shuffle, drop)
            _same_batches(o, r, epochs=1)


# --- the device augmentations --------------------------------------------

def _draws(name, kw, key):
    """The parameters JAX's ``name`` transform draws from ``key``."""
    uniform = jax.random.uniform
    if name in ('convert_color', 'horizontal_flip', 'normalize', 'to_tensor'):
        return {}
    if name == 'random_brightness_contrast':
        c, b = kw.get('contrast_limit', .2), kw.get('brightness_limit', .2)
        k1, k2 = jax.random.split(key)
        return {'alpha': 1.0 + uniform(k1, minval=-c, maxval=c),
                'beta': uniform(k2, minval=-b, maxval=b) * 255.0}
    if name == 'rgb_shift':
        lim = jnp.array([kw.get(f'{c}_shift_limit', 20) for c in 'rgb'],
                        jnp.float32)
        return {'shift': uniform(key, (3,), minval=-1.0, maxval=1.0) * lim}
    if name == 'hue_saturation_value':
        lims = (kw.get('hue_shift_limit', 20), kw.get('sat_shift_limit', 30),
                kw.get('val_shift_limit', 20))
        return {n: uniform(k, minval=-lim, maxval=lim) for n, k, lim in
                zip(('hue', 'sat', 'val'), jax.random.split(key, 3), lims)}
    if name == 'color_jitter':
        k_perm, *ks = jax.random.split(key, 5)
        out = {'perm': jax.random.randint(k_perm, (), 0, 24)}
        for n, k in zip(('brightness', 'contrast', 'saturation'), ks):
            lim = kw.get(n, .2)
            out[n] = uniform(k, minval=max(0.0, 1.0 - lim), maxval=1.0 + lim)
        out['hue'] = uniform(ks[3], minval=-kw.get('hue', .2),
                             maxval=kw.get('hue', .2))
        return out
    if name == 'blur':
        n = len(list(range(3, int(kw.get('blur_limit', 5)) + 1, 2)) or [3])
        return {'size': jax.random.randint(key, (), 0, n)}
    if name == 'random_rotate':
        lim = kw.get('angle_limit', 10.)
        return {'angle': uniform(key, minval=-lim, maxval=lim)}
    if name == 'random_rescale':
        sl = kw.get('scale_limit', .1)
        lo, hi = (sl[0], sl[1]) if isinstance(sl, (tuple, list)) else (-sl, sl)
        return {'scale': 1.0 + uniform(key, minval=lo, maxval=hi)}
    if name == 'one_of':
        k_pick, k_apply = jax.random.split(key)
        subs = kw['transforms']
        # every branch's parameters from the one key JAX hands the branch
        return {'branch': jax.random.randint(k_pick, (), 0, len(subs)),
                'branches': [_maybe_draws(n, k, k_apply, always=True)
                             for n, k in subs]}
    raise KeyError(name)


def _maybe_draws(name, kw, key, always=False):
    """``_maybe``'s split: ``do`` from the first key, the transform's
    draws from the second; a step with p >= 1 takes the key as it is."""
    p = jax_tf.build_transform(name, kw)[1]
    if p >= 1.0 and not always:
        return _draws(name, kw, key)
    do_key, fn_key = jax.random.split(key)
    out = _draws(name, kw, fn_key)
    out['do'] = jax.random.uniform(do_key) < p
    return out


def _jax_params(steps, key, n):
    """Per-sample parameters of a batch, as ``build_augmentations`` splits
    its key: one key a sample, then one a step (``apply_pipeline``)."""
    def one(k):
        keys = jax.random.split(k, max(len(steps), 1))
        return [_maybe_draws(name, kw, kk) for (name, kw), kk in
                zip(steps, keys)]
    return jax.vmap(one)(jax.random.split(key, n))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _compare_pipeline(pipeline, host_geometric, n=8, hw=(24, 32), seed=0):
    cfg = AttrDict(train_data_pipeline=pipeline, test_data_pipeline=[])
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    kps = rng.uniform(0, min(hw), (n, 9, 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref_fn, _ = jax_tf.build_augmentations(cfg, host_geometric=host_geometric)
    ref_i, ref_k = jax.jit(ref_fn)(jnp.asarray(imgs), jnp.asarray(kps), key)
    skip = jax_tf._HOST_ONLY | (jax_tf._HOST_GEOMETRIC if host_geometric
                                else set())
    steps = [(name, kw) for name, kw in pipeline if name not in skip]
    ours, _ = transforms.build_augmentations(cfg,
                                             host_geometric=host_geometric)
    assert len(ours.steps) == len(steps)
    params = _torch_tree(_jax_params(steps, key, n))
    out_i, out_k = ours.apply(torch.from_numpy(imgs), torch.from_numpy(kps),
                              params)
    assert out_i.dtype == out_k.dtype == torch.float32
    warps = any(name in jax_tf._HOST_GEOMETRIC for name, _ in steps)
    assert _rel(out_i, ref_i) <= (WARP_TOL * max(hw) if warps else AUG_TOL)
    assert _rel(out_k, ref_k) <= AUG_TOL
    return params


ENTRIES = {
    'convert_color': ('convert_color', {}),
    'horizontal_flip': ('horizontal_flip', dict(p=0.5)),
    'random_brightness_contrast': ('random_brightness_contrast',
                                   dict(brightness_limit=0.3, p=0.5)),
    'rgb_shift': ('rgb_shift', dict(r_shift_limit=30, p=0.5)),
    'hue_saturation_value': ('hue_saturation_value', dict(p=0.5)),
    'color_jitter': ('color_jitter', dict(hue=0.3, p=0.5)),
    'blur': ('blur', dict(blur_limit=7, p=0.5)),
    'random_rotate': ('random_rotate', dict(angle_limit=30., p=0.5)),
    'random_rescale': ('random_rescale', dict(scale_limit=0.2, p=0.5)),
    'one_of': ('one_of', dict(transforms=[
        ('blur', dict(p=1.0)), ('rgb_shift', dict(p=0.5)),
        ('horizontal_flip', dict(p=1.0))], p=0.7)),
}


@pytest.mark.parametrize('entry', sorted(ENTRIES))
def test_augmentation_matches_jax(entry):
    """Each registry entry (then ``normalize`` and ``to_tensor``) over 8
    samples of 24×32, given JAX's draws."""
    step = ENTRIES[entry]
    params = _compare_pipeline([step, ('normalize', NORM),
                                ('to_tensor', {})], host_geometric=False)
    if 'do' in params[0]:
        do = params[0]['do']
        assert do.any() and not do.all()    # both sides of _maybe ran
    assert set(transforms.TRANSFORMS_REGISTRY) == \
        set(jax_tf.TRANSFORMS_REGISTRY)


def test_hsv_round_trip_matches_jax():
    """cv2-convention HSV at the ties (v == r == g, grey) and wrapping
    hues, both ways."""
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 256, (64, 3)).astype(np.float32)
    rgb[:8] = [[200, 200, 10], [10, 200, 200], [200, 10, 200], [5, 5, 5],
               [0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    h, s, v = transforms.rgb_to_hsv(torch.from_numpy(rgb))
    jh, js, jv = jax_tf.rgb_to_hsv(jnp.asarray(rgb))
    for a, b in ((h, jh), (s, js), (v, jv)):
        assert _rel(a, b) <= 1e-6
    hue = torch.from_numpy(np.linspace(-400, 800, 64).astype(np.float32))
    back = transforms.hsv_to_rgb(hue, s, v)
    ref = jax_tf.hsv_to_rgb(jnp.asarray(hue.numpy()), js, jv)
    assert _rel(back, ref) <= 1e-6


@pytest.mark.parametrize('host_geometric', [True, False],
                         ids=['host_warps', 'device_warps'])
def test_flagship_train_pipeline_matches_jax(host_geometric):
    """``configs/scene_regressor_el0_ema.py``'s train and test pipelines,
    sample for sample, at 32 samples of 40×48."""
    cfg = jax_read_py_config(osp.join(REPO, 'configs',
                                      'scene_regressor_el0_ema.py'))
    for pipeline in (cfg.train_data_pipeline, cfg.test_data_pipeline):
        _compare_pipeline(pipeline, host_geometric, n=32, hw=(40, 48),
                          seed=3)


def test_pipeline_draws_on_the_generator():
    """The same generator seed gives the same batch; the parameters are
    per sample, on the batch's device."""
    cfg = AttrDict(train_data_pipeline=list(ENTRIES.values()),
                   test_data_pipeline=[])
    aug, _ = transforms.build_augmentations(cfg, host_geometric=False)
    imgs = torch.randint(0, 256, (6, 16, 20, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    kps = torch.rand((6, 9, 2), generator=torch.Generator().manual_seed(1))
    a = aug(imgs, kps * 16, torch.Generator().manual_seed(5))
    b = aug(imgs, kps * 16, torch.Generator().manual_seed(5))
    c = aug(imgs, kps * 16, torch.Generator().manual_seed(6))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    params = aug.sample(6, torch.Generator().manual_seed(5), 'cpu')
    assert params[1]['do'].shape == (6,) and params[5]['perm'].shape == (6,)
