"""Work of the port's data-parallel tests, run alike in each process of a
``gloo`` group on the CPU and, with no group, in the test's own process
(tests/test_torch_port_parallel.py).  Imports no JAX: the test hands the
weights and batches over in files under ``tmpdir``, and
``tpudet3d_torch.parallel.spawn_group`` brings each rank's results back.

Each task feeds this process the rows ``rank::world`` of one global batch,
as the port's loader does.
"""

import os
from types import SimpleNamespace

import numpy as np
import torch

from tpudet3d_torch.core import AttrDict
from tpudet3d_torch.parallel import sharding

# a cut MobileNetV3-large (stride 1 and 2, 3×3 and 5×5, SE, both
# activations, the head's BN), as tests/test_torch_port_train.py
SMALL_CFGS = ((3, 1, 16, 0, 0, 1), (3, 4, 24, 0, 0, 2), (5, 3, 40, 1, 0, 2),
              (3, 6, 80, 0, 1, 2), (3, 6, 112, 1, 1, 1))
REG_STEPS, DET_STEPS = 2, 3
DET_SIZE = 64
LR = 0.01


def _rows(a):
    return a[sharding.local_batch_slice(a.shape[0])]


def _alwa():
    return AttrDict(use=True, lam_cls=1., lam_reg=1., C=1, compute_std=False)


def regressor(tmpdir, dropout_rate=0.5, augment=True, steps=REG_STEPS):
    """Steps of the regressor: SGD with momentum, ALWA firing at step 1, an
    EMA; with ``augment`` the tiny config's device augmentations in the
    step and dropout's mask from the generator."""
    from tpudet3d_torch.data.transforms import Pipeline, build_transform
    from tpudet3d_torch.losses import LossManager, build_loss
    from tpudet3d_torch.models import MobileNetV3
    from tpudet3d_torch.models.wrapper import MultiHeadRegressor
    from tpudet3d_torch.train import create_train_state, make_train_step
    model = MultiHeadRegressor(MobileNetV3(cfgs=SMALL_CFGS, mode='large'),
                               dropout_rate=dropout_rate)
    model.load_state_dict(torch.load(os.path.join(tmpdir, 'regressor.pt')))
    cfg = AttrDict(loss=dict(names=['l1', 'add_loss', 'cross_entropy'],
                             coeffs=([1., .1], [1.]), smoothl1_beta=0.2,
                             w=5.18, eps=1., alwa=_alwa()))
    lm = LossManager(build_loss(cfg), cfg.loss.coeffs, cfg.loss.alwa)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    state = create_train_state(model, opt, lm, ema_decay=0.9, device='cpu')
    aug = None
    if augment:
        aug = Pipeline([build_transform(n, kw) for n, kw in (
            ('horizontal_flip', dict(p=0.5)),
            ('random_brightness_contrast', dict(p=0.5)),
            ('normalize', dict(mean=[0.5931, 0.4690, 0.4229],
                               std=[0.2471, 0.2214, 0.2157])),
            ('to_tensor', dict(img_shape=(32, 32))))])
    step = make_train_step(model, lm, opt, augment_fn=aug, ema_decay=0.9)
    batch = np.load(os.path.join(tmpdir, 'regressor_batch.npz'))
    gen = torch.Generator().manual_seed(3)
    out = {'loss': [], 'metrics': []}
    for i in range(steps):
        imgs = _rows(batch['imgs'][i])
        kp = _rows(batch['kp'][i])
        if not augment:     # normalised, keypoints in [0, 1]
            imgs, kp = (imgs - 127.5) / 64.0, kp / imgs.shape[1]
        imgs, kp = torch.from_numpy(imgs), torch.from_numpy(kp)
        cats = torch.from_numpy(_rows(batch['cats'][i])).long()
        state, m = step(state, imgs, kp, cats, gen)
        out['metrics'].append(m.numpy().copy())
        if i == 0:
            out['params_1'] = _named(model.named_parameters())
    out['params'] = _named(model.named_parameters())
    out['stats'] = {k: v.clone() for k, v in model.state_dict().items()
                    if 'running' in k}
    out['ema'] = {k: v.clone() for k, v in state.ema_params.items()}
    out['momentum'] = {k: opt.state[p]['momentum_buffer'].clone()
                       for k, p in model.named_parameters()}
    out['alwa'] = {k: v.clone() for k, v in vars(state.alwa).items()}
    return out


def _named(named):
    return {k: p.detach().clone() for k, p in named}


def detector(tmpdir, augment=True, steps=DET_STEPS):
    """Steps of the plain-head SSD at 64² with loss balancing; with
    ``augment`` the detector's device augmentations before each step."""
    from tpudet3d_torch.data.det_transforms import DetectorAugmentations
    from tpudet3d_torch.detect import SSDDetector
    from tpudet3d_torch.detect.train import (create_detector_state,
                                             make_detector_train_step)
    model = SSDDetector(num_classes=9, width_mult=0.5)
    model.load_state_dict(torch.load(os.path.join(tmpdir, 'detector.pt')))
    state = create_detector_state(model, lr=LR, momentum=0.9, wd=0.0,
                                  device='cpu')
    step = make_detector_train_step(state.model, state.optimizer,
                                    use_balance=True, input_size=DET_SIZE)
    aug = DetectorAugmentations(flip_p=0.5, rot_p=0.5) if augment else None
    batch = np.load(os.path.join(tmpdir, 'detector_batch.npz'))
    gen = torch.Generator().manual_seed(4)
    out = {'metrics': []}
    for i in range(steps):
        imgs, boxes, labels, valid = (torch.from_numpy(_rows(batch[k][i]))
                                      for k in ('imgs_u8' if augment
                                                else 'imgs', 'boxes',
                                                'labels', 'valid'))
        if aug is not None:
            imgs, boxes = aug(imgs, boxes, gen)
        state, m = step(state, imgs, boxes, labels.long(), valid)
        out['metrics'].append(m.numpy().copy())
        if i == 0:
            out['params_1'] = _named(state.model.named_parameters())
    out['params'] = _named(state.model.named_parameters())
    out['stats'] = {k: v.clone() for k, v in state.model.state_dict().items()
                    if 'running' in k}
    return out


def sync_bn(tmpdir):
    """Training batch norm of a [B,C,H,W] and a [B,C] input: the outputs,
    the gradients of ``sum(y·w)``, the running statistics."""
    from torch import nn

    from tpudet3d_torch.models.layers import batch_norm
    data = np.load(os.path.join(tmpdir, 'bn.npz'))
    out = {}
    for name in ('x4', 'x2'):
        x = torch.from_numpy(_rows(data[name])).requires_grad_(True)
        w = torch.from_numpy(_rows(data['w' + name[1]]))
        bn = nn.BatchNorm2d(x.shape[1]) if x.dim() == 4 else \
            nn.BatchNorm1d(x.shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(data['gamma'][:x.shape[1]]))
            bn.bias.copy_(torch.from_numpy(data['beta'][:x.shape[1]]))
            bn.running_mean.copy_(torch.from_numpy(
                data['beta'][:x.shape[1]]))
        y = batch_norm(x, bn, train=True)
        (y * w).sum().backward()
        out[name] = dict(y=y.detach(), dx=x.grad, dgamma=bn.weight.grad,
                         dbeta=bn.bias.grad, mean=bn.running_mean.clone(),
                         var=bn.running_var.clone())
    return out


def evaluator(tmpdir):
    """``Evaluator.val`` over two batches of this process's rows (the
    second padded), and ``DetectorEvaluator.results`` over given
    detections of 12 images."""
    from tpudet3d_torch.detect import DetectorEvaluator
    from tpudet3d_torch.eval.evaluator import Evaluator
    from tpudet3d_torch.models import MobileNetV3
    from tpudet3d_torch.models.wrapper import MultiHeadRegressor
    from tpudet3d_torch.train import make_eval_step
    data = np.load(os.path.join(tmpdir, 'eval.npz'))
    model = MultiHeadRegressor(MobileNetV3(cfgs=SMALL_CFGS, mode='large'))
    model.load_state_dict(torch.load(os.path.join(tmpdir, 'regressor.pt')))
    state = SimpleNamespace(model=model, ema_params=None)
    batches = []
    for i in range(data['imgs'].shape[0]):
        true_n = int(data['true_n'][i])
        rows = np.arange(data['imgs'].shape[1])
        mine = rows[sharding.local_batch_slice(len(rows))]
        real = int(np.sum(mine < true_n))
        order = np.concatenate([mine[mine < true_n], mine[mine >= true_n]])
        batches.append(tuple(data[k][i][order] for k in ('imgs', 'kp', 'cats'))
                       + (real,))
    ev = Evaluator(eval_step=make_eval_step(model), state_fn=lambda: state,
                   val_loader=batches, test_loader=None, test_transform=None,
                   put_fn=lambda *a: tuple(torch.from_numpy(np.asarray(x))
                                           for x in a))
    out = {'val': np.asarray(ev.val(compute_iou=True))}
    # the images as the loader deals them: the stream's rows rank::world,
    # in batches of 2
    det = DetectorEvaluator(None)
    stream = {k: data[k].reshape(-1, *data[k].shape[2:])
              for k in ('dets', 'gt_boxes', 'gt_labels', 'gt_valid')}
    mine = {k: v[sharding.local_batch_slice(len(v))]
            for k, v in stream.items()}
    for i in range(0, len(mine['dets']), 2):
        det.add_batch(None, *(mine[k][i:i + 2] for k in
                              ('gt_boxes', 'gt_labels', 'gt_valid')),
                      dets=torch.from_numpy(mine['dets'][i:i + 2]))
    res = det.results()
    out['map'] = np.asarray([res[c] for c in range(9)] + [res['mAP']])
    return out


def regressor_plain(tmpdir):
    """One step without dropout or augmentations, the images normalised
    as the JAX comparison feeds them."""
    return regressor(tmpdir, dropout_rate=0.0, augment=False, steps=1)


def detector_plain(tmpdir):
    return detector(tmpdir, augment=False, steps=1)


TASKS = {'regressor': regressor, 'regressor_plain': regressor_plain,
         'detector': detector, 'detector_plain': detector_plain,
         'sync_bn': sync_bn, 'evaluator': evaluator}


def run(dev, world, rank, tmpdir, tasks):
    """The work of one process of a ``world``-process gloo group on the
    CPU (``sharding.group_main`` joins the group): each task of
    ``tasks`` in turn."""
    torch.set_num_threads(1)
    assert sharding.world() == world and sharding.rank() == rank
    return {t: TASKS[t](tmpdir) for t in tasks}
