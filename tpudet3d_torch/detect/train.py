"""Detector training (counterpart of ``tpudet3d/detect/train.py``): the
train state, the warmup-and-step learning rate, the SSD train step and the
epoch loop.

The step is eager PyTorch with no host read inside it: the forward in
training mode (batch statistics in every batch norm), the SSD loss,
backward, SGD with momentum and the weight decay added to the gradient
(``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))`` is
``torch.optim.SGD(momentum=m, weight_decay=wd)``) over the model's
parameters and the loss-balancing pair, the EMA and ``step += 1``.  The
learning rate is a host function of a host step counter, written into the
optimizer before each step.

Under a process group (``parallel/``) the step computes what one process
computes over the global batch: the SSD loss is a mean of per-image
terms, so averaging the gradient over the processes after ``backward``
gives the global batch's, with batch norm synchronised; the metrics are
the global batch's on every rank.  The loop prints and saves on rank 0.
"""

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from ..core import AverageMeter
from ..core.device import resolve_device
from ..models.layers import init_weights
from ..parallel import sharding
from ..train.optim import set_learning_rate
from ..train.trainer import LateReader
from ..utils.checkpoint import save_snap
from .anchors import generate_anchors
from .losses import ssd_loss

__all__ = ['DetTrainState', 'create_detector_state', 'make_detector_train_step',
           'warmup_step_lr', 'DetectorTrainer']


@dataclasses.dataclass
class DetTrainState:
    model: nn.Module              # parameters and batch statistics
    balance: dict                 # 's_cls', 's_reg': 0-d float32 Parameters
    optimizer: torch.optim.Optimizer
    step: torch.Tensor            # 0-d int32 on the model's device
    # name → tensor, the parameters' average; None when ema_decay is 0
    ema_params: Optional[dict] = None
    ema_decay: float = 0.0


def warmup_step_lr(base_lr=0.05, warmup_iters=1200, warmup_ratio=1.0 / 3,
                   milestones=(25, 30, 35), gamma=0.1, steps_per_epoch=100):
    """mmdet's 'step' policy with linear warmup, a function of the global
    step on the host, in the JAX package's float32 arithmetic."""
    f32 = np.float32
    milestones = tuple(int(m) * steps_per_epoch for m in milestones)

    def lr(step):
        step = f32(step)
        frac = np.minimum(step / f32(warmup_iters), f32(1.0))
        warm = f32(base_lr) * (f32(warmup_ratio)
                               + f32(1 - warmup_ratio) * frac)
        n = f32(sum(f32(step >= m) for m in milestones))
        return float(warm * f32(f32(gamma) ** n))

    return lr


def create_detector_state(model, lr=0.05, momentum=0.9, wd=0.0,
                          ema_decay=0.0, device=None, generator=None):
    """A detector train state on ``device`` (the card unless ``'cpu'``).

    ``generator`` (a CPU generator) draws the JAX package's initialisers
    into ``model`` first; without one the weights stay as they are.  The
    balance pair starts at 0, the EMA (``ema_decay > 0``) as a copy of the
    parameters, ``step`` at 0."""
    device = resolve_device(device)
    if generator is not None:
        init_weights(model, generator)
    model = model.to(device)
    balance = {k: nn.Parameter(torch.zeros((), device=device))
               for k in ('s_cls', 's_reg')}
    optimizer = torch.optim.SGD(
        list(model.parameters()) + list(balance.values()), lr=lr,
        momentum=momentum, weight_decay=wd, dampening=0, nesterov=False)
    ema_decay = float(ema_decay or 0.0)
    ema = None
    if ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return DetTrainState(model=model, balance=balance, optimizer=optimizer,
                         step=torch.zeros((), dtype=torch.int32,
                                          device=device),
                         ema_params=ema, ema_decay=ema_decay)


def make_detector_train_step(model, optimizer, use_balance=False,
                             input_size=None, ema_decay=0.0, giou_weight=0.0,
                             cascade_pos_thr=0.5):
    """``train_step(state, imgs, gt_boxes, gt_labels, gt_valid) -> (state,
    metrics)``: ``imgs`` normalised NHWC ``[B,S,S,3]``, ground truth
    padded ``[B,G,4]`` / ``[B,G]`` / ``[B,G]`` bool.  ``metrics`` is
    ``[total, cls, reg, num_pos]``, float32 on the device.  ``use_balance``
    enables the clamped learned loss weighting; ``input_size`` the anchor
    grid (default 300).  A cascade model's stage-2 term comes with it.
    The state is updated in place."""
    anchors_np = generate_anchors(input_size or 300)
    anchors = {}
    params = [p for g in optimizer.param_groups for p in g['params']]
    model_params = list(model.parameters())
    if ema_decay > 0:
        # the JAX package's float32 decay and its float32 complement
        d = torch.tensor(ema_decay, dtype=torch.float32)
        decay, rest = float(d), float(1.0 - d)

    def train_step(state, imgs, gt_boxes, gt_labels, gt_valid):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError('the state holds another model or optimizer')
        dev = imgs.device
        if dev not in anchors:
            # a pinned, non-blocking copy: a pageable one waits for the host
            host = torch.from_numpy(anchors_np)
            anchors[dev] = (host.pin_memory().to(dev, non_blocking=True)
                            if dev.type == 'cuda' else host.to(dev))
        logits, deltas = model(imgs, train=True)
        deltas2 = None
        if isinstance(deltas, tuple):
            deltas, deltas2 = deltas
        balance = ((state.balance['s_cls'], state.balance['s_reg'])
                   if use_balance else None)
        total, parts = ssd_loss(
            logits, deltas, anchors[dev], gt_boxes, gt_labels, gt_valid,
            balance_params=balance, cascade_deltas=deltas2,
            cascade_pos_thr=cascade_pos_thr, giou_weight=giou_weight)
        # every parameter gets a gradient, zeros where the loss does not
        # reach it, as optax moves every leaf
        optimizer.zero_grad(set_to_none=False)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        total.backward()
        sharding.all_reduce_mean([p.grad for p in params])
        optimizer.step()
        if ema_decay > 0:
            ema = list(state.ema_params.values())
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, [p.detach() for p in model_params],
                                alpha=rest)
        metrics = torch.stack([total.detach(), parts['cls_loss'].detach(),
                               parts['reg_loss'].detach(),
                               parts['num_pos']]).float()
        sharding.all_reduce_mean([metrics])
        state.step += 1
        return state, metrics

    return train_step


@dataclass
class DetectorTrainer:
    """The epoch loop of the SSD stage.  Before each step it writes
    ``lr_fn(step_counter)`` into the optimizer; each batch moves to the
    card through ``put_fn`` and through ``augment_fn(imgs, boxes,
    generator)`` before the step.  The metrics of every ``print_freq``-th
    step are read one step late (``LateReader``), printed as ``det epoch
    [e/E][it] loss … cls … reg … npos …`` and written as ``Det/*``
    scalars; ``save_snap`` runs every ``save_freq`` epochs and on the
    last."""
    train_step: Callable
    state: Any
    train_loader: Any
    lr_fn: Optional[Callable]
    max_epoch: int
    log_path: str
    put_fn: Callable
    generator: Optional[torch.Generator] = None
    augment_fn: Optional[Callable] = None
    writer: Any = None
    print_freq: int = 20
    save_freq: int = 5
    step_counter: int = 0           # the host's copy of state.step

    def train(self, epoch, is_last_epoch):
        meters = [AverageMeter() for _ in range(4)]
        names = ('loss', 'cls', 'reg', 'npos')
        t0 = time.time()
        late = LateReader()
        pending = None

        def report(handle, it, n, step):
            m = late.read(handle)
            for meter, v in zip(meters, m):
                meter.update(float(v), n)
            if not sharding.is_main_process():
                return
            msg = ' '.join(f'{k} {mm.val:.4f}({mm.avg:.4f})'
                           for k, mm in zip(names, meters))
            print(f'det epoch [{epoch}/{self.max_epoch}][{it}] {msg} '
                  f'({time.time() - t0:.1f}s)', flush=True)
            if self.writer is not None:
                for k, v in zip(names, m):
                    self.writer.add_scalar(f'Det/{k}', float(v), step)

        for it, batch in enumerate(self.train_loader):
            imgs, boxes, labels, valid = batch[:4]
            if self.lr_fn is not None:
                set_learning_rate(self.state.optimizer,
                                  self.lr_fn(self.step_counter))
            imgs_d, boxes_d, labels_d, valid_d = self.put_fn(
                imgs, boxes, labels, valid)
            if self.augment_fn is not None:
                imgs_d, boxes_d = self.augment_fn(imgs_d, boxes_d,
                                                  self.generator)
            self.state, metrics = self.train_step(self.state, imgs_d, boxes_d,
                                                  labels_d, valid_d)
            self.step_counter += 1
            if pending is not None:
                report(*pending)        # the previous printed step's
                pending = None
            if it % self.print_freq == 0:
                pending = (late.push(metrics), it, imgs.shape[0],
                           self.step_counter)
        if pending is not None:
            report(*pending)
        if epoch % self.save_freq == 0 or is_last_epoch:
            if sharding.is_main_process():
                save_snap(self.state, epoch, self.log_path)
            sharding.barrier()
        return self.state
