"""The epoch loop (counterpart of ``tpudet3d/train/trainer.py``).

The loop body enqueues a step (the device augmentations fused in) and
then reads the previous step's ``[loss, ADD, SADD, acc]``: each step's
metrics are copied to pinned memory behind an event, and the host waits
on that event one step later, while the card runs the next step.
"""

import datetime
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import AverageMeter
from ..utils.checkpoint import save_snap
from .optim import current_learning_rate, set_learning_rate

__all__ = ['Trainer', 'LateReader']


class LateReader:
    """Small device tensors to the host one step late: ``push`` starts a
    non-blocking copy into one of two pinned buffers and records an event;
    ``read`` waits on that event alone.  On the CPU it reads at once."""

    def __init__(self):
        self.bufs, self.events, self.n = None, None, 0

    def push(self, t):
        if t.device.type != 'cuda':
            return t.detach().clone()
        if self.bufs is None or self.bufs[0].shape != t.shape:
            self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
        k = self.n % 2
        self.n += 1
        self.bufs[k].copy_(t, non_blocking=True)
        self.events[k].record()
        return k

    def read(self, handle):
        if isinstance(handle, torch.Tensor):
            return handle.numpy()
        self.events[handle].synchronize()
        return self.bufs[handle].numpy().copy()


@dataclass
class Trainer:
    train_step: Callable   # (state, imgs, kps, cats, generator) -> (state, metrics)
    state: Any
    train_loader: Any
    lr_schedule: Optional[Callable]   # epoch -> lr
    writer: Any
    max_epoch: int
    log_path: str
    put_fn: Callable                  # host batch -> device tensors
    generator: torch.Generator        # on the card: augmentations, dropout
    save_chkpt: bool = True
    debug: bool = False
    debug_steps: int = 30
    save_freq: int = 10
    print_freq: int = 10
    train_step_counter: int = 0

    def train(self, epoch, is_last_epoch):
        """Train one epoch; returns the state (updated in place)."""
        losses, add_m, sadd_m, acc_m, batch_time = (
            AverageMeter(), AverageMeter(), AverageMeter(), AverageMeter(),
            AverageMeter())
        if self.lr_schedule is not None:
            set_learning_rate(self.state.optimizer, self.lr_schedule(epoch))
        lr = current_learning_rate(self.state.optimizer)

        num_iters = len(self.train_loader)
        start = time.time()
        late = LateReader()
        pending = None  # (handle, batch size, step) — read one step late

        def drain(pending_item):
            handle, bs, step_idx = pending_item
            m = late.read(handle)
            if not np.all(np.isfinite(m)):
                raise FloatingPointError(
                    f'non-finite training metrics at step {step_idx}: '
                    f'loss={m[0]} ADD={m[1]} SADD={m[2]} acc={m[3]} '
                    f'(lr={lr}) — checkpoint at {self.log_path} can be '
                    f'resumed with a lower lr')
            losses.update(float(m[0]), bs)
            add_m.update(float(m[1]), bs)
            sadd_m.update(float(m[2]), bs)
            acc_m.update(float(m[3]), bs)
            if self.writer is not None:
                self.writer.add_scalar('Train/loss', float(m[0]),
                                       global_step=step_idx)
                self.writer.add_scalar('Train/ADD', add_m.avg,
                                       global_step=step_idx)
                self.writer.add_scalar('Train/SADD', sadd_m.avg,
                                       global_step=step_idx)
                self.writer.add_scalar('Train/ACC', acc_m.avg,
                                       global_step=step_idx)

        for it, (imgs, kps, cats, _true_n) in enumerate(self.train_loader):
            self.state, metrics = self.train_step(
                self.state, *self.put_fn(imgs, kps, cats), self.generator)
            handle = late.push(metrics)
            if pending is not None:
                drain(pending)       # the previous step's metrics
            pending = (handle, imgs.shape[0], self.train_step_counter)
            self.train_step_counter += 1

            batch_time.update(time.time() - start)
            nb_this = num_iters - (it + 1)
            nb_future = (self.max_epoch - (epoch + 1)) * num_iters
            eta = str(datetime.timedelta(
                seconds=int(batch_time.avg * (nb_this + nb_future))))
            if it % self.print_freq == 0 or it == num_iters - 1:
                print(f'epoch: [{epoch}/{self.max_epoch}][{it}/{num_iters}]\t'
                      f'time {batch_time.val:.3f} ({batch_time.avg:.3f})\t'
                      f'eta {eta}\t'
                      f'cls acc {acc_m.val:.3f} ({acc_m.avg:.3f})\t'
                      f'ADD {add_m.val:.4f} ({add_m.avg:.4f})\t'
                      f'SADD {sadd_m.val:.4f} ({sadd_m.avg:.4f})\t'
                      f'loss {losses.avg:.5f}\t'
                      f'lr {lr:.6f}', flush=True)
            start = time.time()
            if self.debug and it == self.debug_steps:
                break

        if pending is not None:
            drain(pending)
        if self.save_chkpt and (epoch % self.save_freq == 0 or is_last_epoch) \
                and not self.debug:
            save_snap(self.state, epoch, self.log_path)
        return self.state
