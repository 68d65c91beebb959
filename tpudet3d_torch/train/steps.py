"""Train and eval steps (counterpart of ``tpudet3d/train/steps.py``).

Eager PyTorch with no host read inside a step: the forward in training
mode (the ground-truth class's head, training batch norm, the classifier's
dropout), the loss with the ALWA transition, backward, the optimizer, the
EMA and ``step += 1``; the step's metrics come back as one small device
tensor.  The eval step gives the per-class sums of ADD, SADD, 3D IoU
(the batched EPnP lift and kernel K5 on the card) and accuracy.
"""

import torch

from ..parallel import sharding
from ..eval.metrics import NUM_KEYPOINTS, _metrics_segments, add_sadd_per_sample

__all__ = ['make_train_step', 'make_eval_step']


def make_train_step(model, loss_manager, optimizer, augment_fn=None,
                    ema_decay=0.0):
    """``train_step(state, imgs, gt_kp, gt_cats, generator) -> (state,
    metrics)``: ``imgs`` normalised NHWC ``[B,h,w,3]`` (float32 or the
    model's dtype), ``gt_kp [B,9,2]`` in [0, 1], ``gt_cats [B]``;
    ``generator`` (on the batch's device) draws the dropout mask and is
    handed to ``augment_fn(imgs, kp, generator) -> (imgs, kp)`` first.
    ``metrics`` is ``[loss, ADD, SADD, accuracy]``, float32 on the device.
    The state is updated in place."""
    params = list(model.parameters())
    if ema_decay > 0:
        # the JAX package's float32 decay and its float32 complement
        d = torch.tensor(ema_decay, dtype=torch.float32)
        decay, rest = float(d), float(1.0 - d)

    def train_step(state, imgs, gt_kp, gt_cats, generator):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError('the state holds another model or optimizer')
        if augment_fn is not None:
            imgs, gt_kp = augment_fn(imgs, gt_kp, generator)
        kp, logits = model(imgs, cats=gt_cats, train=True,
                           generator=generator)
        loss, state.alwa = loss_manager.parse_losses(
            kp, gt_kp, logits, gt_cats, state.step, state.alwa)
        # every parameter gets a gradient, zeros where the loss does not
        # reach it, as optax sees every leaf
        optimizer.zero_grad(set_to_none=False)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss.backward()
        sharding.all_reduce_mean([p.grad for p in params])
        optimizer.step()
        if ema_decay > 0:
            ema = list(state.ema_params.values())
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, [p.detach() for p in params],
                                alpha=rest)
        with torch.no_grad():
            add_sum, sadd_sum = add_sadd_per_sample(kp, gt_kp)
            acc = (logits.argmax(1) == gt_cats).float().mean()
            metrics = torch.stack([loss.detach().float(),
                                   add_sum.mean() / NUM_KEYPOINTS,
                                   sadd_sum.mean() / NUM_KEYPOINTS, acc])
            sharding.all_reduce_mean([metrics])
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model, num_classes=9):
    """``eval_step(params, imgs, gt_kp, gt_cats, weights=None,
    compute_iou=True) -> ((add, sadd, iou, acc, counts), (kp, logits))``:
    the per-class sums ``[num_classes]`` each, over the samples that
    ``weights [B]`` keeps.  ``params`` (name → tensor, e.g.
    ``train.eval_params(state)``) stand in for the model's parameters for
    this call; None uses the model's own.  Runs in eval mode (running
    statistics, no dropout) without autograd."""

    @torch.no_grad()
    def eval_step(params, imgs, gt_kp, gt_cats, weights=None,
                  compute_iou=True):
        if params is None:
            kp, logits = model(imgs, cats=gt_cats)
        else:
            kp, logits = torch.func.functional_call(
                model, params, (imgs,), {'cats': gt_cats})
        sums = _metrics_segments(kp, gt_kp, logits, gt_cats, num_classes,
                                 compute_iou, weights)
        return sums, (kp, logits)

    return eval_step
