"""Optimizers and per-epoch learning-rate schedules (counterpart of
``tpudet3d/train/optim.py``).

``build_optimizer`` returns a ``torch.optim.Optimizer`` whose step is the
JAX package's optax update at float32 tolerance, the quirk that
``'adam'`` builds AdamW included:

* ``adam``: ``torch.optim.AdamW`` is ``optax.adamw`` (eps 1e-8 outside the
  square root, decoupled decay on the old parameter);
* ``sgd``: ``add_decayed_weights`` then ``optax.sgd`` with momentum and
  nesterov is ``torch.optim.SGD(weight_decay=wd)``;
* ``adadelta``: ``add_decayed_weights`` then ``optax.adadelta`` is
  ``torch.optim.Adadelta(weight_decay=wd)`` (eps 1e-6);
* ``rmsprop``: ``optax.rmsprop`` divides by ``sqrt(nu + eps)`` where torch
  divides by ``sqrt(nu) + eps``, so it is :class:`RMSpropInSqrt`.

optax moves the moments of every leaf on every step, zero gradients
included, where torch skips a parameter whose ``.grad`` is None: the train
step gives every parameter a gradient (``zero_grad(set_to_none=False)``).

``build_scheduler`` returns ``lr(epoch)`` (a copy: the JAX module imports
optax); the trainer writes it into the param groups at each epoch
boundary with :func:`set_learning_rate`.
"""

import math

import torch

AVAILABLE_OPTIMS = ['sgd', 'rmsprop', 'adam', 'adadelta']
AVAILABLE_SCHEDS = ['cosine', 'exp', 'stepLR', 'multistepLR']

__all__ = ['build_optimizer', 'build_scheduler', 'set_learning_rate',
           'current_learning_rate', 'RMSpropInSqrt', 'AVAILABLE_OPTIMS',
           'AVAILABLE_SCHEDS']


class RMSpropInSqrt(torch.optim.Optimizer):
    """``add_decayed_weights(wd)`` then ``optax.rmsprop(lr, decay=alpha)``:
    ``g += wd·p``, ``nu = (1 - alpha)·g² + alpha·nu`` (from 0),
    ``p -= lr·g / sqrt(nu + eps)``."""

    def __init__(self, params, lr, alpha=0.9, eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha, wd = group['alpha'], group['weight_decay']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g.add(p, alpha=wd)
                state = self.state[p]
                if not state:
                    state['nu'] = torch.zeros_like(p)
                nu = state['nu']
                nu.mul_(alpha).addcmul_(g, g, value=1.0 - alpha)
                p.addcmul_(g, torch.rsqrt(nu + group['eps']),
                           value=-group['lr'])
        return loss


def build_optimizer(cfg, params):
    """``params``: the model's parameters (or param groups)."""
    name = cfg.optim.name
    if name not in AVAILABLE_OPTIMS:
        raise ValueError(f'unknown optimizer {name}')
    lr = float(cfg.optim.lr)
    wd = float(cfg.optim.wd or 0.0)
    if name == 'adam':        # AdamW, like the reference
        return torch.optim.AdamW(
            params, lr=lr, betas=(float(cfg.optim.betas[0]),
                                  float(cfg.optim.betas[1])),
            eps=1e-8, weight_decay=wd)
    if name == 'sgd':
        momentum = float(cfg.optim.momentum or 0.0)
        # optax's nesterov with no momentum is plain SGD; torch refuses it
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               nesterov=bool(cfg.optim.nesterov)
                               and momentum > 0, weight_decay=wd)
    if name == 'rmsprop':
        return RMSpropInSqrt(params, lr=lr, alpha=float(cfg.optim.alpha),
                             weight_decay=wd)
    return torch.optim.Adadelta(params, lr=lr, rho=float(cfg.optim.rho),
                                eps=1e-6, weight_decay=wd)


def build_scheduler(cfg):
    """epoch -> learning-rate function (reference scheduler semantics)."""
    name = cfg.scheduler.name
    if not name:
        return None
    if name not in AVAILABLE_SCHEDS:
        raise ValueError(f'unknown scheduler {name}')
    lr0 = float(cfg.optim.lr)
    if name == 'cosine':
        t_max = int(cfg.data.max_epochs)
        eta_min = 5e-6

        def lr_fn(epoch):
            return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2
    elif name == 'exp':
        gamma = float(cfg.scheduler.exp_gamma)

        def lr_fn(epoch):
            return lr0 * gamma ** epoch
    elif name == 'stepLR':
        step = int(cfg.scheduler.steps[0])
        gamma = float(cfg.scheduler.gamma)

        def lr_fn(epoch):
            return lr0 * gamma ** (epoch // step)
    else:  # multistepLR
        milestones = [int(s) for s in cfg.scheduler.steps]
        gamma = float(cfg.scheduler.gamma)

        def lr_fn(epoch):
            return lr0 * gamma ** sum(epoch >= m for m in milestones)
    return lr_fn


def set_learning_rate(optimizer, lr):
    """Write ``lr`` into every param group (host side, once an epoch)."""
    for group in optimizer.param_groups:
        group['lr'] = float(lr)
    return optimizer


def current_learning_rate(optimizer):
    return float(optimizer.param_groups[0]['lr'])
