"""Keypoint-regression and classification losses (counterpart of
``tpudet3d/losses/regression.py``).

Every loss is ``f(pred, target) -> 0-d tensor`` on plain tensors and
differentiates under autograd; the wing loss is branch-free
(``torch.where``), as in the JAX package.
"""

import math

import torch

__all__ = ['l1_loss', 'smooth_l1_loss', 'mse_loss', 'add_loss', 'diag_loss',
           'wing_loss', 'cross_entropy_loss', 'compute_diag',
           'LOSS_REGISTRY']


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def smooth_l1_loss(pred, target, beta=1.0):
    """Huber/SmoothL1 with torch's ``beta`` semantics."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def mse_loss(pred, target):
    d = pred - target
    return (d * d).mean()


def add_loss(pred, target):
    """Mean over the batch of each instance's summed keypoint L2
    distances."""
    return torch.linalg.norm(pred - target, dim=2).sum(1).mean()


def compute_diag(kp):
    """Diagonal of the 2D extent of a keypoint set ``[B,9,2]`` → ``[B]``."""
    lo = kp.amin(1)
    hi = kp.amax(1)
    return torch.sqrt((hi[:, 0] - lo[:, 0]) ** 2 + (hi[:, 1] - lo[:, 1]) ** 2)


def diag_loss(pred, target):
    """SmoothL1 (beta 0.4) between predicted and ground-truth box-diagonal
    lengths."""
    return smooth_l1_loss(compute_diag(pred), compute_diag(target), beta=0.4)


def wing_loss(pred, target, w=0.05, eps=2.0):
    """Wing loss (arXiv:1711.06753)."""
    wing_const = w - w * math.log(1.0 + w / eps)
    d = (pred - target).abs()
    return torch.where(d < w, w * torch.log(1.0 + d / eps),
                       d - wing_const).mean()


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy over integer labels, in the logits'
    dtype."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None].long())[:, 0]
    return (lse - picked).mean()


LOSS_REGISTRY = {
    'l1': l1_loss,
    'smoothl1': smooth_l1_loss,
    'mse': mse_loss,
    'add_loss': add_loss,
    'diag_loss': diag_loss,
    'wing': wing_loss,
    'cross_entropy': cross_entropy_loss,
}
