"""Loss factory (counterpart of ``tpudet3d/losses/builder.py``)."""

from functools import partial

from .regression import (add_loss, cross_entropy_loss, diag_loss, l1_loss,
                         mse_loss, smooth_l1_loss, wing_loss)

AVAILABLE_LOSS = ['smoothl1', 'l1', 'cross_entropy', 'diag_loss', 'mse',
                  'add_loss', 'wing']

__all__ = ['build_loss', 'AVAILABLE_LOSS']


def build_loss(cfg):
    """``(regression criterions, classification criterions)`` in the order
    of ``cfg.loss.names``."""
    regress_criterions = []
    class_criterions = []
    for loss_name in cfg.loss.names:
        if loss_name not in AVAILABLE_LOSS:
            raise ValueError(f'unknown loss {loss_name}')
        if loss_name == 'cross_entropy':
            class_criterions.append(cross_entropy_loss)
        elif loss_name == 'smoothl1':
            regress_criterions.append(
                partial(smooth_l1_loss, beta=float(cfg.loss.smoothl1_beta)))
        elif loss_name == 'l1':
            regress_criterions.append(l1_loss)
        elif loss_name == 'mse':
            regress_criterions.append(mse_loss)
        elif loss_name == 'wing':
            regress_criterions.append(
                partial(wing_loss, w=float(cfg.loss.w), eps=float(cfg.loss.eps)))
        elif loss_name == 'add_loss':
            regress_criterions.append(add_loss)
        elif loss_name == 'diag_loss':
            regress_criterions.append(diag_loss)
    return regress_criterions, class_criterions
