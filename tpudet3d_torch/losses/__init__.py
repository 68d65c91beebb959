from .builder import AVAILABLE_LOSS, build_loss
from .manager import AlwaState, LossManager
from .regression import (LOSS_REGISTRY, add_loss, compute_diag,
                         cross_entropy_loss, diag_loss, l1_loss, mse_loss,
                         smooth_l1_loss, wing_loss)

__all__ = ['l1_loss', 'smooth_l1_loss', 'mse_loss', 'add_loss', 'diag_loss',
           'wing_loss', 'cross_entropy_loss', 'compute_diag', 'LOSS_REGISTRY',
           'LossManager', 'AlwaState', 'build_loss', 'AVAILABLE_LOSS']
