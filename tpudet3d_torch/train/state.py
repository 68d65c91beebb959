"""Train state (counterpart of ``tpudet3d/train/state.py``).

The model holds the parameters and the batch norm statistics, the
optimizer its moments; beside them the state carries the ALWA state, the
step as a 0-d device tensor and, with ``ema_decay > 0``, an exponential
moving average of the parameters (not of the batch statistics), which
starts as a copy of the initial parameters.  The train step updates the
state in place and returns it.
"""

import dataclasses
from typing import Any, Optional

import torch

from ..core.device import resolve_device
from ..losses import LossManager, build_loss
from ..losses.manager import AlwaState
from ..models import build_model
from .optim import build_optimizer

__all__ = ['TrainState', 'create_train_state', 'param_count', 'eval_params']


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    alwa: AlwaState
    step: torch.Tensor
    # name → tensor, the parameters' average; None when ema_decay is 0
    ema_params: Optional[dict] = None
    loss_manager: Any = None
    ema_decay: float = 0.0


def create_train_state(cfg_or_model, optimizer=None, loss_manager=None,
                       ema_decay=None, device=None, generator=None):
    """A train state on ``device`` (the card unless ``'cpu'``).

    Given a config, builds the model (``models.build_model``, seeded by
    ``generator``, a CPU generator; default seed 0), its optimizer
    (``cfg.optim``), the loss manager (``cfg.loss``) and reads
    ``cfg.optim.ema_decay``.  Given a model, takes ``optimizer`` and
    ``loss_manager`` as they are (``ema_decay`` defaults to 0) and moves
    the model to ``device`` in place, so an optimizer built over its
    parameters before keeps them."""
    device = resolve_device(device)
    if isinstance(cfg_or_model, torch.nn.Module):
        model = cfg_or_model.to(device)
        if optimizer is None or loss_manager is None:
            raise ValueError('a model needs its optimizer and loss manager')
    else:
        cfg = cfg_or_model
        model = build_model(cfg, generator=generator).to(device)
        if optimizer is None:
            optimizer = build_optimizer(cfg, model.parameters())
        if loss_manager is None:
            loss_manager = LossManager(build_loss(cfg), cfg.loss.coeffs,
                                       cfg.loss.alwa)
        if ema_decay is None:
            ema_decay = float(cfg.optim.get('ema_decay', 0.0) or 0.0)
    ema_decay = float(ema_decay or 0.0)
    ema = None
    if ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer,
                      alwa=loss_manager.init_state(device),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      ema_params=ema, loss_manager=loss_manager,
                      ema_decay=ema_decay)


def param_count(model):
    return sum(p.numel() for p in model.parameters())


def eval_params(state):
    """The weights to evaluate or serve, name → tensor: the EMA when the
    state keeps one, otherwise the parameters."""
    if state.ema_params is not None:
        return state.ema_params
    return {k: p.detach() for k, p in state.model.named_parameters()}
