"""Seeded random weights with calibrated batch-norm statistics, made on
the card by the benchmark and handed to both the port and the reference.

Every leaf is drawn by its kind, in a few large calls of a
``torch.Generator`` on the card: conv kernels N(0, √(2/fan_in)), dense
kernels and the heads' ``[9, C, 18]`` kernel N(0, 1/√fan_in), biases and
the shifts of batch, layer and group norms N(0, 0.1), their scales
U(0.5, 1.5); a model with a ``leaf_std(name, p)`` (a regressor whose
backbone file defines one) gives the std of its own leaves, such as a
position-bias table, where it returns one.  Then every
batch norm's running mean and variance are set to the statistics of its
input over a calibration batch, in one float32 training-mode forward of
the reference, the variance plus 1: with drawn statistics alone the random
networks run away (the scores saturate, the keypoints' pre-activations
reach thousands), and with a smaller floor the channels of little spread
amplify bf16's rounding far beyond a trained network's.
"""

import torch
from torch import nn

VAR_FLOOR = 1.0
NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)


def _normal_std(name, p):
    if name.endswith('head_kernel'):
        return 1.0 / p.shape[1] ** 0.5
    if p.dim() == 4:
        return (2.0 / p[0].numel()) ** 0.5
    if p.dim() == 2:
        return 1.0 / p.shape[1] ** 0.5
    return 0.1                       # biases, batch-norm shifts


@torch.no_grad()
def draw(model, seed, device):
    """Fill ``model``'s parameters (on ``device``) from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    norms = [m for m in model.modules() if isinstance(m, NORMS)]
    scales = {id(m.weight) for m in norms if m.weight is not None}
    shifts = {id(m.bias) for m in norms if m.bias is not None}
    custom = getattr(model, 'leaf_std', None)
    named = list(model.named_parameters())
    normal = [(n, p) for n, p in named if id(p) not in scales]
    uniform = [p for _, p in named if id(p) in scales]
    z = torch.randn(sum(p.numel() for _, p in normal), generator=gen,
                    device=device)
    u = torch.rand(sum(p.numel() for p in uniform), generator=gen,
                   device=device)
    i = 0
    for name, p in normal:
        std = None if custom is None else custom(name, p)
        if std is None:
            std = 0.1 if id(p) in shifts else _normal_std(name, p)
        p.copy_(z[i:i + p.numel()].view_as(p) * std)
        i += p.numel()
    i = 0
    for p in uniform:
        p.copy_(0.5 + u[i:i + p.numel()].view_as(p))
        i += p.numel()


@torch.no_grad()
def calibrate(model, *args, **kwargs):
    """Running statistics of every batch norm of the reference ``model`` ←
    its input's over the calibration batch ``args`` (one training-mode
    forward, each layer normalised by its own), the variance plus
    :data:`VAR_FLOOR`."""
    bns = [m for m in model.modules()
           if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d))]
    for bn in bns:
        bn.momentum = 1.0
    try:
        model(*args, train=True, **kwargs)
    finally:
        for bn in bns:
            bn.momentum = 0.1
    for bn in bns:
        bn.running_var.add_(VAR_FLOOR)
        bn.num_batches_tracked.zero_()


def make(model, seed, device, *calib_args, **calib_kwargs):
    """Draw, calibrate and return ``model``'s ``state_dict`` (on
    ``device``)."""
    model.to(device)
    draw(model, seed, device)
    calibrate(model, *calib_args, **calib_kwargs)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
