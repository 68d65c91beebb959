"""Shared building blocks (counterpart of ``tpudet3d/models/layers.py``).

Tensors inside the models are NCHW; the entry points hand them over as
``channels_last`` views of NHWC memory.  Parameters stay float32 and every
layer computes in the dtype of its input, so a bfloat16 input gives the
bfloat16 compute of a Flax module built with ``dtype=bf16`` (parameters are
cast at the point of use, batch norm accumulates in float32 and rounds its
output once).

Training mode is an explicit ``train`` argument, threaded from the
backbone's ``features``/``head`` down to ``batch_norm`` as Flax threads it;
the ``nn.Module.training`` flag is never read, so a module that was not
put in ``eval()`` still serves with its running statistics.

Submodules are named like the Flax tree (``ConvBN_0.Conv_0``,
``SqueezeExcite_0.Dense_1``, ``BatchNorm_0``), so ``utils/convert.py`` maps a
Flax path onto a ``state_dict`` key mechanically.
"""

import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import sharding

__all__ = ['make_divisible', 'hard_sigmoid', 'hard_swish',
           'global_pool', 'linear', 'model_input', 'uncast', 'conv',
           'batch_norm', 'layer_norm', 'drop_path', 'ConvBN',
           'SqueezeExcite', 'InvertedResidual', 'init_weights']


def make_divisible(v, divisor=8, min_value=None):
    """Round channels to a multiple of ``divisor`` (tf slim convention)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


def global_pool(x, mode='avg'):
    """[B,C,H,W] → [B,C]."""
    if mode == 'avg':
        return x.mean(dim=(2, 3))
    if mode == 'max':
        return x.amax(dim=(2, 3))
    if mode == 'avg+max':
        return x.mean(dim=(2, 3)) + x.amax(dim=(2, 3))
    raise ValueError(f'Unknown pooling mode: {mode}')


def linear(x, layer):
    """``nn.Linear`` computed in the dtype of ``x``."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


# ``conv_hook.fn(x, layer)``, installed in this thread by ``infer/quant.py``
# while it calibrates or serves int8 (Flax's interceptors are per thread
# too): the conv's output, or None to leave the call to ``conv``
conv_hook = threading.local()


def model_input(x, dtype):
    """A model's NHWC input as the NCHW ``channels_last`` view its stem
    conv computes on, cast to ``dtype``.  While a conv hook is installed
    the view before the cast is kept beside it (:func:`uncast`): Flax
    casts inside the conv, so JAX's calibration records the stem's input
    in the caller's dtype, not the model's."""
    y = x.to(dtype).permute(0, 3, 1, 2)
    if getattr(conv_hook, 'fn', None) is not None:
        conv_hook.cast = (y, x.permute(0, 3, 1, 2))
    return y


def uncast(x):
    """``x`` before :func:`model_input`'s cast when ``x`` is that cast's
    output in this thread, else ``x``."""
    cast = getattr(conv_hook, 'cast', None)
    return cast[1] if cast is not None and cast[0] is x else x


def conv(x, layer):
    """``nn.Conv2d`` computed in the dtype of ``x``, unless a conv hook
    (``infer/quant.py``) takes the call."""
    hook = getattr(conv_hook, 'fn', None)
    if hook is not None:
        out = hook(x, layer)
        if out is not None:
            return out
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding, layer.dilation, layer.groups)


def batch_norm(x, bn, train=False):
    """Batch norm with float32 statistics and the output in the dtype of
    ``x``, as Flax's ``nn.BatchNorm``.

    ``train=False`` normalises with the running statistics.  ``train=True``
    normalises with the batch's mean and biased variance over every axis
    but the channels (axis 1) and moves the running statistics towards
    them, ``ra = (1 - m)·ra + m·batch`` with ``m = bn.momentum`` (0.1, Flax's
    momentum 0.9), the variance biased there too.  ``F.batch_norm`` would
    move ``running_var`` with the unbiased variance, so the buffers are
    updated here from ``torch.var_mean``.

    Under a process group of more than one process (``parallel/``) the
    statistics are the global batch's, as JAX's over a sharded batch:
    :class:`_SyncBatchNorm`."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    if sharding.world() > 1:
        return _SyncBatchNorm.apply(x, bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, bn.eps, bn.momentum)
    out = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    with torch.no_grad():
        dims = [d for d in range(x.dim()) if d != 1]
        var, mean = torch.var_mean(x.float(), dims, unbiased=False)
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    return out


def layer_norm(x, ln):
    """``nn.LayerNorm`` over the last axis of ``x`` in the dtype of ``x``:
    the scale and shift cast to it at the point of use (the card's kernel
    takes no float32 parameters beside bfloat16 input), the statistics
    and the affine computed in float32 inside the kernel for a bfloat16
    ``x``, the output rounded once."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


def drop_path(x, rate, generator):
    """Stochastic depth (Huang et al., arXiv:1603.09382): each row of
    ``x`` (a sample's residual branch) kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, else zeroed.  As
    :func:`~tpudet3d_torch.models.wrapper.dropout`, one uniform draw a row
    of the global batch from ``generator`` on its own device, the row kept
    below ``1 - rate``; ``rate`` 0 draws nothing."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError('drop path at a rate above 0 needs a generator')
    keep = 1.0 - rate
    u = sharding.local_rows(torch.rand((x.shape[0] * sharding.world(),),
                                       generator=generator,
                                       device=generator.device))
    kept = (u.to(x.device) < keep).view(-1, *([1] * (x.dim() - 1)))
    return torch.where(kept, x / keep, 0.0)


class _SyncBatchNorm(torch.autograd.Function):
    """Training batch norm over the rows of every process.

    Forward: each process's count, mean and biased variance per channel
    (``torch.var_mean`` in float32, centred on its own rows), exchanged in
    one all-reduce (each rank's row of a ``[world, 3, C]`` buffer, zeros
    elsewhere) and combined by Chan's parallel formula, so the global
    variance is as well conditioned as one process's; the output and the
    running statistics (biased variance, as the single-process path) from
    the global mean and variance.  Backward: one all-reduce of the two
    sums the input's gradient needs, ``Σ dy`` and ``Σ dy·x̂``; the scale's
    and bias's gradients stay this process's own (the step averages every
    gradient over the processes).  ``nn.SyncBatchNorm`` refuses tensors on
    the CPU and moves ``running_var`` with the unbiased variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum):
        shape = [1, -1] + [1] * (x.dim() - 2)
        dims = [d for d in range(x.dim()) if d != 1]
        xf = x.float()
        var_r, mean_r = torch.var_mean(xf, dims, unbiased=False)
        stats = xf.new_zeros((sharding.world(), 3, x.shape[1]))
        stats[sharding.rank(), 0] = x.numel() // x.shape[1]
        stats[sharding.rank(), 1] = mean_r
        stats[sharding.rank(), 2] = var_r
        n_r, mean_r, var_r = sharding.all_reduce_sum(stats).unbind(1)
        n = n_r.sum(0)
        mean = (n_r * mean_r).sum(0) / n
        var = (n_r * (var_r + (mean_r - mean) ** 2)).sum(0) / n
        invstd = torch.rsqrt(var + eps)
        out = (xf - mean.view(shape)) * invstd.view(shape) \
            * weight.view(shape) + bias.view(shape)
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, mean, invstd, n = ctx.saved_tensors
        shape = [1, -1] + [1] * (x.dim() - 2)
        dims = [d for d in range(x.dim()) if d != 1]
        g = grad_out.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sum_g = g.sum(dims)
        sum_gx = (g * xhat).sum(dims)
        sums = sharding.all_reduce_sum(torch.stack([sum_g, sum_gx]))
        grad_x = (weight * invstd).view(shape) * (
            g - (sums[0] / n).view(shape) - xhat * (sums[1] / n).view(shape))
        return (grad_x.to(x.dtype), sum_gx, sum_g, None, None, None, None)


class ConvBN(nn.Module):
    """Conv → BatchNorm → activation, symmetric padding ``(k-1)//2``."""

    def __init__(self, in_channels, features, kernel_size=3, strides=1,
                 groups=1, act=hard_swish):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size, strides,
                                pad, groups=groups, bias=False)
        # Flax momentum 0.9 is torch momentum 0.1 (only read in training)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.act = act

    def forward(self, x, train=False):
        x = batch_norm(conv(x, self.Conv_0), self.BatchNorm_0, train)
        return x if self.act is None else self.act(x)


class SqueezeExcite(nn.Module):
    """SE block with a hard-sigmoid gate."""

    def __init__(self, channels, reduction=4):
        super().__init__()
        hidden = make_divisible(channels // reduction, 8)
        self.Dense_0 = nn.Linear(channels, hidden)
        self.Dense_1 = nn.Linear(hidden, channels)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = F.relu(linear(y, self.Dense_0))
        y = hard_sigmoid(linear(y, self.Dense_1))
        return x * y[:, :, None, None]


class InvertedResidual(nn.Module):
    """MobileNet inverted residual: expand 1x1 (skipped when exp == in) →
    depthwise kxk → optional SE → project 1x1; identity skip when stride 1
    and in == out.  ``se_after_act`` applies SE after the post-depthwise
    activation (the timm ordering of the 21k variant)."""

    def __init__(self, in_channels, hidden_dim, out_channels, kernel_size,
                 strides, use_se, use_hs, se_after_act=False):
        super().__init__()
        self.act = hard_swish if use_hs else F.relu
        self.identity = strides == 1 and in_channels == out_channels
        self.act_first = in_channels == hidden_dim or se_after_act
        convs = []
        if in_channels != hidden_dim:
            convs.append(ConvBN(in_channels, hidden_dim, 1, 1, act=self.act))
        convs.append(ConvBN(hidden_dim, hidden_dim, kernel_size, strides,
                            groups=hidden_dim, act=None))
        convs.append(ConvBN(hidden_dim, out_channels, 1, 1, act=None))
        for i, m in enumerate(convs):
            self.add_module(f'ConvBN_{i}', m)
        self.n_convs = len(convs)
        self.SqueezeExcite_0 = SqueezeExcite(hidden_dim) if use_se else None

    def forward(self, x, train=False):
        convs = [getattr(self, f'ConvBN_{i}') for i in range(self.n_convs)]
        y = x
        for m in convs[:-2]:
            y = m(y, train)
        y = convs[-2](y, train)
        se = self.SqueezeExcite_0
        if self.act_first:
            y = self.act(y)
            if se is not None:
                y = se(y)
        else:
            if se is not None:
                y = se(y)
            y = self.act(y)
        y = convs[-1](y, train)
        return x + y if self.identity else y


def _lecun_normal_(tensor, fan_in, generator):
    # Flax's default kernel init: truncated normal at ±2 std, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(module, generator):
    """Seeded random init with the JAX package's initialisers: lecun-normal
    kernels, zero biases, identity batch and layer norms; a module with an
    ``init_own(generator)`` (the Swin attention's relative-position table)
    draws its own leaves there, in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif hasattr(m, 'init_own'):
            m.init_own(generator)
    return module
