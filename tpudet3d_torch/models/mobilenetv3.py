"""MobileNetV3 trunks (counterpart of ``tpudet3d/models/mobilenetv3.py``).

Same (kernel, expand, channels, SE, HS, stride) schedule, hard-swish stem,
a final 1x1 expansion conv and a post-pool dense head (Dense → BatchNorm →
hard-swish).  ``mobilenetv3_large_21k`` is timm's ``mobilenetv3_large_100``
layout: SE after the post-depthwise activation and a head without BN.

``features`` and ``forward`` take NCHW; ``forward`` returns
``[B, feature_dim]``.  ``train=True`` runs every batch norm on the batch's
statistics and updates the running ones (``layers.batch_norm``).
"""

from torch import nn

from .layers import (ConvBN, InvertedResidual, batch_norm, global_pool,
                     hard_swish, linear, make_divisible)

__all__ = ['MobileNetV3', 'MNV3_LARGE_CFG', 'MNV3_SMALL_CFG', 'model_params']

# (kernel, expand_ratio, channels, use_se, use_hs, stride)
MNV3_LARGE_CFG = (
    (3, 1, 16, 0, 0, 1),
    (3, 4, 24, 0, 0, 2),
    (3, 3, 24, 0, 0, 1),
    (5, 3, 40, 1, 0, 2),
    (5, 3, 40, 1, 0, 1),
    (5, 3, 40, 1, 0, 1),
    (3, 6, 80, 0, 1, 2),
    (3, 2.5, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (5, 6, 160, 1, 1, 2),
    (5, 6, 160, 1, 1, 1),
    (5, 6, 160, 1, 1, 1),
)

MNV3_SMALL_CFG = (
    (3, 1, 16, 1, 0, 2),
    (3, 4.5, 24, 0, 0, 2),
    (3, 3.67, 24, 0, 0, 1),
    (5, 4, 40, 1, 1, 2),
    (5, 6, 40, 1, 1, 1),
    (5, 6, 40, 1, 1, 1),
    (5, 3, 48, 1, 1, 1),
    (5, 3, 48, 1, 1, 1),
    (5, 6, 96, 1, 1, 2),
    (5, 6, 96, 1, 1, 1),
    (5, 6, 96, 1, 1, 1),
)

model_params = {
    'mobilenetv3_large': dict(cfgs=MNV3_LARGE_CFG, mode='large'),
    'mobilenetv3_small': dict(cfgs=MNV3_SMALL_CFG, mode='small'),
    'mobilenetv3_large_21k': dict(cfgs=MNV3_LARGE_CFG, mode='large',
                                  timm_arch=True),
}


class MobileNetV3(nn.Module):

    def __init__(self, cfgs=MNV3_LARGE_CFG, mode='large', width_mult=1.0,
                 timm_arch=False):
        super().__init__()
        self.timm_arch = timm_arch
        base = {'large': 1280, 'small': 1024}[mode]
        self.feature_dim = (make_divisible(base * width_mult, 8)
                            if width_mult > 1.0 else base)
        input_channel = make_divisible(16 * width_mult, 8)
        blocks = [ConvBN(3, input_channel, 3, 2, act=hard_swish)]
        exp_size = input_channel
        for k, t, c, use_se, use_hs, s in cfgs:
            out_channel = make_divisible(c * width_mult, 8)
            exp_size = make_divisible(input_channel * t, 8)
            blocks.append(InvertedResidual(
                input_channel, exp_size, out_channel, int(k), int(s),
                bool(use_se), bool(use_hs), se_after_act=timm_arch))
            input_channel = out_channel
        blocks.append(ConvBN(input_channel, exp_size, 1, 1, act=hard_swish))
        self.n_blocks = len(blocks)
        for i, b in enumerate(blocks):
            self.add_module(f'blocks_{i}', b)
        self.head_dense = nn.Linear(exp_size, self.feature_dim)
        self.head_bn = (None if timm_arch else
                        nn.BatchNorm1d(self.feature_dim, eps=1e-5,
                                       momentum=0.1))

    def features(self, x, train=False):
        for i in range(self.n_blocks):
            x = getattr(self, f'blocks_{i}')(x, train)
        return x

    def head(self, pooled, train=False):
        """Post-pool trunk: Dense → BN → h-swish (timm variant: no BN)."""
        y = linear(pooled, self.head_dense)
        if self.head_bn is not None:
            y = batch_norm(y, self.head_bn, train)
        return hard_swish(y)

    def forward(self, x, pooling_mode='avg', train=False):
        return self.head(global_pool(self.features(x, train), pooling_mode),
                         train)
