"""EfficientNet-lite backbones 0/1/2 (counterpart of
``tpudet3d/models/efficientnet_lite.py``).

EfficientNet without squeeze-excite, ReLU6 everywhere; the stem (32) and
head (1280) channels and the depth of the first and last stages are exempt
from compound scaling, so ``feature_dim`` is 1280 for every variant.  The
conv head runs before the pool, so ``head`` is the identity.

Submodules are named like the Flax tree: ``blocks_0`` is the stem,
``blocks_i.ConvBN_j`` the MBConv blocks (no expand conv when the expansion
is 1), the last ``blocks_i`` the head conv.
"""

import math

import torch.nn.functional as F
from torch import nn

from .layers import ConvBN, global_pool
from .mobilenetv2 import _MBConv

__all__ = ['EfficientNetLite', 'EFFNET_LITE_PARAMS']

# (width_mult, depth_mult, resolution, dropout)
EFFNET_LITE_PARAMS = {
    'efficientnet-lite0': (1.0, 1.0, 224, 0.2),
    'efficientnet-lite1': (1.0, 1.1, 240, 0.2),
    'efficientnet-lite2': (1.1, 1.2, 260, 0.3),
}

# base (B0) stages: (expand, channels, repeats, stride, kernel)
_B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _round_filters(filters, width_mult, divisor=8):
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def _round_repeats(repeats, depth_mult):
    return int(math.ceil(depth_mult * repeats))


class EfficientNetLite(nn.Module):

    feature_dim = 1280

    def __init__(self, width_mult=1.0, depth_mult=1.0):
        super().__init__()
        blocks = [ConvBN(3, 32, 3, 2, act=F.relu6)]          # fixed stem
        in_ch = 32
        last = len(_B0_STAGES) - 1
        for i, (expand, channels, repeats, stride, kernel) in enumerate(
                _B0_STAGES):
            out_ch = _round_filters(channels, width_mult)
            reps = (repeats if i in (0, last)
                    else _round_repeats(repeats, depth_mult))
            for r in range(reps):
                blocks.append(_MBConv(in_ch, out_ch, expand,
                                      stride if r == 0 else 1, kernel))
                in_ch = out_ch
        blocks.append(ConvBN(in_ch, self.feature_dim, 1, 1,
                             act=F.relu6))                   # fixed head
        self.n_blocks = len(blocks)
        for i, b in enumerate(blocks):
            self.add_module(f'blocks_{i}', b)

    def features(self, x, train=False):
        for i in range(self.n_blocks):
            x = getattr(self, f'blocks_{i}')(x, train)
        return x

    def head(self, pooled, train=False):
        return pooled        # the conv head already ran before the pool

    def forward(self, x, pooling_mode='avg', train=False):
        return global_pool(self.features(x, train), pooling_mode)
