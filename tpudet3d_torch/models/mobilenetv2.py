"""MobileNetV2 trunk of the SSD detector (counterpart of
``tpudet3d/models/mobilenetv2.py``).

Stage i is the i-th entry of ``MNV2_CFG`` (stem excluded), so
``out_stages=(4, 6)`` gives the stride-16 (96 ch) and stride-32 (320 ch)
maps.  Input and outputs are NCHW.
"""

import torch.nn.functional as F
from torch import nn

from .layers import ConvBN, make_divisible

__all__ = ['MobileNetV2', 'MNV2_CFG']

# (expand_ratio, channels, repeats, first_stride)
MNV2_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),    # stage index 4 → stride 16
    (6, 160, 3, 2),
    (6, 320, 1, 1),   # stage index 6 → stride 32
)


class _MBConv(nn.Module):
    """Inverted residual with ReLU6 and no squeeze-excite: expand 1x1
    (none when ``expand`` is 1) → depthwise kxk → project 1x1; identity
    skip at stride 1 with in == out."""

    def __init__(self, in_channels, out_channels, expand, strides,
                 kernel_size=3):
        super().__init__()
        hidden = in_channels * expand
        self.identity = strides == 1 and in_channels == out_channels
        convs = []
        if expand != 1:
            convs.append(ConvBN(in_channels, hidden, 1, 1, act=F.relu6))
        convs.append(ConvBN(hidden, hidden, kernel_size, strides,
                            groups=hidden, act=F.relu6))
        convs.append(ConvBN(hidden, out_channels, 1, 1, act=None))
        self.n_convs = len(convs)
        for i, m in enumerate(convs):
            self.add_module(f'ConvBN_{i}', m)

    def forward(self, x):
        y = x
        for i in range(self.n_convs):
            y = getattr(self, f'ConvBN_{i}')(y)
        return x + y if self.identity else y


class MobileNetV2(nn.Module):
    """Returns the feature maps at the requested stage indices."""

    def __init__(self, width_mult=1.0, out_stages=(4, 6)):
        super().__init__()
        self.out_stages = tuple(out_stages)
        cin = make_divisible(32 * width_mult, 8)
        self.ConvBN_0 = ConvBN(3, cin, 3, 2, act=F.relu6)
        self.stage_ends = []          # index of each stage's last block
        n_blocks = 0
        for t, c, n, s in MNV2_CFG:
            cout = make_divisible(c * width_mult, 8)
            for i in range(n):
                self.add_module(f'_MBConv_{n_blocks}',
                                _MBConv(cin, cout, t, s if i == 0 else 1))
                cin = cout
                n_blocks += 1
            self.stage_ends.append(n_blocks - 1)
        self.n_blocks = n_blocks
        self.out_channels = tuple(
            make_divisible(MNV2_CFG[i][1] * width_mult, 8)
            for i in self.out_stages)

    def forward(self, x):
        x = self.ConvBN_0(x)
        outs = []
        ends = {self.stage_ends[i] for i in self.out_stages}
        for b in range(self.n_blocks):
            x = getattr(self, f'_MBConv_{b}')(x)
            if b in ends:
                outs.append(x)
        return tuple(outs)
