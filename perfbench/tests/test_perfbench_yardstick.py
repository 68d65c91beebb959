"""The operation and byte counts against hand counts at small shapes."""

import pytest
import torch

from harness import yardstick as y
from reference import models as m


def test_conv_and_depthwise_operations():
    with torch.device('meta'):
        dense = m.ConvBN(3, 8, 3, 1)
        depthwise = m.ConvBN(8, 8, 3, 2, groups=8)
        assert y.forward_flops(dense, torch.empty(2, 3, 4, 4)) == (
            2 * 2 * 4 * 4 * 8 * 3 * 9,) * 2
        # stride 2 on 4x4: a 2x2 output, one input channel a filter
        assert y.forward_flops(depthwise, torch.empty(2, 8, 4, 4))[0] == \
            2 * 2 * 2 * 2 * 8 * 1 * 9


def test_dense_and_head_operations():
    with torch.device('meta'):
        se = m.SqueezeExcite(32)              # 32 → 8 → 32
        assert y.forward_flops(se, torch.empty(3, 32, 5, 5))[0] == \
            2 * 3 * 32 * 8 * 2
        reg = m.MultiHeadRegressor('efficientnet-lite0')
        total, first = y.forward_flops(reg, torch.empty(1, 224, 224, 3))
    # the stem: 3x3 stride 2 to 112², 32 filters over 3 channels
    assert first == 2 * 112 * 112 * 32 * 3 * 9
    # the heads' [1280, 162] matmul and the classifier's [1280, 9]
    head = 2 * 1280 * 162 + 2 * 1280 * 9
    assert 0.76e9 < total - head < 0.78e9
    assert y.train_flops(total, first) == 3 * total - first


def test_k1_bytes():
    assert y.k1_bytes(2, 720, 1280, (300, 300), 2) == \
        2 * 720 * 1280 * 3 + 2 * 300 * 300 * 3 * 2


def test_touched_pixels_and_k2_bytes():
    # a box of the crop's own size samples each row and the next
    box = torch.tensor([[[0.0, 0.0, 4.0, 4.0]]])
    assert y.touched_pixels(box, 8, 8, (4, 4)) == 5 * 5
    # the whole 8x8 frame to 4x4: taps 2o and 2o+1 cover every pixel
    full = torch.tensor([[[0.0, 0.0, 8.0, 8.0]]])
    assert y.touched_pixels(full, 8, 8, (4, 4)) == 64
    # two boxes of one frame that overlap count their pixels once
    two = torch.tensor([[[0.0, 0.0, 8.0, 8.0], [0.0, 0.0, 4.0, 4.0]]])
    assert y.touched_pixels(two, 8, 8, (4, 4)) == 64
    assert y.k2_bytes(two, 8, 8, (4, 4), 2) == \
        3 * 64 + 2 * 4 * 4 + 2 * 4 * 4 * 3 * 2


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert y.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert y.bound_s(0, 67e12) == pytest.approx(1.0)
    assert y.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
