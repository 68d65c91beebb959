"""The benchmark's yardstick: the card's published peaks, the operations of
the models counted on the plain reference, and the bytes each kernel of
the serving path needs.  Nothing here reads the port, so a change to the
port cannot move what its work is measured against."""

import math

import torch

from reference.models import backbone_module, recording

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def forward_flops(model, *args, **kwargs):
    """``(total, first)``: the operations (2 a multiply-add) of the convs,
    dense layers and matmuls of one forward of the reference ``model`` on
    ``args`` (meta tensors are enough), and those of its first conv, whose
    input needs no gradient in training.  A conv's output value takes
    ``C_in / groups · kh · kw`` multiply-adds."""
    with torch.no_grad(), recording() as rec:
        model(*args, **kwargs)
    counts = []
    for kind, x, what, out in rec:
        if kind == 'conv':
            kh, kw = what.kernel_size
            n, c, h, w = out
            counts.append(2 * n * h * w * c * what.in_channels
                          // what.groups * kh * kw)
        else:
            k, m = ((what.in_features, what.out_features)
                    if kind == 'linear' else what)
            rows = math.prod(x[:-1])
            counts.append(2 * rows * k * m)
    return sum(counts), counts[0] if counts else 0


def train_flops(forward, first):
    """Forward, then the backward's two products a layer (the input's
    gradient and the weight's), less the input gradient of the first
    conv."""
    return 3 * forward - first


def k1_bytes(n, h, w, out_hw, out_itemsize):
    """K1 reads each uint8 frame byte once and writes the detector input
    once."""
    return n * h * w * 3 + n * out_hw[0] * out_hw[1] * 3 * out_itemsize


def k1_ops(n, h, w, out_hw):
    """Two operations a tap: ⌈H/h⌉+1 rows by ⌈W/w⌉+1 columns of taps per
    output value at most; counted as the filter's support."""
    ty = -(-h // out_hw[0]) * 2
    tx = -(-w // out_hw[1]) * 2
    return 2 * n * out_hw[0] * out_hw[1] * 3 * ty * tx


def touched_pixels(boxes, h, w, out_hw):
    """Distinct source pixels that bilinear crops of ``boxes [N,K,4]`` (xyxy,
    pixels, on any device) to ``out_hw`` read: the two taps of each output
    row and column, as the crop samples them."""
    total = 0
    for frame_boxes in boxes:
        mask = torch.zeros((h, w), dtype=torch.bool, device=boxes.device)
        for x0, y0, x1, y1 in frame_boxes.tolist():
            idx = []
            for lo, hi, size, size_in in ((y0, y1, out_hw[0], h),
                                          (x0, x1, out_hw[1], w)):
                side = max(hi - lo, 1.0)
                s = ((torch.arange(size, device=boxes.device) + 0.5)
                     * side / size - 0.5 + lo).clamp(0, size_in - 1)
                i0 = s.floor().long()
                idx.append(torch.cat([i0, (i0 + 1).clamp(max=size_in - 1)]))
            mask[idx[0][:, None], idx[1][None, :]] = True
        total += int(mask.sum())
    return total


def k2_bytes(boxes, h, w, out_hw, out_itemsize):
    """K2 reads the source pixels its crops touch once (3 bytes each) and
    the boxes, and writes every crop once."""
    n_out = boxes.shape[0] * boxes.shape[1] * out_hw[0] * out_hw[1]
    return (3 * touched_pixels(boxes, h, w, out_hw) + boxes.numel() * 4
            + n_out * 3 * out_itemsize)


def bound_s(n_bytes, n_ops, peak_ops=PEAK_F32_FLOPS):
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over ``peak_ops``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops)


def backbone_bounds(name, rows, crop, itemsize, train, calls):
    """``{kernel: [seconds] * calls}``: the least time of each kernel that
    backbone ``name``'s file counts (its ``bounds``), in each of ``calls``
    traced calls or steps over ``rows`` crops; ``{}`` where it counts
    none."""
    fn = getattr(backbone_module(name), 'bounds', None)
    if fn is None:
        return {}
    return {k: [v] * calls
            for k, v in fn(rows, tuple(crop), itemsize, train).items()}
