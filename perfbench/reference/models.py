"""The plain float32 reference of both served models and of the regressor's
training forward: MobileNetV2-SSD-300 (plain or cascade heads),
MobileNetV3-large (the timm 21k layout) and EfficientNet-lite0 under the
9-head keypoint regressor.  Any other regressor backbone is found by name
in a file of its own beside this one (:func:`backbone_module`).

A frozen copy of the arithmetic of the port's ``models/`` and
``detect/ssd.py`` as they stood when the benchmark was written, with the
submodules named as there, so one ``state_dict`` loads into both.  Plain
``torch`` in float32: no kernel, no process group, no int8 hook.  Two
additions: :func:`lowered`, which rounds every conv's and dense layer's
input and weight to float8 (e4m3, one scale a tensor) for the benchmark's
control of a precision below the configuration's bfloat16, and
:func:`recording`, which lists their shapes for the operation counts.
:func:`matmul` is the product of two activations (attention's QKᵀ and
AV) for a backbone file: rounded and recorded as ``conv`` and ``linear``
are.
"""

import importlib
import importlib.util
import math
import threading
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LOWER = threading.local()

FP8_MAX = 448.0     # the largest finite float8_e4m3fn


@contextmanager
def lowered(kind):
    """Inside, conv and dense inputs and weights and both operands of
    :func:`matmul` are rounded to ``kind`` (``'fp8'``), the gradient
    passing straight through the rounding."""
    if kind not in ('fp8',):
        raise ValueError(f'unknown lower precision {kind!r}')
    _LOWER.kind = kind
    try:
        yield
    finally:
        _LOWER.kind = None


def _round(x):
    if getattr(_LOWER, 'kind', None) is None:
        return x
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def make_divisible(v, divisor=8, min_value=None):
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


@contextmanager
def recording():
    """Inside, every conv, dense layer and matmul of the models appends
    ``(kind, x_shape, layer or weight shape, out_shape)`` to the list it
    yields (the benchmark's operation counts read them)."""
    _LOWER.record = []
    try:
        yield _LOWER.record
    finally:
        _LOWER.record = None


def _note(kind, x, what, out):
    record = getattr(_LOWER, 'record', None)
    if record is not None:
        record.append((kind, tuple(x.shape), what, tuple(out.shape)))
    return out


def matmul(a, b):
    """``a @ b`` of two tensors of at least two dimensions, both rounded
    under :func:`lowered`; recorded as ``('matmul', rows + (k,), (k, m),
    out_shape)``, ``rows`` the product's leading dimensions, so that the
    operation counts take its ``2·rows·k·m``."""
    out = _round(a) @ _round(b)
    k, m = b.shape[-2:]
    record = getattr(_LOWER, 'record', None)
    if record is not None:
        record.append(('matmul', tuple(out.shape[:-1]) + (k,), (k, m),
                       tuple(out.shape)))
    return out


def linear(x, layer):
    return _note('linear', x, layer,
                 F.linear(_round(x), _round(layer.weight), layer.bias))


def conv(x, layer):
    return _note('conv', x, layer,
                 F.conv2d(_round(x), _round(layer.weight), layer.bias,
                          layer.stride, layer.padding, layer.dilation,
                          layer.groups))


def batch_norm(x, bn, train=False):
    """Running statistics, or (``train``) the batch's mean and biased
    variance over every axis but 1, moving the running ones by
    ``bn.momentum`` with the biased variance."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    dims = [d for d in range(x.dim()) if d != 1]
    var, mean = torch.var_mean(x, dims, unbiased=False)
    shape = [1, -1] + [1] * (x.dim() - 2)
    out = (x - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape) \
        * bn.weight.view(shape) + bn.bias.view(shape)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    return out


class ConvBN(nn.Module):

    def __init__(self, cin, cout, k=3, s=1, groups=1, act=hard_swish):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, k, s, (k - 1) // 2, groups=groups,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)
        self.act = act

    def forward(self, x, train=False):
        x = batch_norm(conv(x, self.Conv_0), self.BatchNorm_0, train)
        return x if self.act is None else self.act(x)


class SqueezeExcite(nn.Module):

    def __init__(self, channels, reduction=4):
        super().__init__()
        hidden = make_divisible(channels // reduction, 8)
        self.Dense_0 = nn.Linear(channels, hidden)
        self.Dense_1 = nn.Linear(hidden, channels)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = hard_sigmoid(linear(F.relu(linear(y, self.Dense_0)),
                                self.Dense_1))
        return x * y[:, :, None, None]


class InvertedResidual(nn.Module):
    """MobileNetV3 block: expand → depthwise → (SE) → project."""

    def __init__(self, cin, hidden, cout, k, s, use_se, use_hs,
                 se_after_act=False):
        super().__init__()
        self.act = hard_swish if use_hs else F.relu
        self.identity = s == 1 and cin == cout
        self.act_first = cin == hidden or se_after_act
        convs = []
        if cin != hidden:
            convs.append(ConvBN(cin, hidden, 1, 1, act=self.act))
        convs.append(ConvBN(hidden, hidden, k, s, groups=hidden, act=None))
        convs.append(ConvBN(hidden, cout, 1, 1, act=None))
        for i, m in enumerate(convs):
            self.add_module(f'ConvBN_{i}', m)
        self.n_convs = len(convs)
        self.SqueezeExcite_0 = SqueezeExcite(hidden) if use_se else None

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


class MBConv(nn.Module):
    """MobileNetV2 / EfficientNet-lite block with ReLU6, no SE."""

    def __init__(self, cin, cout, expand, s, k=3):
        super().__init__()
        hidden = cin * expand
        self.identity = s == 1 and cin == cout
        convs = []
        if expand != 1:
            convs.append(ConvBN(cin, hidden, 1, 1, act=F.relu6))
        convs.append(ConvBN(hidden, hidden, k, s, groups=hidden,
                            act=F.relu6))
        convs.append(ConvBN(hidden, cout, 1, 1, act=None))
        self.n_convs = len(convs)
        for i, m in enumerate(convs):
            self.add_module(f'ConvBN_{i}', m)

    def forward(self, x, train=False):
        y = x
        for i in range(self.n_convs):
            y = getattr(self, f'ConvBN_{i}')(y, train)
        return x + y if self.identity else y


MNV2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2(nn.Module):

    def __init__(self, width_mult=1.0, out_stages=(4, 6)):
        super().__init__()
        self.out_stages = tuple(out_stages)
        cin = make_divisible(32 * width_mult, 8)
        self.ConvBN_0 = ConvBN(3, cin, 3, 2, act=F.relu6)
        self.stage_ends = []
        n = 0
        for t, c, reps, s in MNV2_CFG:
            cout = make_divisible(c * width_mult, 8)
            for i in range(reps):
                self.add_module(f'_MBConv_{n}',
                                MBConv(cin, cout, t, s if i == 0 else 1))
                cin = cout
                n += 1
            self.stage_ends.append(n - 1)
        self.n_blocks = n
        self.out_channels = tuple(make_divisible(MNV2_CFG[i][1] * width_mult,
                                                 8) for i in self.out_stages)

    def forward(self, x, train=False):
        x = self.ConvBN_0(x, train)
        outs = []
        ends = {self.stage_ends[i] for i in self.out_stages}
        for b in range(self.n_blocks):
            x = getattr(self, f'_MBConv_{b}')(x, train)
            if b in ends:
                outs.append(x)
        return tuple(outs)


MNV3_LARGE_CFG = (
    (3, 1, 16, 0, 0, 1), (3, 4, 24, 0, 0, 2), (3, 3, 24, 0, 0, 1),
    (5, 3, 40, 1, 0, 2), (5, 3, 40, 1, 0, 1), (5, 3, 40, 1, 0, 1),
    (3, 6, 80, 0, 1, 2), (3, 2.5, 80, 0, 1, 1), (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1), (3, 6, 112, 1, 1, 1), (3, 6, 112, 1, 1, 1),
    (5, 6, 160, 1, 1, 2), (5, 6, 160, 1, 1, 1), (5, 6, 160, 1, 1, 1))


class MobileNetV3Large21k(nn.Module):
    """timm's ``mobilenetv3_large_100``: SE after the activation, a dense
    head without batch norm."""
    feature_dim = 1280

    def __init__(self):
        super().__init__()
        cin = 16
        blocks = [ConvBN(3, cin, 3, 2, act=hard_swish)]
        exp = cin
        for k, t, c, se, hs, s in MNV3_LARGE_CFG:
            cout = make_divisible(c, 8)
            exp = make_divisible(cin * t, 8)
            blocks.append(InvertedResidual(cin, exp, cout, int(k), int(s),
                                           bool(se), bool(hs),
                                           se_after_act=True))
            cin = cout
        blocks.append(ConvBN(cin, exp, 1, 1, act=hard_swish))
        self.n_blocks = len(blocks)
        for i, b in enumerate(blocks):
            self.add_module(f'blocks_{i}', b)
        self.head_dense = nn.Linear(exp, self.feature_dim)
        self.head_bn = None

    def features(self, x, train=False):
        for i in range(self.n_blocks):
            x = getattr(self, f'blocks_{i}')(x, train)
        return x

    def head(self, pooled, train=False):
        return hard_swish(linear(pooled, self.head_dense))


EL0_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
              (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
              (6, 320, 1, 1, 3))


class EfficientNetLite0(nn.Module):
    feature_dim = 1280

    def __init__(self):
        super().__init__()
        blocks = [ConvBN(3, 32, 3, 2, act=F.relu6)]
        cin = 32
        for expand, c, reps, s, k in EL0_STAGES:
            for r in range(reps):
                blocks.append(MBConv(cin, c, expand, s if r == 0 else 1, k))
                cin = c
        blocks.append(ConvBN(cin, self.feature_dim, 1, 1, act=F.relu6))
        self.n_blocks = len(blocks)
        for i, b in enumerate(blocks):
            self.add_module(f'blocks_{i}', b)

    def features(self, x, train=False):
        for i in range(self.n_blocks):
            x = getattr(self, f'blocks_{i}')(x, train)
        return x

    def head(self, pooled, train=False):
        return pooled


BACKBONES = {'mobilenetv3_large_21k': MobileNetV3Large21k,
             'efficientnet-lite0': EfficientNetLite0}


def backbone_module(name):
    """The module of a regressor backbone that :data:`BACKBONES` does not
    hold: ``backbone_<name>.py`` beside this file, ``-`` and ``.`` of the
    name read as ``_``.  It defines ``Backbone`` (``feature_dim``,
    ``features(x, train)`` → NCHW, ``head(pooled, train)``) and, where it
    needs them, ``leaf_std(name, p)`` (the std of a leaf of its own that
    ``harness/weights.py`` should draw otherwise, or None) and
    ``bounds(rows, crop, itemsize, train)`` (``{kernel: seconds}``, the
    least time of each kernel it counts in one call or step over ``rows``
    crops).  None for a name of :data:`BACKBONES`; an unknown name
    raises."""
    if name in BACKBONES:
        return None
    slug = name.replace('-', '_').replace('.', '_')
    spec = importlib.util.find_spec(f'{__package__}.backbone_{slug}')
    if spec is None:
        raise KeyError(f'unknown backbone {name!r}: the reference knows '
                       f'{sorted(BACKBONES)} and no file backbone_{slug}.py')
    return importlib.import_module(spec.name)



class MultiHeadRegressor(nn.Module):
    """NHWC crops → every class's 9 keypoints (pre-sigmoid ``[B,9,18]``)
    and the class logits; with ``cats`` the ground-truth class's keypoints
    after the sigmoid ``[B,9,2]`` and the logits, the classifier's input
    dropped out at ``dropout_rate`` from ``generator`` in training."""

    def __init__(self, backbone, num_classes=9, dropout_rate=0.5):
        super().__init__()
        mod = backbone_module(backbone)
        self.backbone = (BACKBONES[backbone] if mod is None
                         else mod.Backbone)()
        self._leaf_std = getattr(mod, 'leaf_std', None)
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        c = self.backbone.feature_dim
        self.head_kernel = nn.Parameter(torch.zeros(9, c, 18))
        self.head_bias = nn.Parameter(torch.zeros(9, 18))
        self.cls_fc = nn.Linear(c, num_classes)

    def leaf_std(self, name, p):
        """The backbone file's std for leaf ``name`` (of this model's
        ``named_parameters``), or None for the default rule."""
        if self._leaf_std is None or not name.startswith('backbone.'):
            return None
        return self._leaf_std(name[len('backbone.'):], p)

    def forward(self, x, cats=None, train=False, generator=None):
        x = x.float().permute(0, 3, 1, 2)
        pooled = self.backbone.head(
            self.backbone.features(x, train).mean(dim=(2, 3)), train)
        b, c = pooled.shape
        kernel = self.head_kernel.permute(1, 0, 2).reshape(c, -1)
        all_kp = _note('matmul', pooled, tuple(kernel.shape),
                       pooled @ kernel + self.head_bias.reshape(-1))
        all_kp = all_kp.view(b, 9, 18)
        if cats is None:
            return all_kp, linear(pooled, self.cls_fc)
        idx = cats.long().view(b, 1, 1).expand(b, 1, 18)
        kp = torch.sigmoid(all_kp.gather(1, idx)).view(b, 9, 2)
        if train and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            u = torch.rand(pooled.shape, generator=generator,
                           device=generator.device)
            pooled = torch.where(u.to(pooled.device) < keep, pooled / keep,
                                 0.0)
        return kp, linear(pooled, self.cls_fc)


# --- the detector ------------------------------------------------------------

INPUT_SIZE = 300
STRIDES = (16, 32)
CLUSTERED_WIDTHS = (
    (0.2579684384230685, 0.4627705986569778, 0.34682129636083536,
     0.641596163690939),
    (0.5420266488537757, 0.430022826081911, 0.7605568897973095,
     0.6358004294180672, 0.5529565428117278, 0.8008912664437589))
CLUSTERED_HEIGHTS = (
    (0.2270640055663951, 0.30064816327707244, 0.4627093933691148,
     0.33801734483143625),
    (0.47856221526606557, 0.6557960498140745, 0.49101025166070583,
     0.6256796503549162, 0.8331586024284066, 0.7244268959927074))
DEFAULT_STDS = (0.1, 0.1, 0.2, 0.2)
CASCADE_STDS = (0.05, 0.05, 0.1, 0.1)


def generate_anchors(size=INPUT_SIZE):
    """``[A,4]`` xyxy anchors, level by level, row-major, anchor fastest."""
    out = []
    for stride, ws, hs in zip(STRIDES, CLUSTERED_WIDTHS, CLUSTERED_HEIGHTS):
        fm = math.ceil(size / stride)
        centers = (np.arange(fm, dtype=np.float32) + 0.5) * stride
        cx, cy = np.meshgrid(centers, centers)
        w = np.asarray(ws, np.float32) * size
        h = np.asarray(hs, np.float32) * size
        cx, cy = cx[:, :, None], cy[:, :, None]
        out.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            -1).reshape(-1, 4))
    return np.concatenate(out)


def _cxcywh(b):
    wh = b[..., 2:4] - b[..., 0:2]
    return b[..., 0:2] + wh * 0.5, wh


def decode_boxes(anchors, deltas, stds=DEFAULT_STDS, max_wh_ratio=16.0):
    d = deltas * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    ac, awh = _cxcywh(anchors)
    cxy = ac + d[..., 0:2] * awh
    clip = math.log(max_wh_ratio)
    wh = awh * torch.exp(d[..., 2:4].clamp(-clip, clip))
    return torch.cat([cxy - wh * 0.5, cxy + wh * 0.5], -1)


class _DepthwiseHead(nn.Module):

    def __init__(self, cin, out, k):
        super().__init__()
        self.out = out
        self.ConvBN_0 = ConvBN(cin, cin, 3, 1, groups=cin, act=F.relu)
        self.Conv_0 = nn.Conv2d(cin, k * out, 1)

    def forward(self, x, train=False):
        y = conv(self.ConvBN_0(x, train), self.Conv_0)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.out)


class SSDDetector(nn.Module):
    """NHWC ``[B,300,300,3]`` → class logits ``[B,A,C+1]`` and the boxes
    ``[B,A,4]`` (xyxy, detector pixels) decoded from each anchor, through
    the second regression head with ``cascade``."""

    def __init__(self, num_classes=9, width_mult=1.0, cascade=False):
        super().__init__()
        self.cascade = cascade
        self.backbone = MobileNetV2(width_mult)
        kinds = ['cls_heads', 'reg_heads'] + (['reg2_heads'] if cascade
                                              else [])
        for kind in kinds:
            out = num_classes + 1 if kind == 'cls_heads' else 4
            for i, (c, k) in enumerate(zip(self.backbone.out_channels,
                                           [len(w) for w in
                                            CLUSTERED_WIDTHS])):
                self.add_module(f'{kind}_{i}', _DepthwiseHead(c, out, k))
        self.register_buffer('anchors', torch.from_numpy(generate_anchors()),
                             persistent=False)

    def _heads(self, kind, feats, train):
        return torch.cat([getattr(self, f'{kind}_{i}')(f, train)
                          for i, f in enumerate(feats)], 1)

    def forward(self, x, train=False):
        feats = self.backbone(x.float().permute(0, 3, 1, 2), train)
        logits = self._heads('cls_heads', feats, train)
        boxes = decode_boxes(self.anchors.to(logits.device),
                             self._heads('reg_heads', feats, train))
        if self.cascade:
            boxes = decode_boxes(boxes, self._heads('reg2_heads', feats,
                                                    train), CASCADE_STDS)
        return logits, boxes
