"""Pinned key/shape contracts of the published pretrained checkpoints (a
copy of ``tpudet3d/utils/pretrained_contract.py`` built on the port's own
model schedules).

The reference loads three families of published ImageNet checkpoints
(d-li14 mobilenetv3 large/small, the MIIL ImageNet-21k timm
``mobilenetv3_large_100``, the packaged ``efficientnet_lite_pytorch``
weights).  Each checkpoint's full ordered key/shape list is rebuilt here
from the published architecture and pinned as a contract, which
``utils/torch_import.py``'s ordered-shape matcher must consume exactly, so
a real checkpoint cannot desync it quietly.

Two published totals check the reconstructions (they pin every channel
width, the SE bottlenecks included):

* timm ``mobilenetv3_large_100`` at 1000 classes → **5,483,032**
  parameters;
* ``efficientnet-lite0`` at 1000 classes → **4,652,008** parameters.

A contract is the ordered ``[(key, shape), ...]`` that
``state_dict().items()`` yields (module definition order), with the
``num_batches_tracked`` scalars (shape ``()``).
"""

import math

from ..models.efficientnet_lite import (_B0_STAGES, EFFNET_LITE_PARAMS,
                                        _round_filters, _round_repeats)
from ..models.layers import make_divisible
from ..models.mobilenetv3 import MNV3_LARGE_CFG, MNV3_SMALL_CFG

__all__ = ['timm_mobilenetv3_large_100', 'dli14_mobilenetv3',
           'efficientnet_lite', 'contract_param_count', 'PARAM_COUNTS',
           'verify_state_dict']

# externally published totals the reconstructions must reproduce exactly
PARAM_COUNTS = {
    'timm_mobilenetv3_large_100': 5_483_032,
    'efficientnet-lite0': 4_652_008,
}


def _bn(prefix, c):
    return [(f'{prefix}.weight', (c,)), (f'{prefix}.bias', (c,)),
            (f'{prefix}.running_mean', (c,)), (f'{prefix}.running_var', (c,)),
            (f'{prefix}.num_batches_tracked', ())]


# --------------------------------------------------------------------------
# timm mobilenetv3_large_100 (the MIIL 21k checkpoint's layout;
# reference torchdet3d/models/mobilenetv3.py:16-17, 224-231)
# --------------------------------------------------------------------------

# timm groups the cfg rows into stages: blocks.{stage}.{idx}
_TIMM_LARGE_STAGES = (1, 2, 3, 4, 2, 3)


def timm_mobilenetv3_large_100(num_classes=1000):
    """Ordered key/shape list of a timm ``mobilenetv3_large_100`` state_dict.

    ``num_classes=11221`` gives the MIIL ImageNet-21k-P checkpoint
    (``mobilenetv3_large_100_miil_21k.pth``), 1000 the ImageNet-1k ones.
    SE bottlenecks use the paper rule (expanded/4 rounded to a multiple
    of 8) — validated by the 5,483,032 total below.
    """
    out = [('conv_stem.weight', (16, 3, 3, 3))] + _bn('bn1', 16)
    rows = iter(enumerate(MNV3_LARGE_CFG))
    inp = 16
    stage = 0
    # stage 0: the depthwise-separable block (ds_r1_k3_s1_e1_c16_nre)
    _, (k, t, c, use_se, _hs, s) = next(rows)
    p = 'blocks.0.0'
    out += [(f'{p}.conv_dw.weight', (16, 1, 3, 3))] + _bn(f'{p}.bn1', 16)
    out += [(f'{p}.conv_pw.weight', (16, 16, 1, 1))] + _bn(f'{p}.bn2', 16)
    # stages 1..5: inverted residuals
    for stage, n in enumerate(_TIMM_LARGE_STAGES[1:], start=1):
        for idx in range(n):
            _, (k, t, c, use_se, _hs, s) = next(rows)
            outc = make_divisible(c)
            hid = make_divisible(inp * t)
            p = f'blocks.{stage}.{idx}'
            out += [(f'{p}.conv_pw.weight', (hid, inp, 1, 1))]
            out += _bn(f'{p}.bn1', hid)
            out += [(f'{p}.conv_dw.weight', (hid, 1, int(k), int(k)))]
            out += _bn(f'{p}.bn2', hid)
            if use_se:
                rd = make_divisible(hid // 4)
                out += [(f'{p}.se.conv_reduce.weight', (rd, hid, 1, 1)),
                        (f'{p}.se.conv_reduce.bias', (rd,)),
                        (f'{p}.se.conv_expand.weight', (hid, rd, 1, 1)),
                        (f'{p}.se.conv_expand.bias', (hid,))]
            out += [(f'{p}.conv_pwl.weight', (outc, hid, 1, 1))]
            out += _bn(f'{p}.bn3', outc)
            inp = outc
    # final stage: ConvBnAct cn_r1_k1_s1_c960
    out += [('blocks.6.0.conv.weight', (960, 160, 1, 1))]
    out += _bn('blocks.6.0.bn1', 960)
    out += [('conv_head.weight', (1280, 960, 1, 1)),
            ('conv_head.bias', (1280,)),
            ('classifier.weight', (num_classes, 1280)),
            ('classifier.bias', (num_classes,))]
    return out


# --------------------------------------------------------------------------
# d-li14 mobilenetv3 large/small (the gdown checkpoints;
# reference torchdet3d/models/mobilenetv3.py:12-15 and the trunk :126-203)
# --------------------------------------------------------------------------

def dli14_mobilenetv3(mode='large'):
    """Ordered key/shape list of a d-li14 ``mobilenetv3-{large,small}`` pth.

    Trunk layout is the reference's own module (it vendors the d-li14
    implementation); the published checkpoint's classifier is the d-li14
    original — ``Sequential(Linear, h_swish, Dropout, Linear(num=1000))``,
    keys ``classifier.0`` / ``classifier.3``.  The reference replaces the
    classifier (Linear→BatchNorm1d→h_swish) and loads tolerantly, so
    ``classifier.0`` maps onto the new head and ``classifier.3`` is dropped
    (torchdet3d/utils/utils.py:127-183 name-based tolerance; our FIFO
    matcher reproduces exactly that consumption).
    """
    cfgs = {'large': MNV3_LARGE_CFG, 'small': MNV3_SMALL_CFG}[mode]
    feature_dim = {'large': 1280, 'small': 1024}[mode]
    out = [('features.0.0.weight', (16, 3, 3, 3))] + _bn('features.0.1', 16)
    inp = 16
    hid = 16
    for i, (k, t, c, use_se, _hs, s) in enumerate(cfgs, start=1):
        outc = make_divisible(c)
        hid = make_divisible(inp * t)
        p = f'features.{i}.conv'
        if hid == inp:      # dw-first variant: dw(0) bn(1) act(2) SE(3) pw(4) bn(5)
            out += [(f'{p}.0.weight', (hid, 1, int(k), int(k)))]
            out += _bn(f'{p}.1', hid)
            if use_se:
                rd = make_divisible(hid // 4)
                out += [(f'{p}.3.fc.0.weight', (rd, hid)),
                        (f'{p}.3.fc.0.bias', (rd,)),
                        (f'{p}.3.fc.2.weight', (hid, rd)),
                        (f'{p}.3.fc.2.bias', (hid,))]
            out += [(f'{p}.4.weight', (outc, hid, 1, 1))]
            out += _bn(f'{p}.5', outc)
        else:               # pw(0) bn(1) act(2) dw(3) bn(4) SE(5) act(6) pwl(7) bn(8)
            out += [(f'{p}.0.weight', (hid, inp, 1, 1))]
            out += _bn(f'{p}.1', hid)
            out += [(f'{p}.3.weight', (hid, 1, int(k), int(k)))]
            out += _bn(f'{p}.4', hid)
            if use_se:
                rd = make_divisible(hid // 4)
                out += [(f'{p}.5.fc.0.weight', (rd, hid)),
                        (f'{p}.5.fc.0.bias', (rd,)),
                        (f'{p}.5.fc.2.weight', (hid, rd)),
                        (f'{p}.5.fc.2.bias', (hid,))]
            out += [(f'{p}.7.weight', (outc, hid, 1, 1))]
            out += _bn(f'{p}.8', outc)
        inp = outc
    out += [('conv.0.weight', (hid, inp, 1, 1))] + _bn('conv.1', hid)
    out += [('classifier.0.weight', (feature_dim, hid)),
            ('classifier.0.bias', (feature_dim,)),
            ('classifier.3.weight', (1000, feature_dim)),
            ('classifier.3.bias', (1000,))]
    return out


# --------------------------------------------------------------------------
# efficientnet_lite_pytorch lite0/1/2 (the packaged weights the reference
# defaults to; torchdet3d/builders/model_builder.py:19-29).  Lukemelas-style
# layout: _conv_stem/_bn0, _blocks.N.{_expand_conv,_bn0,_depthwise_conv,
# _bn1,_project_conv,_bn2}, _conv_head/_bn1, _fc — lite rules: no SE,
# fixed stem(32)/head(1280), first/last stage depth unscaled.
# --------------------------------------------------------------------------

def efficientnet_lite(name='efficientnet-lite0', num_classes=1000):
    width_mult, depth_mult = EFFNET_LITE_PARAMS[name][:2]
    out = [('_conv_stem.weight', (32, 3, 3, 3))] + _bn('_bn0', 32)
    inp = 32
    bi = 0
    n_stages = len(_B0_STAGES)
    for si, (expand, channels, repeats, stride, kernel) in enumerate(_B0_STAGES):
        outc = _round_filters(channels, width_mult)
        reps = (repeats if si in (0, n_stages - 1)
                else _round_repeats(repeats, depth_mult))
        for i in range(reps):
            hid = inp * expand
            p = f'_blocks.{bi}'
            if expand != 1:
                out += [(f'{p}._expand_conv.weight', (hid, inp, 1, 1))]
                out += _bn(f'{p}._bn0', hid)
            out += [(f'{p}._depthwise_conv.weight', (hid, 1, kernel, kernel))]
            out += _bn(f'{p}._bn1', hid)
            out += [(f'{p}._project_conv.weight', (outc, hid, 1, 1))]
            out += _bn(f'{p}._bn2', outc)
            inp = outc
            bi += 1
    out += [('_conv_head.weight', (1280, inp, 1, 1))] + _bn('_bn1', 1280)
    out += [('_fc.weight', (num_classes, 1280)), ('_fc.bias', (num_classes,))]
    return out


_BUFFER_SUFFIXES = ('running_mean', 'running_var', 'num_batches_tracked')


def contract_param_count(contract):
    """Trainable-parameter total (published counts exclude BN buffers)."""
    return sum(math.prod(s) for k, s in contract
               if not k.endswith(_BUFFER_SUFFIXES))


def verify_state_dict(state_dict, contract):
    """Compare a real torch state_dict against a contract.

    Returns a dict with ``missing`` (in contract, not in ckpt), ``extra``
    (in ckpt, not in contract), ``shape_mismatch`` ([(key, got, want)]),
    and ``order_ok`` (ckpt iteration order equals contract order on the
    common keys — the property the FIFO matcher relies on).
    """
    want = dict(contract)
    got = {k: tuple(getattr(v, 'shape', ())) for k, v in state_dict.items()}
    missing = [k for k, _ in contract if k not in got]
    extra = [k for k in got if k not in want]
    mism = [(k, got[k], want[k]) for k in got
            if k in want and got[k] != want[k]]
    common_got = [k for k in got if k in want]
    common_want = [k for k, _ in contract if k in got]
    return dict(missing=missing, extra=extra, shape_mismatch=mism,
                order_ok=common_got == common_want,
                ok=not missing and not extra and not mism
                and common_got == common_want)
