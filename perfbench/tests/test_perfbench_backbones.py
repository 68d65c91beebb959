"""A regressor backbone that no benchmark file names enters by new files
alone: ``reference/backbone_<name>.py`` (its reference, the std of its
own leaves, its kernels' bounds) and a configuration.  Here a toy with a
patch conv, a LayerNorm and one self-attention (QKᵀ and AV through
``matmul``) is written into a folder added to the reference package's
search path; on the port's side a twin stands in for
``build_backbone``, which does not know it."""

import json
import sys
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import reference
import run
from harness import weights, yardstick
from reference import models as m

NAME = 'toy-attn.v1'                 # found as backbone_toy_attn_v1.py
MODULE = 'reference.backbone_toy_attn_v1'
PATCH, WIDTH = 8, 16

TOY = f'''
"""A toy backbone for the tests: a patch conv, a LayerNorm, one
self-attention over the patches with a learned bias."""

import torch
import torch.nn.functional as F
from torch import nn

from .models import conv, matmul

PATCH, WIDTH = {PATCH}, {WIDTH}


class Backbone(nn.Module):
    feature_dim = WIDTH

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, WIDTH, PATCH, PATCH)
        self.LayerNorm_0 = nn.LayerNorm(WIDTH)
        self.bias_table = nn.Parameter(torch.zeros(WIDTH, WIDTH))

    def features(self, x, train=False):
        y = conv(x, self.Conv_0)
        b, c, h, w = y.shape
        t = F.layer_norm(y.flatten(2).transpose(1, 2), (c,),
                         self.LayerNorm_0.weight, self.LayerNorm_0.bias)
        a = torch.softmax(matmul(t, t.transpose(1, 2)) / c ** 0.5
                          + self.bias_table.mean(), -1)
        return matmul(a, t).transpose(1, 2).reshape(b, c, h, w)

    def head(self, pooled, train=False):
        return pooled


def leaf_std(name, p):
    return 0.02 if name == 'bias_table' else None


def bounds(rows, crop, itemsize, train):
    from harness.yardstick import bound_s
    n = (crop[0] // PATCH) * (crop[1] // PATCH)
    ops = 2 * 2 * rows * n * n * WIDTH * (3 if train else 1)
    return {{'toy_attn': bound_s(2 * rows * n * WIDTH * itemsize, ops)}}
'''


class PortTwin(nn.Module):
    """The toy as the port would hold it: the same leaves, the conv in the
    dtype of its input, the norm and the attention accumulated in float32
    as an attention kernel does."""
    feature_dim = WIDTH

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, WIDTH, PATCH, PATCH)
        self.LayerNorm_0 = nn.LayerNorm(WIDTH)
        self.bias_table = nn.Parameter(torch.zeros(WIDTH, WIDTH))

    def features(self, x, train=False):
        dt = x.dtype
        y = F.conv2d(x, self.Conv_0.weight.to(dt), self.Conv_0.bias.to(dt),
                     PATCH)
        b, c, h, w = y.shape
        t = F.layer_norm(y.float().flatten(2).transpose(1, 2), (c,),
                         self.LayerNorm_0.weight, self.LayerNorm_0.bias)
        a = torch.softmax(t @ t.transpose(1, 2) / c ** 0.5
                          + self.bias_table.mean(), -1)
        return (a @ t).transpose(1, 2).reshape(b, c, h, w).to(dt)

    def head(self, pooled, train=False):
        return pooled


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's file in a folder of its own on the reference package's
    path, and the twin behind the port's ``build_backbone``."""
    (tmp_path / 'backbone_toy_attn_v1.py').write_text(TOY)
    monkeypatch.setattr(reference, '__path__',
                        list(reference.__path__) + [str(tmp_path)])
    from tpudet3d_torch.models import builder
    real = builder.build_backbone
    monkeypatch.setattr(builder, 'build_backbone',
                        lambda name: PortTwin() if name == NAME
                        else real(name))
    yield
    sys.modules.pop(MODULE, None)


def toy_config():
    bench, _, cfg, _ = run.load_cell('serve.el0.b32')
    cfg = json.loads(json.dumps(cfg))
    cfg['name'] = 'toy'
    cfg['regressor']['backbone'] = NAME
    cfg['train']['model']['name'] = NAME
    # the toy's own limit: its 16 features average bf16's rounding far
    # less than el0's 1280 (sound runs read 0.0035 here)
    cfg['limits']['serve']['kp_gap'] = 0.02
    return bench, cfg


def test_an_unknown_backbone_raises():
    with pytest.raises(KeyError, match='unknown backbone'):
        m.MultiHeadRegressor('no-such-net')


def test_the_backbones_of_the_dict_come_from_no_file():
    for name in m.BACKBONES:
        assert m.backbone_module(name) is None
        assert yardstick.backbone_bounds(name, 8, (224, 224), 2, False,
                                         5) == {}


def test_a_backbone_file_is_found_by_name_and_drawn(toy):
    reg = m.MultiHeadRegressor(NAME)
    assert type(reg.backbone).__module__ == MODULE
    weights.draw(reg, 7, 'cpu')
    leaf = {k: v.detach() for k, v in reg.backbone.named_parameters()}
    scale = leaf['LayerNorm_0.weight']
    assert 0.5 <= float(scale.min()) and float(scale.max()) <= 1.5
    assert 0.03 < float(leaf['LayerNorm_0.bias'].std()) < 0.3  # N(0, 0.1)
    assert float(leaf['bias_table'].std()) < 0.04        # its own: 0.02
    conv_std = float(leaf['Conv_0.weight'].std())
    assert conv_std == pytest.approx((2.0 / (3 * PATCH * PATCH)) ** 0.5,
                                     rel=0.2)


def test_its_products_are_counted_and_rounded(toy):
    b, size = 2, 64
    n = (size // PATCH) ** 2
    with torch.device('meta'):
        reg = m.MultiHeadRegressor(NAME)
        total, first = yardstick.forward_flops(
            reg, torch.empty(b, size, size, 3))
    stem = 2 * b * n * WIDTH * 3 * PATCH * PATCH
    attention = 2 * (2 * b * n * WIDTH * n)               # QKᵀ and AV
    heads = 2 * b * WIDTH * 9 * 18 + 2 * b * WIDTH * 9
    assert first == stem and total == stem + attention + heads
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 7, generator=g)
    y = torch.randn(3, 7, 4, generator=g)
    with m.lowered('fp8'):
        low = m.matmul(x, y)
    assert torch.equal(m.matmul(x, y), x @ y)

    def fp8(t):
        scale = t.abs().amax() / m.FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    assert torch.equal(low, fp8(x) @ fp8(y))
    assert not torch.equal(low, x @ y)


def ctx_of(cfg, traffic, trace):
    return SimpleNamespace(seed=2 ** 31 + 5, seconds=0.2, trace=trace,
                           control=None, cfg=cfg, traffic=traffic,
                           device='cpu', t0=0.0, trace_calls=2)


SMALL = {'serve': dict(batch=2, height=72, width=128, pool=2,
                       calibration_frames=2),
         'train': dict(batch=4, size=64, pool=4, calibration_images=4)}


@pytest.mark.parametrize('cell', ['serve.el0.b32', 'train.el0.b128'])
def test_its_bounds_reach_the_trace(toy, cell):
    _, cfg = toy_config()
    traffic = run.load_cell(cell)[3]
    traffic = dict(traffic, **SMALL[traffic['kind']])
    out = run.driver(traffic['kind'])(ctx_of(cfg, traffic, True))
    rows = (traffic['batch'] * cfg['serve']['max_detections']
            if traffic['kind'] == 'serve' else traffic['batch'])
    crop = tuple(cfg['regressor']['crop']) if traffic['kind'] == 'serve' \
        else (traffic['size'],) * 2
    one = m.backbone_module(NAME).bounds(rows, crop, 2,
                                         traffic['kind'] == 'train')
    assert out['trace']['bounds'] == {'toy_attn': [one['toy_attn']] * 2}


@pytest.mark.parametrize('cell', ['serve.el0.b32', 'train.el0.b128'])
def test_it_runs_through_a_whole_cell(toy, capsys, cell):
    """Through ``run.run_cell`` with a configuration and a cell that exist
    only in memory: no file of the benchmark changes."""
    bench, cfg = toy_config()
    _, entry, _, traffic = run.load_cell(cell)
    traffic = dict(traffic, **SMALL[traffic['kind']])
    entry = dict(entry, name=entry['name'].replace('el0', 'toy'),
                 config='toy')
    assert run.run_cell(bench, entry, cfg, traffic, 2 ** 31 + 5, 0.2, 0,
                        None, 'cpu') == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['correct'] is True, out['checks']
    assert out['metrics']['setup_s']['value'] > 0
