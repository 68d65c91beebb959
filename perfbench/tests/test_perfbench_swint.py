"""The Swin-T cell ``serve.swint.b32`` against its planted faults and its
control, each a whole run of the cell on the CPU at a small size (8
frames of 72×128, 8 crops of 224² each), and the per-layer reader of K8.
The faults are planted where the port computes: K8's call without the
shift mask, without the relative-position bias, and the blocks' shift
applied on the last stage's one window.  On the card (``-m cuda``) the
same faults at the cell's own size, three seeds each."""

import json

import pytest
import torch

import run
from harness import common, yardstick
from reference import models as ref_models

CELL = 'serve.swint.b32'
NAME = 'swin_tiny_patch4_window7_224'
# 8 frames: at 64 crops a call the weakest fault (the shift at stage 4)
# reads kp_gap 0.031-0.053 on three seeds against the limit of 0.025
# (0.025-0.042 at 32 crops, 0.018-0.044 at 16), sound runs 0.0066-0.0075;
# four host threads, since the float32 reference of Swin-T is the run's
# longest part on the CPU
SMALL = dict(batch=8, height=72, width=128, pool=2, calibration_frames=2,
             threads=4)
SEED = 2 ** 31 + 11


def plant_no_mask(setattr):
    """K8 called without its shift mask in the shifted blocks."""
    from tpudet3d_torch.models import swin
    real = swin.window_attention
    setattr(swin, 'window_attention',
            lambda *a, **k: real(*a, **dict(k, masked=False)))


def plant_no_bias(setattr):
    """K8 called without the relative-position bias table."""
    from tpudet3d_torch.models import swin
    real = swin.window_attention
    setattr(swin, 'window_attention',
            lambda qkv, table, *a, **k: real(qkv, None, *a, **k))


def plant_shift_at_stage4(setattr):
    """The odd blocks shifted (and masked) on the 7×7 map of the last
    stage too, which is one window."""
    from tpudet3d_torch.models import swin
    setattr(swin, 'block_shift', lambda index, resolution, window:
            window // 2 if index % 2 else 0)


SWIN_FAULTS = {'no_mask': plant_no_mask, 'no_bias': plant_no_bias,
               'shift_at_stage4': plant_shift_at_stage4}


def drive(capsys, control=None, trace=0, seed=SEED):
    bench, cell, config, traffic = run.load_cell(CELL)
    traffic = dict(traffic, **SMALL)
    torch.manual_seed(0)
    assert run.run_cell(bench, cell, config, traffic, seed, 0.2, trace,
                        control, 'cpu') == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_sound_path_is_correct(capsys):
    out = drive(capsys, trace=1)
    assert out['correct'] is True, out['checks']
    assert out['checks']['rows_missing']['value'] == 0


@pytest.mark.parametrize('fault', sorted(SWIN_FAULTS))
def test_a_faulty_window_attention_is_not_correct(capsys, monkeypatch,
                                                  fault):
    SWIN_FAULTS[fault](monkeypatch.setattr)
    out = drive(capsys)
    assert out['correct'] is False
    assert out['checks']['kp_gap']['value'] > \
        out['checks']['kp_gap']['limit']


def test_the_control_is_not_correct(capsys):
    """The reference in float8 in the program's place."""
    assert drive(capsys, control='fp8')['correct'] is False


def test_the_bound_counts_the_attention_of_the_twelve_blocks():
    """Bytes: q, k, v read and the output written once a token and block
    (4C a token at itemsize), and each block's table; operations:
    2·(2·49·49·32) a window and head."""
    mod = ref_models.backbone_module(NAME)
    n_bytes, n_ops = mod.attention_work(256, (224, 224), 2)
    tokens = [256 * s * s for s in (56, 28, 14, 7)]
    assert n_bytes == sum(d * (t * 4 * c * 2 + 169 * h * 4) for d, t, c, h
                          in zip((2, 2, 6, 2), tokens, (96, 192, 384, 768),
                                 (3, 6, 12, 24)))
    assert n_ops == 912 * 256 * 2 * 2 * 49 * 49 * 32
    (b,) = mod.bounds(256, (224, 224), 2, False).values()
    assert b == pytest.approx(max(n_bytes / yardstick.HBM_BYTES_PER_S,
                                  n_ops / yardstick.PEAK_BF16_FLOPS))
    assert yardstick.backbone_bounds(NAME, 256, (224, 224), 2, False, 5) \
        == {'window_attention': [b] * 5}


def test_its_products_are_counted():
    """The reference's operations of one crop: Swin-T's published 4.5 G
    multiply-adds, and the heads."""
    with torch.device('meta'):
        reg = ref_models.MultiHeadRegressor(NAME)
        total, first = yardstick.forward_flops(
            reg, torch.empty(1, 224, 224, 3))
    assert 4.3e9 < total / 2 < 4.6e9
    assert first == 2 * 56 * 56 * 96 * 3 * 16


def test_the_k8_reader():
    read = common.load_metric('k8_roofline')
    trace = dict(kind='serve', bounds={'window_attention': [1e-3, 1e-3]},
                 events=[('window_attn_kernel', 0.0, 2000.0),
                         ('other', 2000.0, 9000.0),
                         ('void (anonymous namespace)::window_attn_kernel',
                          9000.0, 11000.0)])
    assert read(trace) == pytest.approx(50.0)
    assert read(dict(trace, events=[('other', 0.0, 1.0)])) is None
    assert read(dict(trace, bounds={})) is None
    assert read(dict(trace, kind='train')) is None


@pytest.mark.cuda
@pytest.mark.parametrize('fault', sorted(SWIN_FAULTS))
def test_the_faults_are_not_correct_on_the_card(capsys, monkeypatch, fault):
    """Each fault at the cell's own size, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    SWIN_FAULTS[fault](monkeypatch.setattr)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        assert run.main(['--workload', CELL, '--seed', str(seed),
                         '--seconds', '2']) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line)['correct'] is False
