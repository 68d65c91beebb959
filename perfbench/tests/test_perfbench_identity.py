"""What the benchmark reads for its three first cells stays what it read
before a configuration could bring its own backbone: the drawn weights,
the operations a call or step counts, K1's and K2's bounds and the judged
numbers of a small run on the CPU, each equal to the values recorded from
the commit before that change (on this CPU: the judged numbers carry its
rounding)."""

import hashlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import run
from harness import serve, train, weights
from reference import models as ref_models

SEED = 2 ** 31 + 11

# sha256 of the state_dict drawn by ``weights.draw`` (detector from seed
# 123, regressor from seed 456), by configuration
DRAWN = {
    'mnv3l21k': ('a159d28078aa550ef83a718e983c8faf'
                 '00d742a8a295be93e3e928dff1c55dd8',
                 'd3cf301757a7ddca85e6e3ae97d5518b'
                 '847ba1723493ed447b5b93b50dfc88eb'),
    'el0': ('b51522b999cad846b350cffcd5617221'
            '065173a7a9fd431388add2066de359d6',
            '7a5ffc267c57b4f7666a394711cc678a'
            '5ce3e1aa687c43d20a9fbfdf14f715aa'),
}

# flops_per_unit of the traced call or step at the cell's own sizes; K1's
# bound and K2's over five calls of a fake engine's boxes
COUNTS = {
    'serve.mnv3l21k.b32': dict(
        flops=144142298112, k1=3.156823880597015e-05,
        k2=[3.133178179104478e-05, 3.1396412537313435e-05,
            3.17651447761194e-05, 3.075592328358209e-05,
            3.133178179104478e-05]),
    'serve.el0.b32': dict(
        flops=230587401216, k1=3.156823880597015e-05,
        k2=[3.133178179104478e-05, 3.1396412537313435e-05,
            3.17651447761194e-05, 3.075592328358209e-05,
            3.133178179104478e-05]),
    'train.el0.b128': dict(flops=292234567680),
}

# the numbers judged in a run at the small sizes of the fault tests
NUMBERS = {
    'serve.mnv3l21k.b32': {
        'det_box_gap_px': 0.03560638427734375,
        'det_score_gap': 0.0008672922849655151,
        'distinct_answers_judged': 2,
        'kp_gap': 0.0001779794692993164,
        'label_logit_gap': 0.0,
        'nms_missed_score': 0.00040534138679504395,
        'nms_overlap': 0.44921186764347404,
        'rows_missing': 0.0,
    },
    'serve.el0.b32': {
        'det_box_gap_px': 0.0956878662109375,
        'det_score_gap': 0.0007466822862625122,
        'distinct_answers_judged': 2,
        'kp_gap': 0.0005875825881958008,
        'label_logit_gap': 0.0,
        'nms_missed_score': 1.7002224922180176e-05,
        'nms_overlap': 0.43732915478733425,
        'rows_missing': 0.0,
    },
    'train.el0.b128': {
        'bn_stat_gap': 0.030846513192978098,
        'bn_stat_gap_leaf':
            'backbone.blocks_12.ConvBN_1.BatchNorm_0.running_mean',
        'bn_stat_gap_median': 0.001402210280078466,
        'ema_gap': 0.041128438436496245,
        'ema_gap_leaf': 'backbone.blocks_1.ConvBN_0.Conv_0.weight',
        'ema_gap_median': 0.007059517461031201,
        'grad_gap': 0.571476901571975,
        'grad_gap_leaf': 'backbone.blocks_2.ConvBN_0.BatchNorm_0.bias',
        'grad_gap_median': 0.03506315951159954,
        'leaves': 151,
        'leaves_compared': 135,
        'loss_gap': 0.059395910871455224,
        'loss_gap_first': 0.015409826851703666,
        'update_gap': 0.05668627154293436,
        'update_gap_leaf': 'backbone.blocks_2.ConvBN_2.BatchNorm_0.weight',
        'update_gap_median': 0.008821955751669582,
    },
}
SMALL = {'serve': dict(batch=2, height=72, width=128, pool=2,
                       calibration_frames=2),
         'train': dict(batch=4, size=64, pool=4, calibration_images=4)}


def digest(model):
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize('config', sorted(DRAWN))
def test_the_drawn_weights(config):
    cfg = run.load_cell(f'serve.{config}.b32')[2]
    det = ref_models.SSDDetector(cfg['detector']['num_classes'],
                                 cfg['detector']['width_mult'],
                                 cfg['detector']['cascade'])
    reg = ref_models.MultiHeadRegressor(cfg['regressor']['backbone'],
                                        cfg['regressor']['num_classes'])
    weights.draw(det, 123, 'cpu')
    weights.draw(reg, 456, 'cpu')
    assert (digest(det), digest(reg)) == DRAWN[config]


class FakeEngine:
    """``infer_batch`` answering seeded boxes, for the bounds alone."""

    def __init__(self, rows, h, w):
        self.rng = np.random.default_rng(7)
        self.rows, self.h, self.w = rows, h, w

    def infer_batch(self, frames):
        out = []
        for _ in range(len(frames)):
            x0 = self.rng.uniform(0, self.w / 2, self.rows)
            y0 = self.rng.uniform(0, self.h / 2, self.rows)
            bw = self.rng.uniform(8, self.w / 2, self.rows)
            bh = self.rng.uniform(8, self.h / 2, self.rows)
            boxes = np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)
            out.append(dict(boxes=boxes, scores=np.ones(self.rows),
                            det_labels=np.zeros(self.rows),
                            kp=np.zeros((self.rows, 9, 2)),
                            labels=np.zeros(self.rows)))
        return out


@pytest.mark.parametrize('name', sorted(COUNTS))
def test_the_counts_and_bounds(name):
    _, _, cfg, tr = run.load_cell(name)
    if tr['kind'] == 'serve':
        engine = FakeEngine(cfg['serve']['max_detections'], tr['height'],
                            tr['width'])
        pool = [np.zeros((tr['batch'], 1, 1, 3), np.uint8)] * tr['pool']
        t = serve.traced(engine, pool, [[] for _ in pool], cfg, tr, 7, 1.0,
                         5, 'cpu')
        got = dict(flops=t['flops_per_unit'], k1=t['k1_bound_s'],
                   k2=t['k2_bound_s'])
    else:
        pool = [(None, None, None)] * tr['pool']
        t = train.traced(lambda *a: None, None, pool, None, 3, cfg, tr, 1.0,
                         4, 5, 'cpu')
        got = dict(flops=t['flops_per_unit'])
    assert got == COUNTS[name]
    assert t['bounds'] == {}


@pytest.mark.parametrize('name', sorted(NUMBERS))
def test_the_judged_numbers(name):
    _, _, cfg, tr = run.load_cell(name)
    torch.manual_seed(0)
    ctx = SimpleNamespace(seed=SEED, seconds=0.2, trace=False, control=None,
                          cfg=cfg, traffic=dict(tr, **SMALL[tr['kind']]),
                          device='cpu', t0=time.perf_counter(),
                          trace_calls=5)
    assert run.driver(tr['kind'])(ctx)['numbers'] == NUMBERS[name]
