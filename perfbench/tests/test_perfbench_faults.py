"""The harness's verdict against planted faults: each drives a whole run
of a cell on the CPU at a small size (the look for a card skipped), with
the timed path broken underneath, and ``correct`` must come out false.
The result line keeps to the contract's keys."""

import json

import pytest
import torch

import run
from harness import train as train_harness

SMALL = {'serve': dict(batch=2, height=72, width=128, pool=2,
                       calibration_frames=2),
         'train': dict(batch=4, size=64, pool=4, calibration_images=4),
         'train_dp': dict(ranks=4, batch=2, size=64, pool=4,
                          calibration_images=4, threads=1)}
SEED = 2 ** 31 + 11


# the data-parallel cell: its files are in place, and BENCHMARK.json takes
# these entries once its rate holds within the bound (PERF.md §7): the
# cell, the cell beside train.el0.b128 in every metric that lists it, and
# the process group's metric
DP4 = {'name': 'train.el0.dp4', 'config': 'el0',
       'traffic': 'train_dp_b128_224', 'chips': 4,
       'why': "cell 2's step on 4 cards over NCCL, 128 rows a card of a "
              "512-row batch: synchronised batch norm, the flat gradient "
              "all-reduce"}
DP_COMM = {'name': 'dp_comm_ms_per_step', 'unit': 'ms', 'better': 'lower',
           'source': 'device_trace', 'layer': 'process group',
           'moves': 'train_images_per_s', 'workloads': [DP4['name']]}


def load(name):
    """``run.load_cell``, with :data:`DP4`'s entries beside the listed
    ones."""
    if name != DP4['name']:
        return run.load_cell(name)
    bench, _, config, _ = run.load_cell('train.el0.b128')

    def beside(m):
        listed = m.get('workloads', [])
        return (dict(m, workloads=listed + [DP4['name']])
                if 'train.el0.b128' in listed else m)
    bench = dict(bench, workloads=bench['workloads'] + [DP4],
                 end_to_end=[beside(m) for m in bench['end_to_end']],
                 per_layer=[beside(m) for m in bench['per_layer']]
                 + [DP_COMM])
    with open(run.HERE / 'traffic' / f'{DP4["traffic"]}.json') as f:
        return bench, DP4, config, json.load(f)


def drive(capsys, name, control=None, trace=0):
    bench, cell, config, traffic = load(name)
    traffic = dict(traffic, **SMALL[traffic['kind']])
    torch.manual_seed(0)
    rc = run.run_cell(bench, cell, config, traffic, SEED, 0.2, trace,
                      control, 'cpu')
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(line)


def test_result_line_keys(capsys):
    out = drive(capsys, 'serve.mnv3l21k.b32')
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'checks']
    assert set(out['metrics']) == {'serve_fps', 'serve_p95_ms', 'setup_s'}
    assert set(out['device']) == {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    for c in out['checks'].values():
        assert set(c) == {'value', 'limit'}


def test_traced_line_keys(capsys):
    out = drive(capsys, 'train.el0.b128', trace=1)
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'breakdown', 'checks']
    assert {'busy_s', 'window_s'} <= set(out['device'])
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}


@pytest.mark.parametrize('name', ['serve.mnv3l21k.b32', 'serve.el0.b32',
                                  'train.el0.b128'])
def test_the_sound_path_is_correct(capsys, name):
    """At this size too, so that the faults below are what fails."""
    assert drive(capsys, name)['correct'] is True


def _epilogue_fault(monkeypatch, column, change):
    """K4's rows altered where they are produced: ``column`` of the first
    row of each call."""
    from tpudet3d_torch.infer import engine
    real = engine.head_epilogue

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        if kwargs.get('dets') is not None:
            out = out.clone()
            out[0, column] = change(out[0, column])
        return out
    monkeypatch.setattr(engine, 'head_epilogue', faulty)


@pytest.mark.parametrize('column, change', [
    (6, lambda v: v + 0.05),          # a keypoint moved by 5% of the crop
    (4, lambda v: v * 0.5),           # a detection's score halved
], ids=['keypoint', 'score'])
def test_an_altered_answer_is_not_correct(capsys, monkeypatch, column,
                                          change):
    _epilogue_fault(monkeypatch, column, change)
    assert drive(capsys, 'serve.mnv3l21k.b32')['correct'] is False


def plant_wrong_label(setattr):
    """The regressor's class one off where K4 takes its argmax: the logits
    rolled by one class, so K4 picks the next class and its head."""
    from tpudet3d_torch.infer import engine
    real = engine.head_epilogue

    def faulty(pre, logits, *args, **kwargs):
        if kwargs.get('dets') is not None:
            logits = logits.roll(1, dims=-1)
        return real(pre, logits, *args, **kwargs)
    setattr(engine, 'head_epilogue', faulty)


def plant_no_suppression(setattr):
    """K3 with its suppression switched off (no IoU passes 1)."""
    from tpudet3d_torch.infer import engine
    real = engine.decode_detections

    def faulty(*args, **kwargs):
        return real(*args, **dict(kwargs, iou_thr=1.0))
    setattr(engine, 'decode_detections', faulty)


def plant_reversed_ranking(setattr):
    """K3 returning the last ``max_per_img`` of its kept detections in
    score order, not the first."""
    from tpudet3d_torch.infer import engine
    real = engine.decode_detections

    def faulty(*args, **kwargs):
        m = kwargs['max_per_img']
        out = real(*args, **dict(kwargs, max_per_img=kwargs['pre_nms_k']))
        kept = (out[..., 4] > 0).sum(1)
        idx = (kept - m).clamp(min=0)[:, None] \
            + torch.arange(m, device=out.device)
        return torch.gather(out, 1, idx[..., None].expand(-1, -1, 6))
    setattr(engine, 'decode_detections', faulty)


def plant_no_crop_margin(setattr):
    """The crop boxes made without their margin, where the engine makes
    them from K3's detections."""
    from tpudet3d_torch.infer.engine import TwoStageEngine
    real = TwoStageEngine._crop_boxes

    def faulty(self, dets, h, w, margin):
        return real(self, dets, h, w, 0.0)
    setattr(TwoStageEngine, '_crop_boxes', faulty)


SERVE_FAULTS = {'wrong_label': plant_wrong_label,
                'no_suppression': plant_no_suppression,
                'reversed_ranking': plant_reversed_ranking,
                'no_crop_margin': plant_no_crop_margin}


@pytest.mark.parametrize('fault', sorted(SERVE_FAULTS))
@pytest.mark.parametrize('name', ['serve.mnv3l21k.b32', 'serve.el0.b32'])
def test_a_faulty_box_selection_or_label_is_not_correct(capsys, monkeypatch,
                                                    name, fault):
    SERVE_FAULTS[fault](monkeypatch.setattr)
    assert drive(capsys, name)['correct'] is False


def test_a_missing_answer_is_not_correct(capsys, monkeypatch):
    from tpudet3d_torch.infer.engine import TwoStageEngine
    real = TwoStageEngine.infer_batch

    def faulty(self, frames):
        out = real(self, frames)
        out[-1] = {k: v[:-1] for k, v in out[-1].items()}
        return out
    monkeypatch.setattr(TwoStageEngine, 'infer_batch', faulty)
    assert drive(capsys, 'serve.el0.b32')['correct'] is False


def _step_fault(monkeypatch, wrap):
    real = train_harness.build_state

    def build(cfg, sd, device):
        state, step = real(cfg, sd, device)
        return state, wrap(step)
    monkeypatch.setattr(train_harness, 'build_state', build)


def test_a_step_that_leaves_the_state_unchanged(capsys, monkeypatch):
    def wrap(step):
        def faulty(state, imgs, kp, cats, gen):
            saved = [t.detach().clone() for t in state.model.state_dict()
                     .values()]
            ema = {k: v.clone() for k, v in state.ema_params.items()}
            out = step(state, imgs, kp, cats, gen)
            with torch.no_grad():
                for t, s in zip(state.model.state_dict().values(), saved):
                    t.copy_(s)
                for k, v in ema.items():
                    state.ema_params[k].copy_(v)
            return out
        return faulty
    _step_fault(monkeypatch, wrap)
    out = drive(capsys, 'train.el0.b128')
    assert out['correct'] is False
    for name in ('update_gap', 'ema_gap', 'bn_stat_gap'):
        assert out['checks'][name]['value'] == pytest.approx(1.0)


def test_an_altered_update_is_not_correct(capsys, monkeypatch):
    """One leaf's update doubled where the step produces it."""
    def wrap(step):
        def faulty(state, imgs, kp, cats, gen):
            p = state.model.head_kernel
            before = p.detach().clone()
            out = step(state, imgs, kp, cats, gen)
            with torch.no_grad():
                p.add_(p - before)
            return out
        return faulty
    _step_fault(monkeypatch, wrap)
    assert drive(capsys, 'train.el0.b128')['correct'] is False


def half_batch(step):
    """The step over the first half of its rows alone."""
    def faulty(state, imgs, kp, cats, gen):
        h = imgs.shape[0] // 2
        return step(state, imgs[:h], kp[:h], cats[:h], gen)
    return faulty


def test_a_step_over_half_the_batch(capsys, monkeypatch):
    _step_fault(monkeypatch, half_batch)
    assert drive(capsys, 'train.el0.b128')['correct'] is False


def test_the_sound_data_parallel_path_is_correct(capsys):
    """Four gloo processes on the CPU: every rank holds the same state
    after the first three steps, and rank 0's agrees with the reference
    over the global rows; traced, rank 0's trace reaches the readers."""
    out = drive(capsys, 'train.el0.dp4', trace=1)
    assert out['correct'] is True
    assert out['checks']['rank_param_gap']['value'] == 0.0
    assert out['device']['count'] == 4 and out['device']['busy_s'] >= 0
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    assert 'train_mfu' in out['metrics']       # no device events on the CPU


def plant_no_exchange(rank, ranks):
    """The exchange between cards left out on the last rank: it takes part
    in the gradients' all-reduce with a copy and keeps its own gradient
    (so the collectives still pair up)."""
    if rank != ranks - 1:
        return
    from tpudet3d_torch.parallel import sharding
    real = sharding.all_reduce_mean

    def faulty(tensors):
        real([t.clone() for t in tensors])
        return tensors
    sharding.all_reduce_mean = faulty


def plant_half_batch(rank, ranks):
    """Every rank steps the first half of its rows alone."""
    real = train_harness.build_state

    def build(cfg, sd, device):
        state, step = real(cfg, sd, device)
        return state, half_batch(step)
    train_harness.build_state = build


@pytest.mark.parametrize('plant, number', [
    (plant_no_exchange, 'rank_param_gap'),
    (plant_half_batch, 'grad_gap_median')], ids=['no_exchange', 'half_batch'])
def test_a_faulty_data_parallel_step_is_not_correct(capsys, monkeypatch,
                                                    plant, number):
    """Planted in every rank's process before it builds its state."""
    from harness import train_dp
    monkeypatch.setattr(train_dp, 'PLANT', plant)
    out = drive(capsys, 'train.el0.dp4')
    assert out['correct'] is False
    assert out['checks'][number]['value'] > out['checks'][number]['limit']


@pytest.mark.parametrize('name, control', [
    ('serve.mnv3l21k.b32', 'fp8'), ('serve.el0.b32', 'fp8'),
    ('train.el0.b128', 'fp8'), ('train.el0.dp4', 'fp8')])
def test_the_control_is_not_correct(capsys, name, control):
    """The reference in float8, put in the program's place."""
    assert drive(capsys, name, control=control)['correct'] is False


@pytest.mark.cuda
@pytest.mark.parametrize('name, control', [
    ('serve.mnv3l21k.b32', 'fp8'), ('serve.el0.b32', 'fp8'),
    ('train.el0.b128', 'fp8')])
def test_the_control_is_not_correct_on_the_card(capsys, name, control):
    """The control at the cell's own size, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    for seed in (101, 102, 103):
        assert run.main(['--workload', name, '--seed', str(seed),
                         '--seconds', '2', '--control', control]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line)['correct'] is False
