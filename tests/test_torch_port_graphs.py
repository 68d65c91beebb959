"""CUDA-graph replay of the serving engine's ``infer_batch``
(``infer/engine.py``).

On the CPU the graph cache runs with a stand-in capturer
(``torch_port_graph_stub.py``): one capture per key and replays after it,
a new key for each thing the graph fixes, first-in-first-out eviction,
the graphs dropped by assigning what they read, the kernel wrappers'
launch counts under replay, and the paths that stay eager.  On the card
(``-m cuda``, skipped elsewhere) the graphed rows are held bit for bit to
the eager path's for both builds, in bf16 and int8.  This file imports no
JAX, so on the machine with the card it runs without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_graphs.py
"""

import copy
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

import tpudet3d_torch.infer.engine as engine_mod
from tpudet3d_torch.core import AttrDict
from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.infer import EngineConfig, TwoStageEngine, quant
from tpudet3d_torch.models import build_model
from tpudet3d_torch.ops import resize_bilinear
from torch_port_graph_stub import graph_on_cpu, stub_graphs  # noqa: F401

FIELDS = ('boxes', 'scores', 'det_labels', 'kp', 'labels')


def _frames(n=2, h=64, w=96, seed=3):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)) \
        .astype(np.uint8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def models():
    torch.manual_seed(0)
    det = SSDDetector(num_classes=9, width_mult=0.25)
    reg = build_model(AttrDict(model=dict(name='mobilenetv3_small',
                                          num_classes=9, bf16=False)))
    return det, reg


def _engine(models, **cfg):
    cfg = dict(dict(det_conf=0.0, max_detections=4, crop_size=(64, 64)),
               **cfg)
    return TwoStageEngine(*models, EngineConfig(**cfg), device='cpu')


@pytest.fixture
def engine(models, monkeypatch, stub_graphs):  # noqa: F811
    """A CPU engine on the graph path, graphs captured by the stub."""
    return graph_on_cpu(_engine(models), monkeypatch)


def _eager(engine, frames):
    h, w = frames.shape[1:3]
    return engine._readback([engine._pipeline_batch(
        engine._upload(frames), h, w)])


def _assert_same(a, b):
    assert len(a) == len(b)
    for r, q in zip(a, b):
        for k in FIELDS:
            np.testing.assert_array_equal(r[k], q[k])


def test_one_capture_per_key_then_replays(engine, stub_graphs):  # noqa: F811
    """The first call of a key captures, every later one replays; each
    replay reads the frames of its own call, and answers as the eager
    path does."""
    batches = [_frames(seed=s) for s in (3, 4, 5)]
    for i, frames in enumerate(batches + batches):
        _assert_same(engine.infer_batch(frames), _eager(engine, frames))
        assert engine.graph_stats == {'captures': 1, 'replays': i,
                                      'eager': 0}
    assert len(stub_graphs) == 1 and stub_graphs[0].replays == 5
    a, b = (engine.infer_batch(f) for f in batches[:2])
    assert not np.array_equal(a[0]['kp'], b[0]['kp'])


def _change(engine, what):
    """Change one thing a graph fixes; returns the frames to serve."""
    frames = _frames()
    if what == 'batch':
        return _frames(n=3)
    if what == 'frame size':
        return _frames(h=72, w=80)
    cfg = engine.cfg
    if what == 'margin':
        cfg.crop_margin_px = 4.0
    elif what == 'refine margin':
        cfg.refine_passes, cfg.refine_margin_px = 1, 10.0
        engine.infer_batch(frames)
        cfg.refine_margin_px = 3.0
    elif what == 'int8 scales':
        cfg.det_int8_scales, cfg.reg_int8_scales = \
            quant.calibrate_engine(engine, list(frames))
    elif what == 'int8 scale in place':
        cfg.reg_int8_scales = quant.calibrate_engine(engine,
                                                     list(frames))[1]
        engine.infer_batch(frames)
        path = next(iter(cfg.reg_int8_scales))
        cfg.reg_int8_scales[path] *= 2
    elif what == 'int8 weights reloaded':
        engine.reg_model = copy.deepcopy(engine.reg_model)
        cfg.reg_int8_scales = quant.calibrate_engine(engine,
                                                     list(frames))[1]
        engine.infer_batch(frames)
        sd = engine.reg_model.state_dict()
        engine.reg_model.load_state_dict(
            {k: v + 0.05 if k.endswith('Conv_0.weight') else v
             for k, v in sd.items()})
    elif what == 'cfg assigned':
        engine.cfg = dataclasses.replace(cfg, crop_margin_px=4.0)
    elif what == 'cudnn':
        torch.backends.cudnn.deterministic = \
            not torch.backends.cudnn.deterministic
    return frames


@pytest.mark.parametrize('what', ['batch', 'frame size', 'margin',
                                  'refine margin', 'int8 scales',
                                  'int8 scale in place',
                                  'int8 weights reloaded', 'cfg assigned',
                                  'cudnn'])
def test_new_key(engine, what):
    """Each thing a graph fixes makes a new key: the changed call captures
    a graph of its own, answering as the eager path does, and the old key
    still replays its graph when its call comes back."""
    frames = _frames()
    engine.infer_batch(frames)
    before = engine.graph_stats['captures']
    deterministic = torch.backends.cudnn.deterministic
    try:
        changed = _change(engine, what)
        caught = engine.graph_stats['captures']
        out = engine.infer_batch(changed)
        assert engine.graph_stats['captures'] == caught + 1 > before
        _assert_same(out, _eager(engine, changed))
        replays = engine.graph_stats['replays']
        engine.infer_batch(changed)
        assert engine.graph_stats['replays'] == replays + 1
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if what in ('batch', 'frame size', 'cudnn'):
        engine.infer_batch(frames)
        assert engine.graph_stats['replays'] == replays + 2
        assert engine.graph_stats['captures'] == caught + 1


def test_int8_graph_holds_its_weights(engine):
    """A graph served int8 holds the int8 weights it reads, one a
    calibrated conv, so a later calibration cannot free them."""
    frames = _frames()
    det_s, reg_s = quant.calibrate_engine(engine, list(frames))
    engine.cfg.det_int8_scales, engine.cfg.reg_int8_scales = det_s, reg_s
    engine.infer_batch(frames)
    (g,) = engine._graphs.values()
    n = len(quant.int8_weights(engine.det_model, det_s)) \
        + len(quant.int8_weights(engine.reg_model, reg_s))
    assert 0 < len(g.held) == n
    assert len(quant.int8_weights(engine.det_model, None)) == 0


def test_fifo_eviction(engine, monkeypatch):
    """At most 16 graphs: a 17th key evicts the oldest, which captures
    again when its call comes back."""
    monkeypatch.setattr(engine, '_pipeline_core', lambda f, h, w, m, r:
                        f.float().mean((1, 2, 3))[:, None, None]
                        .expand(-1, 4, 26).contiguous())
    shapes = [(n, 8, 8) for n in range(1, 18)]
    for n, h, w in shapes:
        engine.infer_batch(_frames(n, h, w))
    assert engine_mod.MAX_GRAPHS == 16
    assert len(engine._graphs) == 16
    assert [k[0][0] for k in engine._graphs] == list(range(2, 18))
    engine.infer_batch(_frames(2, 8, 8))
    assert engine.graph_stats['captures'] == 17
    engine.infer_batch(_frames(1, 8, 8))
    assert engine.graph_stats['captures'] == 18
    assert [k[0][0] for k in engine._graphs] == list(range(3, 18)) + [1]


@pytest.mark.parametrize('attr', ['det_model', 'reg_model', 'anchors'])
def test_assignment_drops_graphs(engine, attr):
    """Assigning what a graph reads where it lay (the models, the
    anchors) drops every graph: the next call captures again."""
    engine.infer_batch(_frames())
    engine.infer_batch(_frames(n=3))
    assert len(engine._graphs) == 2
    setattr(engine, attr, getattr(engine, attr))
    assert engine._graphs == {}
    engine.infer_batch(_frames())
    assert engine.graph_stats['captures'] == 3


def test_replaced_model_answers_with_its_weights(engine, models):
    """After ``reg_model`` is replaced the engine captures again and
    answers with the new weights."""
    frames = _frames()
    old = engine.infer_batch(frames)
    reg = copy.deepcopy(models[1])
    with torch.no_grad():
        for p in reg.parameters():
            p.add_(0.05)
    engine.reg_model = reg
    new = engine.infer_batch(frames)
    assert engine.graph_stats['captures'] == 2
    _assert_same(new, _eager(engine, frames))
    assert not np.array_equal(new[0]['kp'], old[0]['kp'])


def test_replay_counts_the_graphs_launches(engine, monkeypatch):
    """The kernel wrappers count what is launched from Python, a capture's
    launches too; a replay calls no wrapper, so only a device trace counts
    the graph's launches there."""
    real = engine_mod.capture_graph

    def capture(fn, device):
        resize_bilinear.launches += 1       # as K1's launch in a capture
        return real(fn, device)
    monkeypatch.setattr(engine_mod, 'capture_graph', capture)
    frames = _frames()
    start = resize_bilinear.launches
    engine.infer_batch(frames)
    assert resize_bilinear.launches == start + 1   # the CPU launches none
    engine.infer_batch(frames)
    engine.infer_batch(frames)
    assert resize_bilinear.launches == start + 1
    assert engine.graph_stats['replays'] == 2


def test_eager_paths(models, monkeypatch, stub_graphs):  # noqa: F811
    """A CPU engine stays eager, ``graph_stats['eager']`` counting its
    calls, with the eager path's outputs; so do ``shard``, ``__call__``
    and ``run_async`` on an engine that otherwise replays."""
    frames = _frames()
    cpu = _engine(models)
    assert not cpu._graphed()
    for i in range(2):
        _assert_same(cpu.infer_batch(frames), _eager(cpu, frames))
    assert cpu.graph_stats == {'captures': 0, 'replays': 0, 'eager': 2}
    engine = graph_on_cpu(_engine(models), monkeypatch)
    single, pending = engine(frames[0]), engine.run_async(frames[1])
    _assert_same([single, engine.wait_and_grab()],
                 [cpu(frames[0]), cpu(frames[1])])
    assert engine.graph_stats == {'captures': 0, 'replays': 0, 'eager': 0}
    assert pending is None and not stub_graphs
    engine.shard(['cpu'])
    _assert_same(engine.infer_batch(frames), _eager(cpu, frames))
    assert engine.graph_stats == {'captures': 0, 'replays': 0, 'eager': 1}


def test_graph_path_is_an_unsharded_card(models):
    """What decides the path is the engine's device and its replicas."""
    engine = _engine(models)
    assert not engine._graphed()
    engine.device = torch.device('cuda')
    assert engine._graphed()
    engine._replicas = [(engine, None)]
    assert not engine._graphed()


# --- on the card -----------------------------------------------------------

EL0_CONFIG = 'configs/scene_regressor_el0_ema.py'


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda')


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms, so that two runs of the path can
    be held bit for bit (the engine keys its graphs on the switch)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def _card_engine(build, card, **cfg):
    from tpudet3d_torch.core import read_py_config
    from tpudet3d_torch.infer import build_detector, build_engine
    if build == 'mnv3':
        return build_engine(det_conf=0.0, device=card, **cfg)
    gen = torch.Generator().manual_seed(6)
    det = build_detector(cascade=True, generator=gen)
    reg = build_model(read_py_config(EL0_CONFIG), generator=gen)
    return TwoStageEngine(det, reg, EngineConfig(det_conf=0.0,
                                                 crop_margin_px=10.0, **cfg),
                          device=card)


def _packed_eager(engine, frames):
    h, w = frames.shape[1:3]
    return engine._pipeline_batch(engine._upload(frames), h, w)


def _graphed_packed(engine, frames):
    """The static output of the key's graph after ``infer_batch``."""
    engine.infer_batch(frames)
    (g,) = [g for k, g in engine._graphs.items()
            if k[0] == frames.shape]
    return g.static_out


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['bf16', 'int8', 'refine_tta'])
@pytest.mark.parametrize('build', ['mnv3', 'el0'])
def test_graphed_rows_equal_eager_on_card(card, deterministic, build,
                                          precision):
    """``infer_batch``'s rows, on the capture (the warm-up's answer) and on
    each replay, are bit for bit the eager ``_pipeline_batch``'s on the
    same uploaded frames; in bf16, with ``calibrate_engine``'s int8 scales,
    and with a refine pass and the flip TTA."""
    extra = dict(refine_passes=1, tta_flip=True) \
        if precision == 'refine_tta' else {}
    engine = _card_engine(build, card, **extra)
    frames = _frames(8, 720, 1280, seed=0)
    if precision == 'int8':
        quant.serve_int8(engine, list(frames))
        assert engine.cfg.reg_int8_scales
    eager = _packed_eager(engine, frames)
    first = engine.infer_batch(frames)
    _assert_same(first, engine._readback([eager]))
    for _ in range(2):
        assert torch.equal(_graphed_packed(engine, frames), eager)
    assert engine.graph_stats == {'captures': 1, 'replays': 2, 'eager': 0}
    _assert_same(engine.infer_batch(frames), first)


@pytest.mark.cuda
def test_replays_refresh_the_input_on_card(card, deterministic):
    """Four batches replayed in turn give four answers, each the eager
    path's; two shapes alternated stay exact."""
    engine = _card_engine('mnv3', card)
    batches = [_frames(8, 720, 1280, seed=s) for s in range(4)] \
        + [_frames(4, 480, 640, seed=9)]
    eager = [_packed_eager(engine, f) for f in batches]
    for f in batches:
        engine.infer_batch(f)
    outs = []
    for _ in range(2):
        for f, e in zip(batches, eager):
            out = _graphed_packed(engine, f).clone()
            assert torch.equal(out, e)
            outs.append(out)
    assert engine.graph_stats['captures'] == 2
    assert engine.graph_stats['replays'] == 13
    for a, b in zip(outs[:3], outs[1:4]):
        assert not torch.equal(a, b)


@pytest.mark.cuda
def test_replaced_regressor_recaptures_on_card(card, deterministic):
    """After ``reg_model`` is replaced the engine captures again and its
    replays answer with the new weights."""
    engine = _card_engine('mnv3', card)
    frames = _frames(8, 720, 1280, seed=0)
    engine.infer_batch(frames)
    old = _graphed_packed(engine, frames).clone()
    reg = copy.deepcopy(engine.reg_model)
    with torch.no_grad():
        for p in reg.parameters():
            p.mul_(1.01)
    engine.reg_model = reg
    engine.infer_batch(frames)
    new = _graphed_packed(engine, frames)
    assert engine.graph_stats['captures'] == 2
    assert torch.equal(new, _packed_eager(engine, frames))
    assert not torch.equal(new, old)


@pytest.mark.cuda
def test_replayed_kernels_in_a_device_trace_on_card(card):
    """Under a profile of the card's activity alone a replay shows each
    kernel of the path under its own name, the eager path's kernels and
    fills one for one, K1 and K2 among them.  The tracer can lose a
    session's first events while it starts, so each session traces a
    warm-up call and throws it away (the profiler's schedule), as
    ``utils/profiling.py`` ``traced_launches`` does."""
    from torch.profiler import ProfilerActivity, profile, schedule
    engine = _card_engine('mnv3', card)
    frames = _frames(8, 720, 1280, seed=0)
    up = engine._upload(frames)
    for _ in range(2):
        engine.infer_batch(frames)
    h, w = frames.shape[1:3]
    names = {}
    for what, call in (('eager', lambda: engine._readback(
                           [engine._pipeline_batch(up, h, w)])),
                       ('replay', lambda: engine.infer_batch(frames))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                call()
                torch.cuda.synchronize()
                prof.step()
        names[what] = sorted(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False))
    assert any('resize_tiled_u8_kernel' in n for n in names['replay'])
    assert any('crop_band_kernel' in n for n in names['replay'])
    # the copies differ (the replay uploads, the eager call reads
    # uploaded frames); a fill is "Memset (Device)" eagerly and the
    # kernel "memset32" in a graph
    eager, replay = (Counter('memset' if 'emset' in n else n for n in v
                             if 'emcpy' not in n) for v in names.values())
    assert eager == replay, (eager - replay, replay - eager)
