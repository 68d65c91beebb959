"""The port's spans (``utils/profiling.py`` ``annotate``) on the CPU: the
serving engine's four stage spans, its graph path's ``serve.capture`` and
``serve.replay``, and the train step's five, present
under a profiler and absent without one, outputs unchanged by tracing,
and ``span_times``' attribution of device time to spans."""

import os.path as osp
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_common import REPO, one_cpu_thread
from torch_port_graph_stub import graph_on_cpu, stub_graphs  # noqa: F401

from tpudet3d_torch.core import AttrDict, read_py_config
from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.infer import Detector, EngineConfig, TwoStageEngine
from tpudet3d_torch.models import build_model
from tpudet3d_torch.train import create_train_state, make_train_step
from tpudet3d_torch.utils import profiling

SERVE = ['upload', 'detect', 'regress', 'readback']
TRAIN = ['augment', 'forward', 'backward', 'update', 'metrics']
CONFIG = osp.join(REPO, 'configs', 'scene_regressor_el0_ema.py')


def _frames(n=2, seed=3):
    return np.random.RandomState(seed).randint(0, 256, (n, 64, 96, 3)) \
        .astype(np.uint8)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


@pytest.fixture(scope='module')
def engine():
    torch.manual_seed(0)
    det = SSDDetector(num_classes=9, width_mult=0.25)
    reg = build_model(AttrDict(model=dict(name='mobilenetv3_small',
                                          num_classes=9, bf16=False)))
    cfg = EngineConfig(det_conf=0.0, max_detections=4, crop_size=(64, 64))
    return TwoStageEngine(det, reg, cfg, device='cpu')


def _train_parts(size=32):
    """A cut el0 + EMA config's state (MNv3-small, float32), its step with
    a flip as the augmentation, and a batch of 4."""
    cfg = read_py_config(CONFIG)
    cfg.model.update(name='mobilenetv3_small', bf16=False)
    state = create_train_state(cfg, device='cpu',
                               generator=torch.Generator().manual_seed(0))
    step = make_train_step(state.model, state.loss_manager, state.optimizer,
                           augment_fn=lambda i, k, g: (i.flip(2), k),
                           ema_decay=state.ema_decay)
    rng = np.random.RandomState(5)
    data = (torch.tensor(rng.standard_normal((4, size, size, 3)),
                         dtype=torch.float32),
            torch.tensor(rng.uniform(0.2, 0.8, (4, 9, 2)),
                         dtype=torch.float32),
            torch.tensor([0, 3, 5, 3]))
    return state, step, data


def _cpu_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def _spans(events, group):
    prefix = f'{profiling.SPAN_PREFIX}{group}.'
    return sorted((e for e in events if e.name.startswith(prefix)),
                  key=lambda e: e.time_range.start)


def _ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


@pytest.mark.parametrize('sharded', [False, True], ids=['one', 'sharded'])
def test_serving_spans_tile_infer_batch(engine, tmp_path, sharded):
    """Under ``trace`` an ``infer_batch`` call shows the four serving spans
    in order, as children of the caller's range, and every host operation
    of the call lies in one of them; the Chrome trace holds them.  Over two
    replicas each slice is uploaded, detected and regressed in turn, then
    read back once."""
    frames = _frames()
    engine.infer_batch(frames)
    if sharded:
        engine.shard(['cpu', 'cpu'])
    try:
        with profiling.trace(str(tmp_path)) as prof:
            with profiling.annotate('caller'):
                engine.infer_batch(frames)
    finally:
        engine.det_model = engine.det_model          # drops the replicas
    events = _cpu_events(prof)
    caller = next(e for e in events if e.name == 'caller')
    spans = _spans(events, 'serve')
    stages = SERVE[:3] * 2 + SERVE[3:] if sharded else SERVE
    assert [s.name for s in spans] == [f'tpudet3d_torch.serve.{s}'
                                       for s in stages]
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start
    assert all(s.cpu_parent is caller for s in spans)
    inside = [e for e in events if e.thread == caller.thread
              and e is not caller
              and caller.time_range.start <= e.time_range.start
              < caller.time_range.end]
    assert len(inside) > len(spans)
    for e in inside:
        assert e in spans or any(a in spans for a in _ancestors(e)), e.name
    chrome = (tmp_path / profiling.TRACE_FILE).read_text()
    assert all(f'tpudet3d_torch.serve.{s}' in chrome for s in SERVE)


def test_async_path_spans(engine):
    """``run_async`` / ``wait_and_grab`` go through the same stages."""
    frame = _frames(1)[0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.run_async(frame)
        engine.wait_and_grab()
    assert [s.name for s in _spans(_cpu_events(prof), 'serve')] == \
        [f'tpudet3d_torch.serve.{s}' for s in SERVE]


def test_graph_path_spans(engine, monkeypatch, stub_graphs):  # noqa: F811
    """On the graph path (its capture stood in for on the CPU) the first
    call of a key shows ``serve.upload``, ``serve.capture`` and
    ``serve.readback``, the warm-up's and the capture's ``serve.detect``
    and ``serve.regress`` inside ``serve.capture``; a replay shows
    ``serve.upload``, ``serve.replay`` and ``serve.readback``.  The spans
    tile each call under the caller's range.  Without a profiler none is
    made."""
    graphed = graph_on_cpu(TwoStageEngine(engine.det_model, engine.reg_model,
                                          engine.cfg, device='cpu'),
                           monkeypatch)
    made = []
    real = torch.profiler.record_function

    def spy(name, *args):
        made.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, 'record_function', spy)
    frames = _frames()
    graphed.infer_batch(frames)
    graphed.infer_batch(frames)
    assert made == [] and graphed.graph_stats['replays'] == 1
    graphed._graphs = {}
    for stages in (['upload', 'capture', 'readback'],
                   ['upload', 'replay', 'readback']):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.annotate('caller'):
                graphed.infer_batch(frames)
        events = _cpu_events(prof)
        caller = next(e for e in events if e.name == 'caller')
        spans = [s for s in _spans(events, 'serve')
                 if s.cpu_parent is caller]
        assert [s.name for s in spans] == [f'tpudet3d_torch.serve.{s}'
                                           for s in stages]
        inner = [s.name.rsplit('.', 1)[1] for s in _spans(events, 'serve')
                 if s not in spans]
        if stages[1] == 'capture':   # the stand-in's replay runs the path
            assert inner == ['detect', 'regress'] * 2
        assert all(any(a is spans[1] for a in _ancestors(s))
                   for s in _spans(events, 'serve') if s not in spans)
        for e in events:
            if e.thread == caller.thread and e is not caller and \
                    caller.time_range.start <= e.time_range.start \
                    < caller.time_range.end:
                assert e in spans or any(a in spans for a in _ancestors(e))
    assert graphed.graph_stats == {'captures': 2, 'replays': 2, 'eager': 0}


def test_train_step_spans():
    """A train step under a profiler shows its five spans in order, and the
    backward's operations lie in ``train.backward``."""
    state, step, batch = _train_parts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, *batch, torch.Generator().manual_seed(0))
    events = _cpu_events(prof)
    spans = _spans(events, 'train')
    assert [s.name for s in spans] == [f'tpudet3d_torch.train.{s}'
                                       for s in TRAIN]
    backward = spans[2]
    grads = [e for e in events if 'Backward' in e.name]
    assert grads and all(backward.time_range.start <= e.time_range.start
                         <= backward.time_range.end for e in grads)
    assert spans[3].time_range.start >= backward.time_range.end


def test_no_span_without_a_profiler(engine, monkeypatch):
    """With no profiler running no span is made (a spy on
    ``record_function`` sees none); under one it sees each stage."""
    made = []
    real = torch.profiler.record_function

    def spy(name, *args):
        made.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, 'record_function', spy)
    frames = _frames()
    state, step, batch = _train_parts()
    engine.infer_batch(frames)
    engine(frames[0])
    step(state, *batch, torch.Generator().manual_seed(0))
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.infer_batch(frames)
        step(state, *batch, torch.Generator().manual_seed(1))
    assert made == [f'tpudet3d_torch.serve.{s}' for s in SERVE] \
        + [f'tpudet3d_torch.train.{s}' for s in TRAIN]


def test_annotate_is_guarded():
    """Outside a profiler ``annotate`` hands out one shared no-op context
    whatever the name, and nothing is recorded; under one it records the
    named range, nested in the caller's."""
    assert profiling.annotate('a') is profiling.annotate('b')
    with profiling.annotate('a'):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.annotate('a') is not profiling.annotate('b')
        with profiling.annotate('outer'):
            with profiling.annotate('inner'):
                torch.ones(3).add_(1)
    events = {e.name: e for e in _cpu_events(prof)}
    assert events['inner'].cpu_parent is events['outer']
    assert 'a' not in events and 'b' not in events


def test_detector_wrapper_upload_span():
    """The stage-1 wrapper ``Detector`` uploads through the engine's
    ``upload``, so its frame's upload is the span ``serve.upload``."""
    torch.manual_seed(0)
    det = Detector(SSDDetector(num_classes=9, width_mult=0.25),
                   device='cpu')
    frame = _frames(1)[0]
    plain = det.get_detections(frame)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = det.get_detections(frame)
    assert [s.name for s in _spans(_cpu_events(prof), 'serve')] == \
        ['tpudet3d_torch.serve.upload']
    assert traced == plain


def test_outputs_unchanged_by_tracing(engine):
    """Served rows, and the train state after 2 steps, are bit for bit the
    same with a profiler running and without one."""
    frames = _frames(2, seed=7)
    plain = engine.infer_batch(frames)
    runs = []
    for traced in (False, True):
        state, step, batch = _train_parts()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) if traced \
            else None
        if prof is not None:
            prof.start()
        rows = engine.infer_batch(frames)
        metrics = [step(state, *batch, torch.Generator().manual_seed(i))[1]
                   for i in range(2)]
        if prof is not None:
            prof.stop()
        runs.append((rows, state, metrics))
    (_, a, ma), (rows, b, mb) = runs
    for r, p in zip(rows, plain):
        for k in p:
            np.testing.assert_array_equal(r[k], p[k])
    assert a.step == b.step == 2
    for x, y in zip(ma, mb):
        assert torch.equal(x, y)
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for n in a.ema_params:
        assert torch.equal(a.ema_params[n], b.ema_params[n]), n
    sa, sb = a.optimizer.state_dict()['state'], \
        b.optimizer.state_dict()['state']
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (i, k)


def _event(name, start, end, thread=1, kernels=(), annotation=False):
    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CPU, thread=thread,
        time_range=SimpleNamespace(start=start, end=end), is_async=False,
        is_user_annotation=annotation,
        kernels=[SimpleNamespace(name=k, duration=us) for k, us in kernels])


def test_span_times_attribution():
    """Each launch's device time goes to the innermost span open when the
    launching range started, on whichever thread; device-side annotation
    ranges and launches outside every span count for none, so the device
    ms of the spans never exceed the device's busy time."""
    p = profiling.SPAN_PREFIX
    events = [
        _event('perfbench.call', 0, 1000, kernels=[('k_outer', 7.0)],
               annotation=True),
        _event(p + 'a', 10, 100, kernels=[('k1', 5.0), (p + 'a', 80.0)],
               annotation=True),
        _event('aten::add', 20, 30, kernels=[('add', 3.0)]),
        _event('aten::copy_', 40, 50, kernels=[('memcpy', 2.0)]),
        _event(p + 'b', 100, 400, annotation=True),
        _event(p + 'inner', 150, 200, annotation=True),
        _event('aten::mul', 160, 170, kernels=[('mul', 4.0)]),
        # another thread (autograd's) inside b, after inner closed
        _event('aten::mm', 250, 260, thread=2, kernels=[('gemm', 11.0)]),
        _event('aten::sum', 500, 510, kernels=[('reduce', 6.0)]),
        _event(p + 'a', 600, 700, annotation=True),
        _event('aten::relu', 610, 620, kernels=[('relu', 1.5)]),
    ]
    prof = SimpleNamespace(events=lambda: events)
    out = profiling.span_times(prof)
    assert out[p + 'a'] == pytest.approx(
        {'calls': 2, 'host_ms': 0.19,
         'device_ms': (5.0 + 3.0 + 2.0 + 1.5) / 1e3})
    assert out[p + 'b']['device_ms'] == pytest.approx(11.0 / 1e3)
    assert out[p + 'inner']['device_ms'] == pytest.approx(4.0 / 1e3)
    assert set(out) == {p + 'a', p + 'b', p + 'inner'}
    busy = sum(k.duration for e in events for k in e.kernels
               if k.name != e.name) / 1e3
    assert sum(s['device_ms'] for s in out.values()) <= busy
    assert profiling.span_times(prof, prefix='nothing.') == {}


def test_span_times_of_a_cpu_profile(engine):
    """On the CPU the spans have host time and no device time."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.infer_batch(_frames())
    out = profiling.span_times(prof)
    assert sorted(out) == sorted(f'tpudet3d_torch.serve.{s}'
                                 for s in SERVE)
    for s in out.values():
        assert s['calls'] == 1 and s['host_ms'] > 0 and s['device_ms'] == 0
