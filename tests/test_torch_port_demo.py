"""The port's split-inference ``Detector``, tracker and demo loop against
the JAX package (CPU).

- Tracker: both trackers get the same seeded detection sequences (objects
  entering and leaving, gaps within and beyond the continue threshold,
  two objects crossing, keypoint jumps and swapped vertices), with
  ``align_kp`` on and off, through the native LAPJV solver and through
  scipy.  The tracked objects must be identical at every frame (host
  numpy: exact).
- ``Detector``: against the JAX ``Detector`` at float32 with the scaled
  class heads of tests/test_torch_port_engine.py, under that file's
  tolerances: boxes 1e-2 px, scores 1e-5, labels exact, on the rows with
  score > 0.  The decoded lists (ints) agree within 1 px, and ``_decode``
  on the same rows exactly.
- Demo loop: ``tools/demo.py`` ``run`` over 8 frames gives the tracked
  objects of the engine and tracker driven by hand in the same pipelined
  order (exact: the same CPU computation).  Against ``scripts/demo.py``'s
  ``run``, both driven by one stand-in engine that serves seeded
  detections in the order it is asked: the same dispatch-then-wait order
  and the same tracked objects at every frame (exact), except that the
  port also yields the last frame, which the JAX loop leaves in flight.
"""

import os
import subprocess
import sys
import textwrap
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpudet3d.native as jax_native
from tpudet3d.infer.tracker import IOUTracker as JaxTracker
from tpudet3d.infer.tracker import IOUTrackerConfig as JaxTrackerConfig
from tpudet3d.infer.wrappers import Detector as JaxDetector
from tpudet3d.utils.drawing import draw_kp as jax_draw_kp

import tpudet3d_torch.native as native
from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.infer import (Detector, EngineConfig, IOUTracker,
                                  IOUTrackerConfig, TwoStageEngine)
from tpudet3d_torch.models import build_model
from tpudet3d_torch.core import AttrDict
from tpudet3d_torch.tools import demo
from tpudet3d_torch.utils.drawing import draw_kp
from tpudet3d_torch.tools.cases import moving_frames
from test_torch_port_engine import weights  # noqa: F401  (fixture)
from torch_port_common import REPO, one_cpu_thread, port_of, set_no_tf32


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


# --- the tracker ---------------------------------------------------------

def detection_sequence(seed, n_frames=48):
    """Per frame: (boxes as int tuples, flat 18-keypoint arrays), in a
    shuffled order.  Six objects with their own lifetimes and velocities;
    objects 0 and 1 cross; object 2 has a gap of 3 frames (within the
    continue threshold) and object 3 one of 8 (beyond it); keypoints drift
    with noise, jump now and then past the ADD threshold and sometimes
    swap two vertices."""
    rng = np.random.RandomState(seed)
    objs = []
    for i in range(6):
        start = 0 if i < 3 else rng.randint(1, 15)
        end = n_frames if i < 2 else rng.randint(30, n_frames + 1)
        pos = rng.uniform(50, 500, 2)
        vel = rng.uniform(-4, 4, 2)
        if i < 2:                       # two objects crossing head-on
            pos = np.array([100.0 + 400 * i, 200.0])
            vel = np.array([8.0 - 16 * i, 0.0])
        size = rng.uniform(60, 140, 2)
        kp = rng.uniform(0.1, 0.9, (9, 2))
        objs.append(dict(start=start, end=end, pos=pos, vel=vel, size=size,
                         kp=kp))
    gaps = {2: set(range(12, 15)), 3: set(range(20, 28))}
    seq = []
    for t in range(n_frames):
        dets, kps = [], []
        for i, o in enumerate(objs):
            if not o['start'] <= t < o['end'] or t in gaps.get(i, ()):
                continue
            c = o['pos'] + o['vel'] * (t - o['start'])
            box = np.r_[c - o['size'] / 2, c + o['size'] / 2]
            box += rng.normal(0, 1.5, 4)
            kp = o['kp'] + rng.normal(0, 0.01, (9, 2))
            u = rng.uniform()
            if u < 0.1:
                kp = kp + rng.normal(0, 0.2, (9, 2))        # a jump
            elif u < 0.2:
                a, b = rng.choice(np.arange(1, 9), 2, replace=False)
                kp[[a, b]] = kp[[b, a]]                     # swapped vertices
            dets.append(tuple(int(v) for v in box))
            kps.append(kp.reshape(-1))
        order = rng.permutation(len(dets))
        seq.append(([dets[j] for j in order], [kps[j] for j in order]))
    return seq


@pytest.fixture(params=['native', 'scipy'])
def assignment_route(request, monkeypatch):
    if request.param == 'scipy':
        monkeypatch.setattr(native, '_lib', False)
        monkeypatch.setattr(jax_native, '_lib', False)
    assert native.native_available() == jax_native.native_available() \
        == (request.param == 'native')
    return request.param


def test_tracker_defaults_match():
    assert asdict(IOUTrackerConfig()) == asdict(JaxTrackerConfig())


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('align_kp', [False, True], ids=['plain', 'align'])
def test_tracker_matches_jax(assignment_route, align_kp, seed):
    kw = asdict(IOUTrackerConfig())
    kw['align_kp'] = align_kp
    port, ref = IOUTracker(**kw), JaxTracker(**kw)
    n_labelled = 0
    for dets, kps in detection_sequence(seed):
        port.process(None, dets, kps)
        ref.process(None, dets, kps)
        out, want = port.get_tracked_objects(), ref.get_tracked_objects()
        assert out == want
        n_labelled += sum(o.label != 'ID -1' for o in out)
    assert n_labelled > 20          # tracks lived past the time window
    assert [t.id for t in port.get_tracks()] == \
        [t.id for t in ref.get_tracks()]


def test_native_matches_scipy_route():
    rng = np.random.RandomState(3)
    det, trk = (np.concatenate([xy, xy + rng.uniform(5, 60, xy.shape)], 1)
                for xy in (rng.uniform(0, 100, (7, 2)),
                           rng.uniform(0, 100, (5, 2))))
    assert native.native_available()
    cost = native.giou_cost_matrix(det, trk)
    rows, cols = native.linear_assignment(cost)
    np.testing.assert_array_equal(cost, jax_native.giou_cost_matrix(det,
                                                                     trk))
    lib, native._lib = native._lib, False
    try:
        np.testing.assert_allclose(native.giou_cost_matrix(det, trk), cost,
                                   rtol=0, atol=1e-12)
        rows_s, cols_s = native.linear_assignment(cost)
    finally:
        native._lib = lib
    assert cost[rows, cols].sum() == pytest.approx(cost[rows_s, cols_s].sum())
    assert native._lib_path().startswith(os.path.join(
        REPO, 'tpudet3d_torch', 'kernels', '_build'))


# --- the Detector wrapper ------------------------------------------------

@pytest.mark.parametrize('expand', [(1.0, 1.0), (1.2, 1.1)],
                         ids=['expand1', 'expand1.2'])
def test_detector_matches_jax(weights, expand):  # noqa: F811
    det, dv, _, _ = weights
    frame = np.random.RandomState(21).randint(0, 256, (360, 640, 3)) \
        .astype(np.uint8)
    kw = dict(conf=0.5, max_detections=8, expand_ratio=expand)
    ref = JaxDetector(det, jax.tree_util.tree_map(jnp.asarray, dv), **kw)
    port = Detector(port_of(SSDDetector(num_classes=9, width_mult=0.25), dv),
                    device='cpu', **kw)
    ref.run_async(frame)
    port.run_async(frame)
    want = np.asarray(jax.device_get(ref._pending))
    got = port._pending.numpy()
    keep = want[:, 4] > 0
    assert keep.sum() >= 4
    s = np.sort(want[keep, 4])
    assert np.all(np.diff(s) > 1e-3), s         # no near-ties to reorder
    np.testing.assert_array_equal(got[:, 4] > 0, keep)
    np.testing.assert_allclose(got[keep, 4], want[keep, 4], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[keep, :4], want[keep, :4], rtol=0,
                               atol=1e-2)
    np.testing.assert_array_equal(got[keep, 5], want[keep, 5])
    out, ref_out = port.wait_and_grab(), ref.wait_and_grab()
    assert len(out) == len(ref_out) > 0
    for o, r in zip(out, ref_out):
        assert np.all(np.abs(np.subtract(o[:4], r[:4])) <= 1)
        assert abs(o[4] - r[4]) <= 1e-5 and o[5] == r[5]
    assert port._decode(want, frame.shape) == ref._decode(want, frame.shape)
    with pytest.raises(RuntimeError):
        port.wait_and_grab()
    assert port.get_detections(frame) == out


# --- the demo loop -------------------------------------------------------

def _port_engine(weights):  # noqa: F811
    _, dv, _, rv = weights
    return TwoStageEngine(
        port_of(SSDDetector(num_classes=9, width_mult=0.25), dv),
        port_of(build_model(AttrDict(model=dict(
            name='mobilenetv3_large_21k', num_classes=9, bf16=False))), rv),
        EngineConfig(det_conf=0.0, max_detections=4, crop_size=(64, 64)),
        device='cpu')


@pytest.mark.parametrize('max_frames', [0, 5])
def test_demo_loop_matches_hand_pipeline(weights, max_frames):  # noqa: F811
    frames = moving_frames(8, (240, 320, 3))
    engine, tracker = _port_engine(weights), IOUTracker(time_window=2)
    stats = {}
    got = [(r, objs) for _, r, objs in demo.run(
        iter(frames), engine, tracker, max_frames=max_frames, stats=stats)]
    n = max_frames or len(frames)
    assert len(got) == n and stats['frames'] == n and stats['seconds'] > 0
    assert not engine._pending

    ref_engine, ref_tracker = _port_engine(weights), IOUTracker(
        time_window=2)
    ref_engine.run_async(frames[0])
    want = []
    for i in range(n):
        if i + 1 < n:
            ref_engine.run_async(frames[i + 1])
        result = ref_engine.wait_and_grab()
        ref_tracker.process(None, [tuple(map(int, b))
                                   for b in result['boxes']],
                            [kp.reshape(-1) for kp in result['kp']])
        want.append((result, ref_tracker.get_tracked_objects()))
    for (r, objs), (r_ref, objs_ref) in zip(got, want):
        for k in r_ref:
            np.testing.assert_array_equal(r[k], r_ref[k])
        assert objs == objs_ref
    assert sum(len(o) for _, o in got) > 0
    assert any(o.label != 'ID -1' for _, objs in got for o in objs)


class _FifoEngine:
    """Stands in for the engine in both demo loops: ``run_async`` queues the
    next of ``results``, ``wait_and_grab`` returns the oldest queued; the
    order of the calls is kept in ``calls``."""

    def __init__(self, results):
        self.results, self.pending, self.calls = results, [], []

    def run_async(self, frame):
        i = sum(c[0] == 'run' for c in self.calls)
        self.pending.append(i)
        self.calls.append(('run', i))

    def wait_and_grab(self):
        i = self.pending.pop(0)
        self.calls.append(('grab', i))
        return self.results[i]


class _Capture:
    def __init__(self, frames):
        self.frames = iter(frames)

    def read(self):
        frame = next(self.frames, None)
        return frame is not None, frame

    def release(self):
        pass


@pytest.mark.parametrize('max_frames', [0, 5])
def test_demo_loop_matches_jax_loop(max_frames):
    """The port's loop against ``scripts/demo.py``'s over 8 frames: the same
    dispatch/wait order and tracked objects (exact); without ``max_frames``
    the port also yields frame 8, which the JAX loop drops in flight."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'jax_demo', os.path.join(REPO, 'scripts', 'demo.py'))
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)

    class RecordingTracker(JaxTracker):
        def get_tracked_objects(self):
            objs = super().get_tracked_objects()
            self.seen.append(objs)
            return objs

    n_frames, (h, w) = 8, (480, 640)
    results = [dict(boxes=np.asarray(dets, np.float32).reshape(-1, 4),
                    kp=np.asarray(kps, np.float32).reshape(-1, 9, 2))
               for dets, kps in detection_sequence(3)[:n_frames]]
    frames = [np.zeros((h, w, 3), np.uint8) for _ in range(n_frames)]
    kw = asdict(IOUTrackerConfig())
    kw['time_window'] = 2
    ref_engine, ref_tracker = _FifoEngine(results), RecordingTracker(**kw)
    ref_tracker.seen = []
    jax_demo.run(_Capture([f.copy() for f in frames]), ref_engine,
                 ref_tracker, resolution=(w, h), benchmark=True,
                 max_frames=max_frames)
    engine = _FifoEngine(results)
    got = [objs for _, _, objs in demo.run(
        iter(frames), engine, IOUTracker(**kw), max_frames=max_frames)]

    grabbed = [i for c, i in engine.calls if c == 'grab']
    ref_grabbed = [i for c, i in ref_engine.calls if c == 'grab']
    n = max_frames or n_frames
    assert grabbed == list(range(n))
    assert ref_grabbed == list(range(max_frames or n_frames - 1))
    # dispatch frame N, then wait for N-1: the same calls in both loops up
    # to the port's last wait, which the JAX loop makes after one more
    # dispatch (max_frames) or never (the end of the input)
    assert engine.calls[:-1] == ref_engine.calls[:len(engine.calls) - 1]
    assert engine.calls[-1] == ('grab', n - 1)
    assert got[:len(ref_grabbed)] == ref_tracker.seen
    assert any(o.label != 'ID -1' for objs in got for o in objs)


def test_demo_draws_and_refuses_int8(weights, tmp_path,  # noqa: F811
                                     monkeypatch, capsys):
    """The loop draws; ``--int8`` no longer refuses: ``main`` calibrates both
    stages on the first frame of a video, serves the rest through the int8
    path and draws them."""
    import cv2 as cv
    from tpudet3d_torch.infer import quant
    frames = moving_frames(3, (240, 320, 3))
    engine = _port_engine(weights)
    drawn = [f for f, _, _ in demo.run(
        iter([f.copy() for f in frames]), engine, IOUTracker(time_window=0),
        draw=True)]
    assert all(d.shape == f.shape for d, f in zip(drawn, frames))
    assert any(not np.array_equal(d, f) for d, f in zip(drawn, frames))
    assert list(demo.run(iter([]), engine, IOUTracker())) == []
    video = str(tmp_path / 'clip.avi')
    writer = cv.VideoWriter(video, cv.VideoWriter_fourcc(*'MJPG'), 10,
                            (320, 240))
    for f in moving_frames(4, (240, 320, 3)):
        writer.write(f)
    writer.release()
    int8_engine, served = _port_engine(weights), []
    conv = quant.int8_conv
    monkeypatch.setattr(quant, 'int8_conv', lambda *a: served.append(1)
                        or conv(*a))
    monkeypatch.setattr(demo, 'build_engine', lambda *a, **kw: int8_engine)
    shown = []
    run = demo.run
    monkeypatch.setattr(demo, 'run', lambda *a, **kw: (
        shown.append(f.copy()) or (f, r, o) for f, r, o in run(*a, **kw)))
    monkeypatch.chdir(tmp_path)
    demo.main(['--video', video, '--int8', '--benchmark', '--resolution',
               '320', '240', '--device', 'cpu'])
    assert 'int8: calibrated 38+' in capsys.readouterr().out
    assert int8_engine.cfg.det_int8_scales and int8_engine.cfg.reg_int8_scales
    assert len(shown) == 3 and served            # the first frame calibrated
    decoded = list(demo.capture_frames(cv.VideoCapture(video), (320, 240)))
    assert len(decoded) == 4
    assert any(not np.array_equal(d, f) for d, f in zip(shown, decoded[1:]))
    kp = np.random.RandomState(4).uniform(0, 1, (9, 2))
    img = frames[0]
    for kw in (dict(), dict(RGB=False, normalized=True, label='cup')):
        np.testing.assert_array_equal(draw_kp(img, kp, **kw),
                                      jax_draw_kp(img, kp, **kw))


def test_port_imports_without_cv2():
    """No module of the port imports cv2 when it is imported (the card's
    machine has none)."""
    code = textwrap.dedent('''
        import importlib, pkgutil, sys
        sys.modules['cv2'] = None          # any import of cv2 fails
        import tpudet3d_torch
        for m in pkgutil.walk_packages(tpudet3d_torch.__path__,
                                       'tpudet3d_torch.'):
            importlib.import_module(m.name)
        print('ok')
    ''')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and 'ok' in res.stdout, res.stderr
