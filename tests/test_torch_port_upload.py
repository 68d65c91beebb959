"""The staged upload of host frames (``infer/upload.py``,
``kernels/csrc/host_stage.cpp``).

On the CPU: the C++ routine copies byte for byte at odd sizes and
unaligned ends, the chunk plan covers the bytes once in whole frames, the
staging buffer grows for a larger batch and is reused for a smaller one,
the ATen fallback gives the same bytes, and ``upload_stats`` counts the
engine's uploads on the graph path (the stand-in capturer of
``torch_port_graph_stub.py``), the eager path and the sharded path.  On
the card (``-m cuda``, skipped elsewhere): back-to-back replays of two
batches of one shape each answer with their own rows, bit for bit with
the eager path, and a batch that does not divide into whole chunks
arrives byte for byte.  This file imports no JAX, so on the machine with
the card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_upload.py
"""

import os
import os.path as osp
import sys
import threading

import numpy as np
import pytest
import torch

import tpudet3d_torch.infer.upload as upload_mod
from tpudet3d_torch import native
from tpudet3d_torch.core import AttrDict
from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.infer import EngineConfig, TwoStageEngine
from tpudet3d_torch.infer.upload import (Stager, chunk_plan, stage_copy,
                                         upload, upload_counts)
from tpudet3d_torch.models import build_model
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


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of at most 2 of :func:`_frames`' frames."""
    monkeypatch.setattr(upload_mod, 'CHUNK_BYTES', 2 * 64 * 96 * 3 + 5)


def test_routine_is_built_and_used():
    """The C++ routine builds into the port's build directory and is what
    the upload runs where ``g++`` is present."""
    assert upload_mod._load()
    path = native._lib_path(upload_mod._SRC, 'host_stage')
    assert osp.exists(path)
    assert path.startswith(osp.join(osp.dirname(native.__file__), 'kernels',
                                    '_build'))


@pytest.mark.parametrize('n', [0, 1, 15, 63, 64, 65, 4095, 4096, 16383,
                               16384, 16385, 2 * 16384 + 4097 + 13,
                               3 * 2 ** 20 + 7])
@pytest.mark.parametrize('src_off, dst_off', [(0, 0), (1, 0), (0, 3),
                                              (7, 13), (61, 33)])
def test_routine_copies_byte_for_byte(n, src_off, dst_off):
    """At odd sizes, across whole 4-page blocks and lines and with
    unaligned source and destination, the routine writes the source's
    bytes and nothing beside them."""
    rng = np.random.RandomState(n + src_off)
    src = torch.from_numpy(rng.randint(0, 256, n + src_off + 3,
                                       dtype=np.uint8))[src_off:][:n]
    dst = torch.full((dst_off + n + 9,), 0xA5, dtype=torch.uint8)
    stage_copy(dst[dst_off:dst_off + n], src)
    assert torch.equal(dst[dst_off:dst_off + n], src)
    assert (dst[:dst_off] == 0xA5).all() and (dst[dst_off + n:] == 0xA5).all()


@pytest.mark.parametrize('n, item, chunk', [
    (32, 2764800, 12 << 20), (33, 2764800, 12 << 20), (1, 2764800, 12 << 20),
    (4, 2764800, 12 << 20), (5, 2764800, 12 << 20), (3, 100, 1000),
    (7, 5000, 1000), (0, 10, 100), (10, 1, 3)])
def test_chunk_plan_covers_whole_frames_once(n, item, chunk):
    """The plan covers ``0..n`` once, in order, in chunks of whole frames of
    at most ``chunk`` bytes each (one frame where a frame is larger), all
    but the last equal; an upload no larger than a chunk is one chunk."""
    plan = chunk_plan(n, item, chunk)
    assert [i for a, b in plan for i in range(a, b)] == list(range(n))
    sizes = [b - a for a, b in plan]
    assert all(s >= 1 and (s * item <= chunk or s == 1) for s in sizes)
    assert len(set(sizes[:-1])) <= 1 and (not sizes or sizes[-1] <= sizes[0])
    if 0 < n * item <= chunk:
        assert plan == [(0, n)]
    if n:
        assert len(plan) == -(-n // max(1, chunk // item))


def test_the_720p_batch_is_eight_chunks_of_four_frames():
    """The serving cells' 32 frames of 720p upload in 8 chunks of 4 frames
    (11.06 MB each)."""
    assert chunk_plan(32, 720 * 1280 * 3, upload_mod.CHUNK_BYTES) == [
        (i, i + 4) for i in range(0, 32, 4)]


def test_buffer_grows_and_is_reused(small_chunks):
    """The staging buffer is sized to the largest upload seen: a larger
    batch grows it, a smaller one reuses it."""
    st = Stager(torch.device('cpu'))
    stats = upload_counts()
    for n, size in ((2, 2), (5, 5), (1, 5), (3, 5), (6, 6)):
        frames = _frames(n, seed=n)
        out = st.copy(torch.from_numpy(frames), torch.empty(frames.shape,
                                                            dtype=torch.uint8),
                      stats)
        np.testing.assert_array_equal(out.numpy(), frames)
        assert st.buffer.numel() == size * 64 * 96 * 3
        if n in (1, 3):
            assert st.buffer.data_ptr() == ptr
        ptr = st.buffer.data_ptr()
    assert stats == {'calls': 5, 'chunks': 1 + 3 + 1 + 2 + 3,
                     'bytes': 17 * 64 * 96 * 3, 'waits': 0}


@pytest.mark.parametrize('n', [1, 3, 4])
def test_fallback_without_the_routine_gives_the_same_bytes(n, monkeypatch,
                                                           small_chunks):
    """Where the routine cannot be built the upload takes ATen's copy, with
    the same bytes and the same chunks."""
    frames = _frames(n, seed=10 + n)
    staged = upload(frames, 'cpu').numpy()
    monkeypatch.setattr(upload_mod, '_lib', False)
    stats = upload_counts()
    fallback = upload(frames, 'cpu', stats=stats).numpy()
    np.testing.assert_array_equal(fallback, frames)
    np.testing.assert_array_equal(fallback, staged)
    assert stats['chunks'] == len(chunk_plan(n, 64 * 96 * 3,
                                             upload_mod.CHUNK_BYTES))
    monkeypatch.setattr(upload_mod, '_SRC', '/nonexistent/host_stage.cpp')
    monkeypatch.setattr(upload_mod, '_lib', None)
    assert upload_mod._load() is False
    np.testing.assert_array_equal(upload(frames, 'cpu').numpy(), frames)


def test_upload_into_out_and_of_one_frame():
    """``out`` receives the frames (its shape and dtype); one frame
    ``[H,W,3]`` is one chunk; other dtypes upload by their bytes."""
    frames = _frames(3)
    out = torch.zeros(frames.shape, dtype=torch.uint8)
    assert upload(frames, 'cpu', out=out) is out
    np.testing.assert_array_equal(out.numpy(), frames)
    stats = upload_counts()
    one = upload(frames[1], 'cpu', stats=stats)
    np.testing.assert_array_equal(one.numpy(), frames[1])
    assert stats['chunks'] == 1
    x = np.random.RandomState(0).randn(5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(upload(x, 'cpu').numpy(), x)
    for bad in (torch.zeros((3, 96, 64, 3), dtype=torch.uint8)
                .transpose(1, 2), torch.zeros((2, 64, 96, 3),
                                              dtype=torch.uint8)):
        with pytest.raises(ValueError, match='contiguous'):
            upload(frames, 'cpu', out=bad)


def test_threads_sharing_a_stager_each_get_their_own_bytes(small_chunks):
    """Threads uploading at once through the device's one stager (the
    routine releases the interpreter lock mid-copy) each receive their own
    frames: the buffer is held from a chunk's staging to its copy."""
    errors, rounds = [], 20

    def work(k):
        frames = _frames(5, seed=100 + k)
        for _ in range(rounds):
            out = upload(frames, 'cpu')
            if not np.array_equal(out.numpy(), frames):
                errors.append(k)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(3 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# --- the engine's counter ----------------------------------------------------

@pytest.fixture(scope='module')
def models():
    torch.manual_seed(0)
    det = SSDDetector(num_classes=9, width_mult=0.25)
    reg = build_model(AttrDict(model=dict(name='mobilenetv3_small',
                                          num_classes=9, bf16=False)))
    return det, reg


def _engine(models):
    return TwoStageEngine(*models, EngineConfig(det_conf=0.0,
                                                max_detections=4,
                                                crop_size=(64, 64)),
                          device='cpu')


def _assert_same(a, b):
    assert len(a) == len(b)
    for r, q in zip(a, b):
        for k in FIELDS:
            np.testing.assert_array_equal(r[k], q[k])


def test_upload_stats_count_the_graph_path(models, monkeypatch, small_chunks,
                                           stub_graphs):  # noqa: F811
    """On the graph path each call is one upload (the capture's into a new
    static input, each replay's into it), in the plan's chunks, and the
    rows are the eager path's on the same frames."""
    engine = graph_on_cpu(_engine(models), monkeypatch)
    assert engine.upload_stats == upload_counts()
    batches = [_frames(5, seed=s) for s in (3, 4)]
    for frames in batches + batches:
        h, w = frames.shape[1:3]
        _assert_same(engine.infer_batch(frames), engine._readback(
            [engine._pipeline_batch(torch.from_numpy(frames), h, w)]))
    assert engine.graph_stats == {'captures': 1, 'replays': 3, 'eager': 0}
    assert engine.upload_stats == {'calls': 4, 'chunks': 4 * 3,
                                   'bytes': 4 * 5 * 64 * 96 * 3, 'waits': 0}
    (g,) = engine._graphs.values()
    np.testing.assert_array_equal(g.static_in.numpy(), batches[1])


def test_upload_stats_count_the_eager_paths(models, small_chunks):
    """``infer_batch`` on a CPU engine, ``run_async`` and each replica of
    ``shard`` upload through the stager and count."""
    engine = _engine(models)
    frames = _frames(4)
    engine.infer_batch(frames)
    assert engine.upload_stats['calls'] == 1
    assert engine.upload_stats['chunks'] == 2
    engine(frames[0])
    assert engine.upload_stats['calls'] == 2
    assert engine.upload_stats['chunks'] == 3
    engine.shard(['cpu', 'cpu'])
    engine.infer_batch(frames)
    assert engine.upload_stats == {'calls': 4, 'chunks': 5,
                                   'bytes': 9 * 64 * 96 * 3, 'waits': 0}


# --- on the card -------------------------------------------------------------

@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda')


@pytest.fixture
def deterministic():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


@pytest.mark.cuda
def test_back_to_back_batches_answer_their_own_rows_on_card(card,
                                                            deterministic):
    """Two batches of one shape replayed back to back, in turns, each give
    their own rows, bit for bit with the eager path on the same frames:
    the staging buffer is neither stale nor overwritten before its copy.
    9 frames of 720p are 3 chunks (4, 4, 1); the closed loop never waits
    for the buffer."""
    from tpudet3d_torch.infer import build_engine
    engine = build_engine(det_conf=0.0, device=card)
    a, b = (_frames(9, 720, 1280, seed=s) for s in (1, 2))
    h, w = a.shape[1:3]
    eager = [engine._pipeline_batch(engine._upload(f), h, w) for f in (a, b)]
    assert not torch.equal(*eager)
    start = dict(engine.upload_stats)
    for i in range(6):
        k = i % 2
        rows = engine.infer_batch((a, b)[k])
        _assert_same(rows, engine._readback([eager[k]]))
        if i:     # a capture runs nothing: its answer is the warm-up's
            (g,) = engine._graphs.values()
            assert torch.equal(g.static_out, eager[k]), i
    assert engine.graph_stats == {'captures': 1, 'replays': 5, 'eager': 0}
    assert engine.upload_stats['calls'] - start['calls'] == 6
    assert engine.upload_stats['chunks'] - start['chunks'] == 6 * 3
    assert engine.upload_stats['waits'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 9, 13])
def test_uneven_batch_arrives_byte_for_byte_on_card(card, n):
    """A batch that does not divide into whole chunks arrives byte for
    byte, each of two uploads made without a synchronize between them
    too, and an upload into a slice of a card tensor leaves the rest of
    it as it was."""
    frames = [_frames(n, 720, 1280, seed=s) for s in (5, 6)]
    stats = upload_counts()
    outs = [upload(f, card, stats=stats) for f in frames]
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o.cpu().numpy(), f)
    plan = chunk_plan(n, 720 * 1280 * 3, upload_mod.CHUNK_BYTES)
    assert stats['calls'] == 2 and stats['chunks'] == 2 * len(plan)
    into = torch.zeros((n + 1, 720, 1280, 3), dtype=torch.uint8, device=card)
    upload(frames[0], card, out=into[1:])
    torch.cuda.synchronize(card)
    assert int(into[0].count_nonzero()) == 0
    np.testing.assert_array_equal(into[1:].cpu().numpy(), frames[0])
