"""A stand-in for CUDA-graph capture on the CPU, so that the serving
engine's graph cache (``infer/engine.py``) runs without a card: the
"capture" calls the path once and each "replay" calls it again into the
same static output, reading the static input as it then is."""

import pytest

import tpudet3d_torch.infer.engine as engine_mod


class StubGraph:
    def __init__(self, fn):
        self.fn = fn
        self.out = fn()
        self.replays = 0

    def replay(self):
        self.out.copy_(self.fn())
        self.replays += 1


@pytest.fixture
def stub_graphs(monkeypatch):
    """Capture by :class:`StubGraph`, the warm-up a plain call; returns
    the list of graphs captured, in order."""
    captured = []

    def capture(fn, device):
        g = StubGraph(fn)
        captured.append(g)
        return g, g.out

    monkeypatch.setattr(engine_mod, 'capture_graph', capture)
    monkeypatch.setattr(engine_mod, 'warm_up', lambda fn, device: fn())
    return captured


def graph_on_cpu(engine, monkeypatch):
    """Give a CPU engine the graph path, as an unsharded card engine has
    it."""
    monkeypatch.setattr(engine, '_graphed', lambda: not engine._replicas)
    return engine
