"""Nothing the benchmark runs imports JAX, Flax or the JAX package, by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the port either."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'tpudet3d'}


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


SOURCES = sorted(p for p in ROOT.rglob('*.py') if 'tests' not in p.parts)


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize('path', sorted((ROOT / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert 'tpudet3d_torch' not in set(top_level_imports(path))


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types
    from harness import common
    monkeypatch.setitem(sys.modules, 'tpudet3d_torch.fake',
                        types.ModuleType('tpudet3d_torch.fake'))
    assert 'tpudet3d' not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jax.fake', types.ModuleType('jax'))
    assert 'jax' in common.forbidden_modules()
