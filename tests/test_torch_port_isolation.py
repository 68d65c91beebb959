"""The port stands alone: importing it and every submodule loads neither
JAX, Flax nor the JAX package, and its entry points never fall back to the
CPU on their own."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    code = textwrap.dedent('''
        import importlib, pkgutil, sys
        import tpudet3d_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpudet3d_torch.__path__, 'tpudet3d_torch.')]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                            'orbax', 'tpudet3d'))
        print(len(names), bad)
        assert not bad, bad
        assert len(names) >= 20, names
    ''')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_silent_cpu_default(monkeypatch, tmp_path):
    from tpudet3d_torch.core import read_py_config, resolve_device
    from tpudet3d_torch.infer import build_engine
    from tpudet3d_torch.losses import LossManager, build_loss
    from tpudet3d_torch.models import build_model
    from tpudet3d_torch.train import build_optimizer, create_train_state
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_engine()
    # the train state, from a config or from the parts a train step takes
    cfg = read_py_config(os.path.join(REPO, 'configs', 'scene_regressor.py'))
    cfg.model.name = 'mobilenetv3_small'
    with pytest.raises(RuntimeError, match='CUDA'):
        create_train_state(cfg)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        create_train_state(model, build_optimizer(cfg, model.parameters()),
                           LossManager(build_loss(cfg), cfg.loss.coeffs,
                                       cfg.loss.alwa))
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()
    assert resolve_device('cpu') == torch.device('cpu')
    # the training loop's entry points: setup_training and the CLI
    from tpudet3d_torch.tools import main as train_cli
    from tpudet3d_torch.train.pipeline import setup_training
    with pytest.raises(RuntimeError, match='CUDA'):
        setup_training(cfg, with_loaders=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA'):
        train_cli.main(['--config', os.path.join(REPO, 'configs',
                                                 'scene_regressor.py'),
                        '--output_dir', str(tmp_path / 'out')])
    # detector training and self-labelling: the state, the generator and
    # both CLIs
    from tpudet3d_torch.data.selflabel import generate_selflabel_boxes
    from tpudet3d_torch.data.synthetic_scene import SyntheticScene
    from tpudet3d_torch.detect import SSDDetector
    from tpudet3d_torch.detect.train import create_detector_state
    from tpudet3d_torch.tools import selflabel_boxes, train_detector
    with pytest.raises(RuntimeError, match='CUDA'):
        create_detector_state(SSDDetector(width_mult=0.25))
    with pytest.raises(RuntimeError, match='CUDA'):
        generate_selflabel_boxes(SyntheticScene(length=1), 'snap_0.pt',
                                 str(tmp_path / 'boxes.npz'))
    with pytest.raises(RuntimeError, match='CUDA'):
        train_detector.main(['--config', os.path.join(
            REPO, 'configs', 'detection', 'mnv2_ssd_300_synthetic_hard.py'),
            '--output_dir', str(tmp_path / 'det')])
    with pytest.raises(RuntimeError, match='CUDA'):
        selflabel_boxes.main(['--config', os.path.join(
            REPO, 'configs', 'scene_regressor_selflabel.py'),
            '--det_checkpoint', 'snap_0.pt', '--out',
            str(tmp_path / 'boxes.npz')])


def test_source_names_no_jax_import():
    """No module of the port names JAX or the JAX package in an import."""
    root = os.path.join(REPO, 'tpudet3d_torch')
    bad = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for line in fh:
                        s = line.strip()
                        if s.startswith(('import ', 'from ')) and any(
                                s.split()[1].split('.')[0] == m for m in
                                ('jax', 'flax', 'optax', 'orbax',
                                 'tpudet3d')):
                            bad.append((path, s))
    assert not bad, bad


def test_package_tools_import_no_card_smoke(tmp_path):
    """The card smoke (``chip_smoke.py`` at the repo root) is a leaf: the
    cases, the golden record's support and every kernel tool import from
    the package alone, from any directory, with only the repo root on
    the path."""
    import glob
    tools = sorted(os.path.basename(f)[:-3] for f in glob.glob(os.path.join(
        REPO, 'tpudet3d_torch', 'tools', 'k*_bench.py')))
    assert tools, 'no kernel tool found'
    modules = ['tpudet3d_torch.tools.cases', 'tpudet3d_torch.utils.golden'] \
        + [f'tpudet3d_torch.tools.{t}' for t in tools]
    code = textwrap.dedent(f'''
        import importlib, sys
        for name in {modules!r}:
            importlib.import_module(name)
        assert 'chip_smoke' not in sys.modules, 'chip_smoke was imported'
    ''')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_golden_support_imports_numpy_and_torch_only():
    """``utils/golden.py`` remakes the golden record's inputs on a machine
    without JAX: its imports are the standard library, numpy, torch and
    the port, and importing it alone loads neither JAX nor the JAX
    package."""
    import ast
    path = os.path.join(REPO, 'tpudet3d_torch', 'utils', 'golden.py')
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add('.' if node.level else node.module.split('.')[0])
    assert names <= {'hashlib', 'json', 'os', 'numpy', 'torch', '.'}, names
    code = textwrap.dedent('''
        import sys
        from tpudet3d_torch.utils import golden
        golden.remake_variables([['params', ['Conv_0', 'kernel'],
                                  [3, 3, 3, 8], 'conv']], 0)
        golden.golden_frames(1, 32, 48, 0)
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                            'optax', 'tpudet3d'))
        assert not bad, bad
    ''')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
