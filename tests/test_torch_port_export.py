"""Regressor export of the port (``infer/export.py``, ``tools/export.py``)
against the JAX package's ``tpudet3d/infer/export.py`` (CPU, float32).

- Round trip: ``load_exported(export_regressor(...))`` on raw uint8 BGR
  crops against JAX's ``make_export_fn`` on the same weights
  (``utils/convert.py``) and crops, at ``tests/test_export.py``'s
  tolerances (keypoints 1e-5, logits 1e-4), for MNv3-large-21k and
  EfficientNet-lite0; the reloaded program equals the eager one it was
  exported from (1e-6: the same float32 operations).
- The folded preprocessing equals an explicit channel flip and
  ``(x - mean·255) / (std·255)`` before the model, exactly.
- ``tools/export.py`` writes ``model.pt2`` and ``model.graph.txt`` and the
  reloaded program serves the weights it was asked for: seeded ones with a
  warning without a snapshot, the newest converted snapshot of the
  config's ``output_dir`` (its EMA under an EMA config) or the one given
  by ``--snapshot``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet3d.infer.export import make_export_fn as jax_make_export_fn

from tpudet3d_torch.core import AttrDict as PortAttrDict
from tpudet3d_torch.core import read_py_config
from tpudet3d_torch.infer.export import (export_regressor, load_exported,
                                         make_export_fn)
from tpudet3d_torch.models import build_model
from tpudet3d_torch.tools import export as export_cli
from tpudet3d_torch.utils.checkpoint import save_converted
from test_torch_port_engine import regressor_weights
from torch_port_common import (config_file, one_cpu_thread, port_of,
                               set_no_tf32, to_jax)

ARCHS = {'mnv3': ('mobilenetv3_large_21k', 12),
         'el0': ('efficientnet-lite0', 13)}


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


def _raw(n, size=64, seed=30):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize('arch', list(ARCHS))
def test_export_roundtrip_matches_jax(arch, tmp_path):
    name, seed = ARCHS[arch]
    reg, rv = regressor_weights(name, seed=seed)
    model = port_of(build_model(PortAttrDict(model=dict(
        name=name, num_classes=9, bf16=False))), rv)
    raw = _raw(2)
    exported = export_regressor(model, str(tmp_path), img_size=(64, 64),
                                batch_size=2)
    assert (tmp_path / 'model.pt2').exists()
    assert 'ExportedProgram' in (tmp_path / 'model.graph.txt').read_text()
    kp, logits = _outputs(load_exported(str(tmp_path)), raw)
    assert kp.shape == (9, 2, 9, 2) and logits.shape == (2, 9)
    assert np.all((kp >= 0) & (kp <= 1))
    kp_ref, logits_ref = jax_make_export_fn(reg, to_jax(rv), (64, 64))(
        jnp.asarray(raw))
    np.testing.assert_allclose(kp, np.asarray(kp_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits, np.asarray(logits_ref), rtol=0,
                               atol=1e-4)
    for a, b in zip(_outputs(exported.module(), raw),
                    _outputs(make_export_fn(model), raw)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_preprocessing_folded():
    name, seed = ARCHS['mnv3']
    _, rv = regressor_weights(name, seed=seed)
    model = port_of(build_model(PortAttrDict(model=dict(
        name=name, num_classes=9, bf16=False))), rv)
    raw = torch.from_numpy(_raw(1, seed=31))
    mean = torch.tensor([0.5931, 0.4690, 0.4229]) * 255
    std = torch.tensor([0.2471, 0.2214, 0.2157]) * 255
    with torch.no_grad():
        folded = make_export_fn(model)(raw)
        manual = model((raw.flip(-1).float() - mean) / std)
        rgb = make_export_fn(model, bgr_input=False)(raw)
        manual_rgb = model((raw.float() - mean) / std)
    for a, b in zip(folded + rgb, manual + manual_rgb):
        assert torch.equal(a, b)


def _outputs(fn, raw):
    with torch.no_grad():
        return [t.numpy() for t in fn(torch.from_numpy(raw))]


def test_export_cli_writes_and_reloads(tmp_path, capsys):
    out_dir = tmp_path / 'run'
    cfg = config_file(tmp_path / 'el0_ema_64.py', 'scene_regressor_el0_ema.py',
                      "model['bf16'] = False", "data['resize'] = (64, 64)",
                      f"output_dir = {str(out_dir)!r}")
    raw = _raw(1, seed=32)
    seeded = build_model(read_py_config(cfg),
                         generator=torch.Generator().manual_seed(0))

    def run(dest, *flags):
        export_cli.main(['--config', cfg, '--model_export_path', str(dest),
                         '--img_size', '64', '64', '--device', 'cpu',
                         *flags])
        assert (dest / 'model.pt2').exists()
        assert (dest / 'model.graph.txt').exists()
        return _outputs(load_exported(str(dest)), raw)

    # no snapshot: seeded weights, with a warning
    got = run(tmp_path / 'seeded')
    assert 'WARNING: no snapshot found' in capsys.readouterr().out
    for a, b in zip(got, _outputs(make_export_fn(seeded), raw)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # the newest converted snapshot of output_dir; this config serves EMA
    params = {k: v for k, v in seeded.state_dict().items()
              if not k.endswith('num_batches_tracked')}
    gen = torch.Generator().manual_seed(33)
    snaps = {}
    for epoch in (2, 10):
        ema = {k: v if 'running_' in k else v + 0.05 * torch.randn(
            v.shape, generator=gen) for k, v in params.items()}
        out_dir.mkdir(exist_ok=True)
        snaps[epoch] = (save_converted(str(out_dir / f'snap_{epoch}.pt'),
                                       'regressor', epoch, params, ema), ema)
    for flags, epoch in (((), 10), (('--snapshot', snaps[2][0]), 2)):
        got = run(tmp_path / f'snap{epoch}', *flags)
        assert f'snap_{epoch}.pt' in capsys.readouterr().out
        want = build_model(read_py_config(cfg))
        want.load_state_dict(snaps[epoch][1], strict=False)
        for a, b in zip(got, _outputs(make_export_fn(want), raw)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
