"""The port's Objectron → COCO converter (``tpudet3d_torch/data/converter``,
``tools/objectron_2_coco.py``) against the JAX package's on the synthetic
Objectron tree of ``tests/test_etl_roundtrip.py``: equal JSON and
byte-equal frames, through the module and through the CLI."""

import json
import sys

import numpy as np
import pytest

pytest.importorskip('cv2')

from tests.test_etl_roundtrip import objectron_tree  # noqa: F401 (fixture)
from torch_port_common import REPO
from tpudet3d.data import converter as jax_converter
from tpudet3d_torch.data import converter
from tpudet3d_torch.tools import objectron_2_coco


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def _same_output(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    assert any(k.endswith('.jpg') for k in ta)
    for k in ta:
        if k.endswith('.json'):
            assert json.loads(ta[k]) == json.loads(tb[k]), k
        else:
            assert ta[k] == tb[k], k


def test_sequence_parsing_matches_jax(objectron_tree):  # noqa: F811
    data_root, _ = objectron_tree
    path = str(data_root / 'annotation' / 'cup' / 'batch-1' / '0.pbdata')
    ours = converter.load_annotation_sequence(path)
    ref = jax_converter.load_annotation_sequence(path)
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o[0], r[0])
        assert o[1:] == r[1:]
    data = open(path, 'rb').read()
    assert converter.parse_sequence(data) == \
        jax_converter.parse_sequence(data)


@pytest.mark.parametrize('fps_divisor,res_divisor', [(1, 1), (2, 2)])
def test_convert_matches_jax(objectron_tree, tmp_path, fps_divisor,  # noqa: F811
                             res_divisor):
    data_root, _ = objectron_tree
    for pkg, name in ((converter, 'port'), (jax_converter, 'jax')):
        for subset in ('train', 'test'):
            pkg.convert(str(data_root), str(tmp_path / name), subset,
                        obj_classes=('cup',),
                        index_root=str(data_root / 'index'),
                        fps_divisor=fps_divisor, res_divisor=res_divisor)
    _same_output(tmp_path / 'port', tmp_path / 'jax')


def test_cli_matches_jax_script(objectron_tree, tmp_path, monkeypatch):  # noqa: F811
    data_root, _ = objectron_tree
    args = ['--data_root', str(data_root), '--obj_classes', 'cup',
            '--res_divisor', '2']
    objectron_2_coco.main(args + ['--output_folder', str(tmp_path / 'port')])
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'jax_objectron_2_coco', f'{REPO}/scripts/objectron_2_coco.py')
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, 'argv', ['objectron_2_coco.py', *args,
                                      '--output_folder',
                                      str(tmp_path / 'jax')])
    script.main()
    _same_output(tmp_path / 'port', tmp_path / 'jax')
    coco = json.loads((tmp_path / 'port' / 'annotations' /
                       'objectron_test.json').read_text())
    assert len(coco['images']) == 4 and coco['images'][0]['width'] == 32
