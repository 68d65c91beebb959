"""The golden record of the JAX package's bf16 and int8 product route on
the CPU: ``tests/torch_port_golden.py`` (the JAX half, which writes the
record) and ``tpudet3d_torch/utils/golden.py`` (the half that remakes
every input without JAX and holds the rules; ``chip_smoke.py`` phase 12
applies them on the card).

* The committed manifest's Flax leaves equal the JAX models' own, by
  ``jax.eval_shape`` of each init, and ``utils/golden.py`` remakes its
  weights, frames and training items bit for bit (their sha256).
* The committed cut record (``tests/fixtures/torch_port_golden/cut``:
  the detector at width 0.25, MobileNetV3-small, two 180×320 frames, 64²
  crops; training batches of 4 at 96² and 2 at 64²), written by the
  generator's ``--plan cut``: its inputs remade bit for bit and its JAX
  bf16 detector outputs and calibrated statistics computed again here in
  process; the port's bf16 and int8 on the CPU meet phase 12's rules
  against it, through phase 12's own code, and a zero or negated
  gradient, or a zero forward, fails every gated step rule.  Rebuilding
  the whole cut record (five JAX processes, about 2.5 min) is the test
  marked ``slow``.
* The committed record's float32 keypoints of case A, remade at full
  width on the CPU, equal the port's float32 within 1e-4 (the float32
  parity of tests/test_torch_port_engine.py), so that a miss on the card
  is not a remaking fault.
* The rules themselves, the sketch's norm estimate and the Flax layout
  of a port module's tensors.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_golden as gen
from tpudet3d_torch.utils import golden
from torch_port_common import REPO, one_cpu_thread, set_no_tf32

FIXTURE = osp.join(REPO, golden.FIXTURE)
CUT_FIXTURE = osp.join(REPO, gen.CUT_FIXTURE)
MODELS = ['det_plain', 'det_cascade', 'reg_mnv3', 'reg_el0']
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


@pytest.fixture(scope='module')
def record():
    return golden.load_golden(FIXTURE)


# --- the committed record --------------------------------------------------

@pytest.mark.parametrize('name', MODELS)
def test_manifest_leaves_match_jax_trees(record, name):
    spec = record[0]['models'][name]
    tree = jax.eval_shape(gen.jax_model(spec, jnp.float32).init,
                          *gen.init_args(spec))
    want = [[c, p, s] for c, p, s, _ in gen.tree_leaves(tree)]
    assert [[c, p, s] for c, p, s, _ in spec['leaves']] == want
    assert [k for c, p, s, k in spec['leaves']] == [
        golden.leaf_kind(c, p, s) for c, p, s, _ in spec['leaves']]


@pytest.mark.parametrize('name', MODELS)
def test_weights_remade_bit_for_bit(record, name):
    spec = record[0]['models'][name]
    stats = record[1][spec['stats']]
    v = golden.remake_variables(spec['leaves'], spec['seed'], stats)
    assert golden.tree_digest(v) == spec['sha256']
    assert golden.tree_digest(gen.variables(spec, stats)) == spec['sha256']


def test_inputs_remade_bit_for_bit(record):
    manifest = record[0]
    fr = manifest['frames']
    frames = golden.golden_frames(fr['n'], fr['h'], fr['w'], fr['seed'])
    assert frames.shape == (4, 720, 1280, 3) and frames.dtype == np.uint8
    assert golden.digest(frames) == fr['sha256']
    for case, spec in manifest['train'].items():
        assert golden.digest(*gen.train_items(spec)) == spec['sha256'], case


def test_planted_boxes_leave_the_frames(record):
    """``golden_boxes`` draws the rectangles from the stream of
    ``golden_frames`` without moving it: the frames keep the manifest's
    digest, 3 to 5 rectangles a frame lie inside it, and the one drawn
    last shows its fill on every pixel, the brightness bin of which is
    its label."""
    fr = record[0]['frames']
    args = (fr['n'], fr['h'], fr['w'], fr['seed'])
    frames = golden.golden_frames(*args)
    assert golden.digest(frames) == fr['sha256']
    boxes, labels, valid = golden.golden_boxes(*args)
    assert boxes.shape == (fr['n'], 5, 4) and labels.dtype == np.int64
    assert np.all((valid.sum(1) >= 3) & (valid.sum(1) <= 5))
    assert valid[:, :3].all() and not boxes[~valid].any()
    for f, b, lab, ok in zip(frames, boxes, labels, valid):
        assert np.all(b[ok, :2] >= 0) and np.all(b[ok, 2] <= fr['w'])
        assert np.all(b[ok, 3] <= fr['h'])
        x0, y0, x1, y1 = b[ok][-1].astype(int)
        region = f[y0:y1, x0:x1].reshape(-1, 3)
        assert (region == region[0]).all()
        assert lab[ok][-1] == int(region[0].astype(int).sum()) * 9 // 768
    np.testing.assert_array_equal(golden.golden_boxes(*args)[0], boxes)


def test_record_holds_every_case(record):
    manifest, arrays = record
    assert sorted(manifest['serving']) == ['A', 'B']
    assert sorted(manifest['train']) == ['D', 'E']
    for case in 'AB':
        assert set(manifest['int8'][case]) == {'bf16', 'f32',
                                               'bf16_f32_crops'}
        for k in ('bf16/regress_rows', 'f32/regress_rows'):
            assert arrays[f'{case}/{k}'].shape == (4, 8, 25)
        assert arrays[f'C/{case}/regress_rows'].shape == (4, 8, 25)
        assert arrays[f'C/{case}/calib_dets'].shape == (4, 8, 6)
        for stage in ('det', 'reg'):
            assert len(manifest['int8'][case]['bf16'][stage]) > 10
        assert arrays[f'{case}/bf16/det_logits'].shape == (4, 2044, 10)
        assert arrays[f'C/{case}/pre'].shape == (32, 9, 18)
        assert arrays[f'C/{case}/det_logits'].shape == (4, 2044, 10)
    for case in 'DE':
        for prec in ('bf16', 'f32'):
            assert arrays[f'{case}/{prec}/grad_sketch'].shape == (
                golden.BUCKETS,)
    assert arrays['D/f64/grad_sketch'].shape == (golden.BUCKETS,)
    for prec in ('f32', 'f64'):
        assert arrays[f'E/{prec}/fixed_grad_sketch'].shape == (
            golden.BUCKETS,)
        assert arrays[f'E/{prec}/fwd_logits'].shape == (4, 2044, 10)
    size = sum(osp.getsize(osp.join(FIXTURE, f))
               for f in ('manifest.json', 'golden.npz'))
    assert size <= 4 * 2 ** 20


def test_f32_keypoints_remade_at_full_width(record):
    """Frame 0's crops of case A through the port's float32 regressor on
    the CPU against the JAX engine's float32 ones in the record."""
    from tpudet3d_torch.infer import EngineConfig, TwoStageEngine
    from tpudet3d_torch.infer.engine import upload
    manifest, arrays = record
    spec = manifest['models'][manifest['serving']['A']['regressor']]
    reg = chip_smoke.golden_module(spec, torch.float32, arrays).eval()
    engine = TwoStageEngine(torch.nn.Identity(), reg, EngineConfig(
        crop_size=tuple(manifest['engine']['crop_size'])), device='cpu')
    frames = chip_smoke.golden_inputs(manifest)[:1]
    m = arrays['A/boxes'].shape[1]
    with torch.no_grad():
        pre, cls = engine._heads(upload(frames, CPU), torch.from_numpy(
            arrays['A/boxes'][:1]))
    np.testing.assert_allclose(pre.numpy(), arrays['A/f32/pre'][:m],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(cls.float().numpy(), arrays['A/f32/cls'][:m],
                               rtol=0, atol=1e-4)


# --- the cut record --------------------------------------------------------

@pytest.fixture(scope='module')
def cut():
    return golden.load_golden(CUT_FIXTURE)


def test_cut_record_remade_in_process(cut):
    """The cut record's inputs from ``utils/golden.py`` bit for bit, and
    the generator's functions giving its JAX numbers again in this
    process: the calibrated statistics of every model and case A's bf16
    detector outputs."""
    manifest, arrays = cut
    frames = chip_smoke.golden_inputs(manifest)
    for name, spec in manifest['models'].items():
        chip_smoke.golden_variables(spec, arrays)
        stats = gen.calibrated_stats(dict(spec), frames)
        np.testing.assert_array_equal(stats, arrays[spec['stats']], name)
    for case, spec in manifest['train'].items():
        assert golden.digest(*gen.train_items(spec)) == spec['sha256'], case
    s = manifest['serving']['A']
    specs = {k: dict(manifest['models'][s[k]],
                     stats_values=arrays[manifest['models'][s[k]]['stats']])
             for k in ('detector', 'regressor')}
    engine = gen.build_jax_engine(
        gen.jax_detector(specs['detector'], jnp.bfloat16),
        gen.variables(specs['detector']),
        gen.jax_regressor(specs['regressor'], jnp.bfloat16),
        gen.variables(specs['regressor']), manifest['engine'])
    logits, deltas = gen.detect(engine, frames, f32=False)
    np.testing.assert_array_equal(logits, arrays['A/bf16/det_logits'])
    np.testing.assert_array_equal(deltas, arrays['A/bf16/det_deltas'])


@pytest.mark.slow
def test_cut_record_rebuilt(tmp_path):
    """The generator's ``--plan cut`` command writes the committed cut
    record again: the manifest equal, every array within a bf16 ulp (a
    host of another CPU may round the last bits otherwise)."""
    manifest, arrays = gen.run_workers('cut', str(tmp_path))
    want_m, want = golden.load_golden(CUT_FIXTURE)
    assert manifest == want_m
    assert sorted(arrays) == sorted(want)
    for k, v in arrays.items():
        w = want[k].astype(np.float64)
        np.testing.assert_allclose(v, w, rtol=2 ** -7, atol=1e-6,
                                   equal_nan=True, err_msg=k)


@pytest.fixture(scope='module')
def cut_serving(cut):
    manifest, arrays = cut
    return chip_smoke.golden_serving(manifest, arrays, 'A', CPU, (), False)


def _assert_ok(results):
    for k, v in results.items():
        if k not in chip_smoke.GOLDEN_REPORTED:
            assert v['ok'], (k, v)


def test_cut_serving_bf16_meets_rules(cut_serving):
    res = cut_serving[0]
    _assert_ok(res)
    # K3 on JAX's own detector outputs pairs every row, and so does the
    # second stage on JAX's detections
    assert res['dets']['paired'] == res['dets']['rows'] > 0
    rr = res['regress_rows']
    assert rr['paired'] == rr['decided'] == rr['rows'] > 0


def test_cut_int8_meets_rules(cut_serving):
    res = cut_serving[1]
    _assert_ok(res)
    assert set(res) == {'det_logits', 'det_deltas', 'pre', 'cls', 'rows',
                        'dets', 'regress_rows', 'scales',
                        'scales_on_jax_dets', 'jax_f32_crops_vs_bf16_crops'}
    assert res['regress_rows']['paired'] == res['regress_rows']['rows'] > 0


def test_cut_calibration_keys_match_jax(cut, cut_serving):
    """The port's own calibration (reported beside JAX's on the card)
    names the convs JAX's names."""
    from tpudet3d_torch.infer.quant import calibrate_engine
    manifest, _ = cut
    engine = chip_smoke.golden_engine(manifest, cut[1], 'A', CPU)
    det, reg = calibrate_engine(engine, chip_smoke.golden_inputs(manifest))
    ref = manifest['int8']['A']['bf16']
    assert sorted(det) == sorted(ref['det'])
    assert sorted(reg) == sorted(ref['reg'])


@pytest.fixture(scope='module')
def cut_steps(cut):
    manifest, arrays = cut
    return {case: fn(manifest, arrays, case, CPU, (), False)
            for case, fn in (('D', chip_smoke.golden_regressor_step),
                             ('E', chip_smoke.golden_detector_step))}


@pytest.mark.parametrize('case', ['D', 'E'])
def test_cut_train_step_meets_rules(cut, cut_steps, case):
    manifest, _ = cut
    res, _, grads = cut_steps[case]
    for key in chip_smoke.GOLDEN_GATED_GRADS[case]:
        assert res[key]['ok'], (key, res[key])
    assert res['grads_ok'] and res['ok'], res
    assert res['terms']['n'] == len(manifest['train'][case]['terms'])
    if case == 'E':
        assert res['f32_forward']['ok'], res['f32_forward']
        assert res['f32_fixed_terms']['n'] == 4


@pytest.mark.parametrize('fault', ['zero', 'negated'])
@pytest.mark.parametrize('case,key', [
    (c, k) for c, keys in chip_smoke.GOLDEN_GATED_GRADS.items()
    for k in keys])
def test_planted_gradient_fault_fails(cut, cut_steps, case, key, fault):
    """Every gated gradient rule fails a zero and a negated gradient."""
    manifest, arrays = cut
    grad = cut_steps[case][2][key]
    bad = 0 * grad if fault == 'zero' else -grad
    spec = manifest['train'][case]
    leaves = manifest['models'][spec['model']]['leaves']
    res = chip_smoke.golden_grad_rules(arrays, case, leaves,
                                       spec['sketch_seed'], {key: bad})
    assert not res[key]['ok'] and not res['grads_ok'], res[key]


def test_planted_forward_fault_fails(cut):
    """Case E's float32 forward rule fails a zeroed output."""
    _, arrays = cut
    j = arrays['E/f32/fwd_logits']
    assert not golden.continuous_rule(0 * j, j, arrays['E/f64/fwd_logits'])[
        'ok']
    assert golden.continuous_rule(j, j, arrays['E/f64/fwd_logits'])['ok']


# --- the rules -------------------------------------------------------------

def test_continuous_rule():
    rng = np.random.RandomState(0)
    j32 = rng.standard_normal(1000)
    j = j32 + rng.normal(0, 0.01, 1000)
    near = j + rng.normal(0, 0.01, 1000)           # independent rounding
    assert golden.continuous_rule(near, j, j32)['ok']
    assert not golden.continuous_rule(j + 0.05, j, j32)['ok']   # the mean
    spike = j.copy()
    spike[3] += 1.0                                           # the max
    assert not golden.continuous_rule(spike, j, j32)['ok']
    nan = near.copy()
    nan[0] = np.nan
    assert not golden.continuous_rule(nan, j, j32)['ok']
    # an exact reference: one bf16 ulp of |j| is the only slack
    assert golden.continuous_rule([1.0 + 2 ** -7], [1.0], [1.0])['ok'] \
        is False
    assert golden.continuous_rule([2.0], [2.0], [2.0])['ok']
    np.testing.assert_array_equal(golden.bf16_ulp([1.0, 3.0, 0.0]),
                                  [2 ** -7, 2 ** -6, 0.0])


def test_sketch_estimates_distances():
    rng = np.random.RandomState(1)
    n = 200_000
    hashed = golden.sketch_hash(n, seed=3)
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    sa, sb = golden.count_sketch(a, hashed), golden.count_sketch(b, hashed)
    est = np.linalg.norm(sa - sb) / np.linalg.norm(a - b)
    assert abs(est - 1) < 0.05
    assert golden.sketch_rule(sa, sa + 0.01 * sb, sa - 0.01 * sb)["ok"]
    assert not golden.sketch_rule(sb, sa, sa + 0.001 * sb)['ok']


def _rows(boxes, labels, det_labels, scores=None):
    n = len(boxes)
    return dict(boxes=np.asarray(boxes, np.float32),
                scores=np.asarray(scores if scores is not None
                                  else np.linspace(0.9, 0.5, n)),
                det_labels=np.asarray(det_labels), labels=np.asarray(labels),
                kp=np.full((n, 9, 2), 0.5))


def test_rows_rule_pairs_by_box_and_class():
    box = [10, 10, 60, 60]
    ref = _rows([box, box, [100, 100, 150, 150]], [1, 2, 3], [4, 5, 6])
    # the same box under two detector classes pairs by its class
    got = _rows([box, box, [101, 100, 151, 150]], [2, 1, 3], [5, 4, 6],
                scores=[0.7, 0.9, 0.5])
    assert golden.match_rows(got, ref) == [(0, 1), (1, 0), (2, 2)]
    res = golden.rows_rule([got], [ref], [ref])
    assert res['paired'] == res['decided'] == 3 and res['labels_equal']
    assert res['ok']
    moved = _rows([box, [300, 300, 340, 340], [100, 100, 150, 150]],
                  [1, 2, 3], [4, 5, 6])
    res = golden.rows_rule([moved], [ref], [ref])
    assert res['paired'] == 2 and not res['ok']          # 2 < ¾ of 3
    flipped = _rows([box, box, [100, 100, 150, 150]], [1, 2, 7], [4, 5, 6])
    assert not golden.rows_rule([flipped], [ref], [ref])['labels_equal']
    # a row whose label JAX's own yardstick flips is not held
    unsure = _rows([box, box, [100, 100, 150, 150]], [1, 2, 8], [4, 5, 6])
    res = golden.rows_rule([flipped], [ref], [unsure])
    assert res['decided'] == 2 and res['labels_equal'] and res['ok']


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_flax_vector_inverts_the_converter():
    """A port module's tensors in the Flax layout and leaf order: the
    flat vector of the remade ``params`` themselves."""
    spec = dict(gen.CUT['models']['det_cascade'])
    spec['leaves'] = gen.model_leaves(spec)
    v = golden.remake_variables(spec['leaves'], spec['seed'])
    stats = np.concatenate([_leaf(v['batch_stats'], path).ravel()
                            for c, path, _, _ in spec['leaves']
                            if c == 'batch_stats'])
    spec.update(sha256=golden.tree_digest(v), source='test', stats='s')
    port = chip_smoke.golden_module(spec, torch.float32, {'s': stats})
    got = golden.flax_vector(dict(port.named_parameters()), spec['leaves'])
    np.testing.assert_array_equal(got, gen.flat_params(v['params'],
                                                       spec['leaves']))
    norms = golden.leaf_norms(got, spec['leaves'])
    assert len(norms) == sum(c == 'params' for c, *_ in spec['leaves'])


def test_dets_rule():
    ref = np.zeros((1, 4, 6))
    ref[0, :3] = [[10, 10, 60, 60, 0.9, 2], [10, 10, 60, 60, 0.8, 5],
                  [100, 100, 150, 150, 0.7, 1]]
    assert golden.dets_rule(ref, ref)['ok']
    swapped = ref.copy()
    swapped[0, [0, 1]] = ref[0, [1, 0]]              # the order is free
    assert golden.dets_rule(swapped, ref)['ok']
    moved = ref.copy()
    moved[0, 2, :4] += 30                            # 2 of 3 pair: < ¾
    assert not golden.dets_rule(moved, ref)['ok']
    off = ref.copy()
    off[0, 0, 4] += 0.01                             # beyond a bf16 ulp
    assert not golden.dets_rule(off, ref)['ok']
