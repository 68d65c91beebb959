"""The port's evaluation path against the JAX package (CPU, float32, one CPU
thread): the K4 plain version against the JAX serving program's epilogue,
the protocol evaluator, the TFRecord / ``tf.train.Example`` readers, the
``--gt_boxes`` Regressor, and both ``objectron_eval`` CLIs end to end on the
same synthetic shards.

Tolerances and what they rest on:
- K4: keypoints 1e-6 (the same float32 sigmoid and TTA arithmetic), labels
  exact (bf16 logits with planted exact ties: the lower index wins on both
  sides), boxes 1e-4 px.
- Protocol on hand-made examples: reports byte-identical.  The examples are
  axis-aligned boxes with dyadic corners, so the float32 box axes and IoUs
  are exact in both packages.
- CLIs: the engines are the small pair of tests/test_torch_port_engine.py
  (SSD width 0.25, MNv3-large-21k at 64² crops, max_detections 4, class
  heads scaled, the JAX preprocessing at float32), on synthetic PNG shards
  of 2 categories × 3 examples at 240×320.  EPnP on a random network's
  keypoints is badly conditioned: the engines' 1e-5 keypoint differences
  and the 1e-4 differences of two float32 lifts move lifted metrics by up
  to 4e-2.  So each setting is checked twice.  Strict: the port CLI on the
  JAX engine's results and the JAX lift (its chunking, protocol, K5 and
  report against the JAX CLI's) records every metric within 1e-5 and the
  same hits and misses (no metric on the two sides of a threshold), and
  writes the same reports, the four full-precision "Mean" lines within
  1e-5.  End to end: the port CLI on its own engine and lift matches the
  same predictions to the same GT, with 2D errors within 1e-4 and lifted
  metrics in range.  And on well-conditioned predictions (GT keypoints
  plus 0.003 noise, fed to both CLIs): each CLI with its own lift,
  protocol and K5, the lifts within 3e-4 and every lifted metric within
  a tolerance derived from the two lifted boxes (metric_tolerances).
- CLIs from snapshots: both CLIs build their engines from
  ``--reg_config configs/scene_regressor_el0.py`` (cut to 64² crops,
  float32 and batch 2 by a config that executes it and overrides those
  three) and from ``--det_checkpoint`` / ``--reg_checkpoint``: snapshots
  the JAX package writes (the test detector and an EfficientNet-lite0
  regressor), converted by ``scripts/snapshot_to_torch.py`` for the port.
  The same two checks as ``test_cli_matches_jax``.
"""

import io
import os.path as osp
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudet3d.eval.protocol as jax_protocol
import tpudet3d.infer.engine as jax_engine_mod
import tpudet3d.infer.wrappers as jax_wrappers
from tpudet3d.core.crc32c import tfrecord_frame as jax_tfrecord_frame
from tpudet3d.infer import EngineConfig as JaxEngineConfig
from tpudet3d.infer import TwoStageEngine as JaxEngine
from tpudet3d.ops import geometry as jax_geometry
from tpudet3d.ops import image as jax_image

import tpudet3d_torch.eval.protocol as protocol
import tpudet3d_torch.tools.objectron_eval as port_cli
from tpudet3d_torch.core.crc32c import tfrecord_frame
from tpudet3d_torch.detect import SSDDetector
from tpudet3d_torch.infer import EngineConfig, TwoStageEngine
from tpudet3d_torch.infer.epilogue import (head_epilogue,
                                           head_epilogue_plain, sigmoid)
from tpudet3d_torch.infer.wrappers import Regressor
from tpudet3d_torch.models import build_model
from tpudet3d_torch.core import AttrDict as PortAttrDict
from tpudet3d_torch.ops import geometry
from tpudet3d_torch.ops.box3d import box_axes
from test_torch_port_engine import regressor_weights
from test_torch_port_engine import weights  # noqa: F401  (fixture)
from tpudet3d_torch.tools.cases import (K4_REFINE, box_kps, k4_error,
                                        k4_inputs, rotation)
from torch_port_common import (config_file, one_cpu_thread, port_of,
                               set_no_tf32)

SCRIPTS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                   'scripts')


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


# --- K4 ------------------------------------------------------------------

def jax_epilogue(pre, logits, boxes, tta_w, refine, dets, det_conf):
    """The JAX serving program's epilogue (wrapper.py:61-64, engine.py
    :270-276, :291-300 with tta_flip_average and refine_boxes)."""
    b = boxes.shape[0]
    b2 = pre.shape[0]
    all_kp = jax.nn.sigmoid(jnp.asarray(pre)).transpose(1, 0, 2).reshape(
        9, b2, 9, 2)
    logits = jnp.asarray(logits)
    if tta_w:
        all_kp, logits = jax_engine_mod.tta_flip_average(all_kp, logits, b,
                                                         tta_w)
    labels = jnp.argmax(logits, axis=-1)
    kp = all_kp[labels, jnp.arange(b)]
    if refine is not None:
        w, h, margin, grow = refine
        return np.asarray(jax_engine_mod.refine_boxes(
            kp, jnp.asarray(boxes), (w, h), margin, grow))
    scores = jnp.asarray(dets[:, 4])
    return np.asarray(jnp.concatenate([
        jnp.asarray(boxes), scores[:, None], jnp.asarray(dets[:, 5:6]),
        kp.reshape(b, 18), labels.astype(jnp.float32)[:, None],
        (scores > det_conf).astype(jnp.float32)[:, None]], axis=-1))


@pytest.mark.parametrize('mode', ['refine', 'pack'])
@pytest.mark.parametrize('tta', [False, True])
def test_k4_plain_matches_jax_epilogue(tta, mode):
    pre, logits, boxes, dets = k4_inputs(64, tta, seed=3)
    tta_w = 64 if tta else 0
    refine = K4_REFINE if mode == 'refine' else None
    kw = dict(tta_w=tta_w, refine=refine,
              dets=None if refine else torch.from_numpy(dets), det_conf=0.5)
    out = head_epilogue_plain(torch.from_numpy(pre),
                              torch.from_numpy(logits).bfloat16(),
                              torch.from_numpy(boxes), **kw).numpy()
    ref = jax_epilogue(pre, jnp.asarray(logits, jnp.bfloat16), boxes, tta_w,
                       refine, dets, 0.5)
    if refine:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
        assert np.all(out[:, 2:] >= out[:, :2] + 1.0)
        return
    np.testing.assert_allclose(out[:, 6:24], ref[:, 6:24], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[:, [0, 1, 2, 3, 4, 5, 24, 25]],
                                  ref[:, [0, 1, 2, 3, 4, 5, 24, 25]])
    assert (out[:, 25] == 0).any() and (out[:, 25] == 1).any()
    # the planted ties were real: several rows' maxima are shared
    lg = torch.from_numpy(logits).bfloat16().float()
    if tta:
        lg = (0.5 * (lg[:64].bfloat16() + lg[64:].bfloat16())).float()
    assert ((lg == lg.amax(1, keepdim=True)).sum(1) > 1).sum() >= 10


@pytest.mark.parametrize('mode', ['refine', 'pack'])
@pytest.mark.parametrize('tta', [False, True])
@pytest.mark.parametrize('b', [1, 127, 129])
def test_k4_plain_matches_jax_nan_ties(b, tta, mode):
    """Logits with NaNs and ties (cases.K4_SPECIAL_ROWS) at the crop
    counts where K4's last CTA is partly live: the labels are
    jnp.argmax's (the first NaN, else the first maximum), in bf16."""
    pre, logits, boxes, dets = k4_inputs(b, tta, seed=4, nan_ties=True)
    tta_w = 64 if tta else 0
    refine = K4_REFINE if mode == 'refine' else None
    kw = dict(tta_w=tta_w, refine=refine,
              dets=None if refine else torch.from_numpy(dets), det_conf=0.5)
    out = head_epilogue_plain(torch.from_numpy(pre),
                              torch.from_numpy(logits).bfloat16(),
                              torch.from_numpy(boxes), **kw).numpy()
    ref = jax_epilogue(pre, jnp.asarray(logits, jnp.bfloat16), boxes, tta_w,
                       refine, dets, 0.5)
    if refine:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
        return
    np.testing.assert_allclose(out[:, 6:24], ref[:, 6:24], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[:, [0, 1, 2, 3, 4, 5, 24, 25]],
                                  ref[:, [0, 1, 2, 3, 4, 5, 24, 25]])
    if b > 8:   # every pattern of logits appears, NaN labels among them
        assert set(out[:, 24].astype(int)) >= {0, 1, 3, 8}


@pytest.mark.parametrize('refine,col,delta,ok', [
    (True, 0, 1e-4, True), (True, 3, 2e-4, False),
    (False, 6, 1e-6, True), (False, 23, 2e-6, False),
    (False, 0, 1e-6, False), (False, 24, 1.0, False)])
def test_k4_error_tolerance(refine, col, delta, ok):
    """cases.k4_error, the one statement of K4's tolerance that the
    smoke, the card tests and k4_bench share: refine boxes within 1e-4 px;
    pack keypoints (columns 6-23) within 1e-6, every other column exact."""
    ref = torch.zeros(3, 4 if refine else 26)
    out = ref.clone()
    out[1, col] = delta
    err, within = k4_error(out, ref, refine)
    assert within == ok
    assert err == (pytest.approx(delta) if ok or 6 <= col < 24 or refine
                   else float('inf'))


def test_k4_sigmoid_and_wrapper_on_cpu():
    x = torch.linspace(-30, 30, 2001)
    torch.testing.assert_close(sigmoid(x), torch.sigmoid(x), rtol=0,
                               atol=1e-6)
    pre, logits, boxes, dets = (torch.from_numpy(a)
                                for a in k4_inputs(16, False))
    before = head_epilogue.launches
    out = head_epilogue(pre, logits, boxes, dets=dets)
    assert head_epilogue.launches == before          # plain on the CPU
    torch.testing.assert_close(out, head_epilogue_plain(pre, logits, boxes,
                                                        dets=dets))
    with pytest.raises(ValueError):
        head_epilogue(pre, logits, boxes)            # neither mode
    with pytest.raises(ValueError):
        head_epilogue(pre, logits, boxes, tta_w=64, dets=dets)


# --- protocol --------------------------------------------------------------

def square_kps(cx, cy, half=0.1):
    pts = [(cx, cy)]
    for sx in (-1, 1):
        for sy in (-1, 1):
            for _ in range(2):
                pts.append((cx + sx * half, cy + sy * half))
    return np.asarray(pts, np.float64)


def protocol_examples():
    """Hand-made examples: duplicates, an invisible GT, an unmatched
    prediction, no predictions, and a ground-plane rescale (every predicted
    box is the GT box at half scale).  Boxes are axis-aligned with dyadic
    corners."""
    half = np.full(3, 0.25)
    gt3d = [box_kps(np.array([0., -0.5, -2.]), half),
            box_kps(np.array([1., -0.5, -3.]), half),
            box_kps(np.array([-1., 0.5, -4.]), half)]
    gt2d = [square_kps(0.3, 0.5), square_kps(0.7, 0.5), square_kps(0.05, 0.05)]
    shifted = box_kps(np.array([1.15625, -0.5, -3.]), half)
    plane = (np.array([0., -0.75, -2.]), np.array([0., 1., 0.]))
    return [
        # duplicates of GT 0, a shifted match of GT 1, garbage that matches
        # the invisible GT 2 → sentinels; plane rescale of half-size preds
        dict(pred2d=[gt2d[0], gt2d[0] + 0.01, gt2d[1] + 0.03,
                     square_kps(0.02, 0.02, 0.01)],
             pred3d=[gt3d[0] * 0.5, gt3d[0] * 0.5, shifted * 0.5,
                     box_kps(np.array([5., 5., -9.]), half)],
             gt2d=gt2d, gt3d=gt3d, vis=np.array([1., 1., 0.]), plane=plane),
        # no predictions
        dict(pred2d=[], pred3d=[], gt2d=gt2d[:1], gt3d=gt3d[:1],
             vis=np.array([1.]), plane=None),
        # every GT invisible → skipped
        dict(pred2d=[gt2d[0]], pred3d=[gt3d[0]], gt2d=gt2d[:1],
             gt3d=gt3d[:1], vis=np.array([0.]), plane=None),
        # a box turned by 90° about z, without a plane
        dict(pred2d=[gt2d[1] - 0.02],
             pred3d=[box_kps(np.array([1., -0.5, -3.]),
                             np.array([0.25, 0.375, 0.25]),
                             np.array([[0., -1., 0.], [1., 0., 0.],
                                       [0., 0., 1.]]))],
             gt2d=gt2d[1:2], gt3d=gt3d[1:2], vis=np.array([1.]), plane=None),
    ]


def _run_protocol(evaluator, examples):
    for ex in examples:
        evaluator.evaluate_example(ex['pred2d'], ex['pred3d'], ex['gt2d'],
                                   ex['gt3d'], plane=ex['plane'],
                                   visibilities=ex['vis'])
    evaluator.finalize()
    buf = io.StringIO()
    evaluator.write_report('cup', buf)
    return buf.getvalue()


KINDS = ('iou', 'pixel', 'azimuth', 'polar', 'add', 'adds', 'iou_dedup',
         'add_dedup')
LIFTED = ('iou', 'azimuth', 'polar', 'add', 'adds', 'iou_dedup', 'add_dedup')


@pytest.fixture
def recorded(monkeypatch):
    """Every metric both evaluators record, in order: (port, jax) lists of
    (kind, thresholds, greater, metric).  ``evaluate_example`` makes its 8
    HitMiss accumulators in the order of KINDS."""
    logs = ([], [])
    for mod, log in zip((protocol, jax_protocol), logs):
        init, record = mod.HitMiss.__init__, mod.HitMiss.record_hit_miss
        made = [0]

        def new_init(self, thresholds, _init=init, _made=made):
            _init(self, thresholds)
            self.kind = KINDS[_made[0] % len(KINDS)]
            _made[0] += 1

        def new_record(self, metric, greater=True, _record=record, _log=log):
            _log.append((self.kind, self.thresholds, greater, float(metric)))
            return _record(self, metric, greater)

        monkeypatch.setattr(mod.HitMiss, '__init__', new_init)
        monkeypatch.setattr(mod.HitMiss, 'record_hit_miss', new_record)
    return logs


def _hits(t, m, greater):
    return m >= t if greater else m <= t


def assert_metrics_agree(port_log, jax_log, atol):
    """Same metrics in the same order, each within ``atol``, and no pair
    on the two sides of a threshold (a near-tie), so both sides record the
    same hits and misses and the AP arrays must be identical."""
    assert len(port_log) == len(jax_log) > 0
    for (k, t, g, m), (k_ref, t_ref, g_ref, m_ref) in zip(port_log, jax_log):
        assert (k, g) == (k_ref, g_ref)
        np.testing.assert_array_equal(t, t_ref)
        assert abs(m - m_ref) <= atol, (k, m, m_ref)
        np.testing.assert_array_equal(_hits(t, m, g), _hits(t, m_ref, g),
                                      err_msg=f'{k}: {m} vs {m_ref}')


def assert_reports_agree(text, ref, mean_atol):
    lines, ref_lines = text.splitlines(), ref.splitlines()
    assert len(lines) == len(ref_lines)
    for line, ref_line in zip(lines, ref_lines):
        if line.startswith('Mean ') and line != ref_line:
            key, _, val = line.partition(': ')
            ref_key, _, ref_val = ref_line.partition(': ')
            assert key == ref_key
            assert abs(float(val) - float(ref_val)) <= mean_atol, \
                (line, ref_line)
        else:
            assert line == ref_line


def test_protocol_reports_byte_identical(recorded):
    text = _run_protocol(protocol.ObjectronProtocolEvaluator(device='cpu'),
                         protocol_examples())
    ref = _run_protocol(jax_protocol.ObjectronProtocolEvaluator(),
                        protocol_examples())
    assert_metrics_agree(*recorded, atol=0.0)
    assert text == ref
    assert 'matched 4/' in text


def test_protocol_batches_k5_per_example(monkeypatch):
    calls = []
    kernel = protocol.iou_oriented_boxes

    def iou_fn(a, b):
        calls.append(a.shape[0])
        return kernel(a, b)

    monkeypatch.setattr(protocol, 'iou_oriented_boxes', iou_fn)
    ev = protocol.ObjectronProtocolEvaluator(device='cpu')
    _run_protocol(ev, protocol_examples())
    # one call per example with a matched prediction, all its pairs at once
    assert calls == [3, 1]
    assert ev.num_examples == 4 and ev.iou_seconds > 0


def test_geometry_helpers_match_jax():
    rng = np.random.RandomState(11)
    for _ in range(8):
        box = box_kps(np.r_[rng.uniform(-1, 1, 2), rng.uniform(-4, -1)],
                      rng.uniform(0.1, 0.6, 3),
                      rotation(rng.uniform(-np.pi, np.pi, 3)))
        gt = box_kps(box[0] + rng.normal(0, 0.05, 3), rng.uniform(0.1, 0.6, 3),
                     rotation(rng.uniform(-np.pi, np.pi, 3)))
        for a, b in zip(protocol.fit_box(box), jax_protocol.fit_box(box)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        np.testing.assert_allclose(protocol.viewpoint_errors(box, gt),
                                   jax_protocol.viewpoint_errors(box, gt),
                                   rtol=0, atol=1e-3)
        plane = (np.array([0., -1., -2.]), np.array([0., 1., 0.]))
        assert protocol.compute_scale(box, plane) == \
            jax_protocol.compute_scale(box, plane)
    a, b = square_kps(0.3, 0.4), square_kps(0.35, 0.42, 0.15)
    assert protocol.iou_2d_extents(a, b) == jax_protocol.iou_2d_extents(a, b)
    assert protocol.match_box(a, [b, a], [1., 1.]) == \
        jax_protocol.match_box(a, [b, a], [1., 1.]) == 1


# --- TFRecord / Example ----------------------------------------------------

def _varint(v):
    out = b''
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _feature_bytes(vals):
    inner = b''.join(_varint(1 << 3 | 2) + _varint(len(v)) + v for v in vals)
    return _varint(1 << 3 | 2) + _varint(len(inner)) + inner


def _feature_floats(vals):
    packed = struct.pack(f'<{len(vals)}f', *vals)
    inner = _varint(1 << 3 | 2) + _varint(len(packed)) + packed
    return _varint(2 << 3 | 2) + _varint(len(inner)) + inner


def _feature_ints(vals):
    inner = b''.join(_varint(1 << 3 | 0) + _varint(v) for v in vals)
    return _varint(3 << 3 | 2) + _varint(len(inner)) + inner


def make_example(features):
    body = b''
    for key, feat in features.items():
        kb = key.encode()
        entry = _varint(1 << 3 | 2) + _varint(len(kb)) + kb
        entry += _varint(2 << 3 | 2) + _varint(len(feat)) + feat
        body += _varint(1 << 3 | 2) + _varint(len(entry)) + entry
    return _varint(1 << 3 | 2) + _varint(len(body)) + body


def eval_example(rng, height=240, width=320, n_objects=2):
    """One Objectron eval-shard Example: a PNG frame, GT boxes 1.5-3 m in
    front of the default camera with their 2D points projected through
    ``project_3d_points`` (portrait screen coordinates), visibility 1 and
    a plane facing the camera at 2 m.  (A plane whose normal is the
    camera axis keeps the scale recovery stable: every vertex of a lifted
    box has z < 0, while a ground-plane normal would divide by vertex
    heights near 0.)"""
    import cv2 as cv
    img = rng.randint(0, 255, (height, width, 3)).astype(np.uint8)
    cam = geometry.convert_camera_matrix_2_ndc(
        geometry.get_default_camera_matrix())
    kps2d, kps3d = [], []
    for _ in range(n_objects):
        box = box_kps(np.r_[rng.uniform(-0.3, 0.3, 2), rng.uniform(-3, -1.5)],
                      rng.uniform(0.15, 0.4, 3),
                      rotation(rng.uniform(-np.pi, np.pi, 3)))
        uv = geometry.project_3d_points(box, cam)
        xy = np.stack([(uv[:, 1] + 1) / 2, (uv[:, 0] + 1) / 2], -1)
        x0, y0 = (xy.min(0) * [width, height]).astype(int).clip(0)
        x1, y1 = (xy.max(0) * [width, height]).astype(int)
        img[y0:y1, x0:x1] = rng.randint(0, 255, 3)        # a flat object
        kps2d.append(np.concatenate([xy, -box[:, 2:]], -1))
        kps3d.append(box)
    ok, enc = cv.imencode('.png', img)
    assert ok
    return make_example({
        'image/encoded': _feature_bytes([enc.tobytes()]),
        'point_2d': _feature_floats(np.ravel(kps2d).tolist()),
        'point_3d': _feature_floats(np.ravel(kps3d).tolist()),
        'instance_num': _feature_ints([n_objects]),
        'object/visibility': _feature_floats([1.0] * n_objects),
        'plane/center': _feature_floats([0., 0., -2.]),
        'plane/normal': _feature_floats([0., 0., 1.]),
    }), img


def _jax_cli():
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import demo
    import objectron_eval
    return demo, objectron_eval


def test_tfrecord_example_roundtrip(tmp_path):
    rng = np.random.RandomState(12)
    payloads, images = zip(*(eval_example(rng, n_objects=1 + i)
                             for i in range(2)))
    framed = [tfrecord_frame(p) for p in payloads]
    assert framed == [jax_tfrecord_frame(p) for p in payloads]
    path = tmp_path / 'shard'
    path.write_bytes(b''.join(framed))
    for verify in (False, True):
        records = list(protocol.read_tfrecord(str(path), verify_crc=verify))
        assert records == list(payloads)
        assert records == list(jax_protocol.read_tfrecord(str(path), verify))
    _, jax_cli = _jax_cli()
    for payload, image in zip(payloads, images):
        assert protocol.parse_example(payload) == \
            jax_protocol.parse_example(payload)
        out, ref = port_cli.decode_example(payload), \
            jax_cli.decode_example(payload)
        np.testing.assert_array_equal(out[0], image)          # lossless
        for o, r in zip(out[:4] + out[4], ref[:4] + ref[4]):
            np.testing.assert_array_equal(o, r)
    # a corrupted data CRC and a corrupted length CRC
    for offset in (len(framed[0]) - 1, 9):
        bad = bytearray(path.read_bytes())
        bad[offset] ^= 0xFF
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match='CRC'):
            list(protocol.read_tfrecord(str(path), verify_crc=True))
        with pytest.raises(ValueError, match='CRC'):
            list(jax_protocol.read_tfrecord(str(path), verify_crc=True))
        path.write_bytes(b''.join(framed))


# --- the CLIs end to end ---------------------------------------------------

CLASSES = ('bike', 'book')


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp('records')
    rng = np.random.RandomState(13)
    for cls in CLASSES:
        (root / cls).mkdir()
        (root / cls / 'shard-000').write_bytes(b''.join(
            tfrecord_frame(eval_example(rng, n_objects=1 + i % 2)[0])
            for i in range(3)))
    return root


def _config(kw):
    """The engine settings that ``build_engine`` gets from the CLI, on the
    small test engines."""
    return dict(crop_size=(64, 64), max_detections=4, crop_margin_px=10.0,
                det_conf=kw['det_conf'], refine_passes=kw['refine_passes'],
                refine_margin_px=kw['refine_margin_px'],
                score_thr=kw['score_thr'],
                soft_nms_sigma=kw['soft_nms_sigma'],
                soft_nms_dup_iou=kw['soft_nms_dup_iou'],
                box_vote_iou=kw['box_vote_iou'],
                host_downscale=kw['host_downscale'], tta_flip=kw['tta_flip'])


class _RecordingJaxEngine(JaxEngine):
    """The JAX engine, keeping every result it returns in ``results``."""

    results = None

    def infer_batch(self, frames):
        self.results.append(super().infer_batch(frames))
        return self.results[-1]

    def __call__(self, frame):
        self.results.append(super().__call__(frame))
        return self.results[-1]


class _Replay:
    """Stands in for the port's engine: returns, in order, the results the
    JAX engine gave in the JAX CLI's run."""

    def __init__(self, cfg, results):
        self.cfg = cfg
        self.device = torch.device('cpu')
        self._results = iter(results)

    def infer_batch(self, frames):
        return next(self._results)

    def __call__(self, frame):
        return next(self._results)


def _f32_jax_preprocess(monkeypatch):
    """The JAX serving program's two preprocessing calls at float32."""
    resize, crop = jax_image.resize_bilinear, jax_image.crop_and_resize
    monkeypatch.setattr(jax_engine_mod, 'resize_bilinear',
                        lambda img, hw, dtype=None: resize(img, hw,
                                                           jnp.float32))
    monkeypatch.setattr(jax_engine_mod, 'crop_and_resize',
                        lambda img, boxes, hw: crop(img, boxes, hw,
                                                    compute_dtype=jnp.float32))
    monkeypatch.setattr(jax_wrappers, 'crop_and_resize',
                        lambda img, boxes, hw: crop(img, boxes, hw,
                                                    compute_dtype=jnp.float32))


@pytest.fixture
def cli_engines(weights, monkeypatch):  # noqa: F811
    """Both CLIs build the small test engines from their flags; the JAX
    preprocessing runs at float32.  Returns the JAX CLI module and the list
    of the JAX engine's results."""
    det, dv, reg, rv = weights
    demo, jax_cli = _jax_cli()
    _f32_jax_preprocess(monkeypatch)
    results = []

    def jax_engine(*a, **kw):
        engine = _RecordingJaxEngine(
            det, jax.tree_util.tree_map(jnp.asarray, dv), reg,
            jax.tree_util.tree_map(jnp.asarray, rv),
            JaxEngineConfig(**_config(kw)))
        engine.results = results
        return engine

    def port_engine(*a, **kw):
        assert kw['device'] == 'cpu'
        return TwoStageEngine(
            port_of(SSDDetector(num_classes=9, width_mult=0.25), dv),
            port_of(build_model(PortAttrDict(model=dict(
                name='mobilenetv3_large_21k', num_classes=9, bf16=False))),
                rv), EngineConfig(**_config(kw)), device='cpu')

    monkeypatch.setattr(demo, 'build_engine', jax_engine)
    monkeypatch.setattr(port_cli, 'build_engine', port_engine)
    return jax_cli, results


def _reports(root):
    return [(root / f'report_{c}.txt').read_text() for c in CLASSES]


def _run_jax_cli(jax_cli, shards, out, monkeypatch, flags):
    args = ['objectron_eval.py', '--eval_data', str(shards), '--classes',
            *CLASSES, '--batch', '4', *flags, '--report_dir', str(out)]
    with monkeypatch.context() as m:
        m.setattr(sys, 'argv', args)
        jax_cli.main()
    return _reports(out)


def _run_port_cli(shards, out, monkeypatch, flags, replay=None):
    """The port CLI on its own engine and lift, or with ``replay`` (the JAX
    engine's results) on those results and the JAX program's lift."""
    with monkeypatch.context() as m:
        if replay is not None:
            build = port_cli.build_engine
            m.setattr(port_cli, 'build_engine', lambda *a, **kw: _Replay(
                build(*a, **kw).cfg, replay))
            m.setattr(port_cli, 'lift_2d_batched', lambda kp, portrait:
                      torch.from_numpy(np.array(jax_geometry.lift_2d_batched(
                          jnp.asarray(kp.numpy()), portrait=portrait))))
        port_cli.main(['--eval_data', str(shards), '--classes', *CLASSES,
                       '--batch', '4', *flags, '--report_dir', str(out),
                       '--device', 'cpu'])
    return _reports(out)


def assert_pipeline_close(port_log, jax_log, reports, ref_reports):
    """Port engine and lift against the JAX ones: the same predictions
    matched to the same GT and 2D errors within 1e-4 (they are linear in
    the keypoints, which the engines hold to 1e-4).  The lifted metrics
    are checked for range only: EPnP on a random network's keypoints is
    badly conditioned, and the two float32 lifts are 1e-4 apart before
    that."""
    assert [(k, g) for k, _, g, _ in port_log] == \
        [(k, g) for k, _, g, _ in jax_log]
    assert len(port_log) > 0
    for (k, _, _, m), (_, _, _, m_ref) in zip(port_log, jax_log):
        assert np.isfinite(m)
        if k == 'pixel':
            assert abs(m - m_ref) <= 1e-4, (m, m_ref)
        elif k.startswith('iou'):
            assert 0.0 <= m <= 1.0
    for text, ref in zip(reports, ref_reports):
        lines, ref_lines = text.splitlines(), ref.splitlines()
        assert lines[0] == ref_lines[0]                     # matched n/m
        assert abs(float(lines[1].split(': ')[1])
                   - float(ref_lines[1].split(': ')[1])) <= 1e-4


@pytest.mark.parametrize('flags', [['--det_tresh', '0'],
                                   ['--preset', 'recall']],
                         ids=['default', 'recall'])
def test_cli_matches_jax(cli_engines, shards, tmp_path, monkeypatch,
                         recorded, flags):
    """Strict: the port CLI on the JAX engine's results and lift gives the
    JAX CLI's metrics to 1e-5 and its reports.  End to end: the port CLI on
    its own engine and lift (see assert_pipeline_close)."""
    jax_cli, results = cli_engines
    port_log, jax_log = recorded
    ref = _run_jax_cli(jax_cli, shards, tmp_path / 'jax', monkeypatch, flags)
    assert sum(k == 'iou' for k, _, _, _ in jax_log) >= 6
    strict = _run_port_cli(shards, tmp_path / 'strict', monkeypatch, flags,
                           replay=results)
    assert_metrics_agree(port_log, jax_log, atol=1e-5)
    for text, ref_text in zip(strict, ref):
        assert_reports_agree(text, ref_text, mean_atol=1e-5)
    port_log.clear()
    own = _run_port_cli(shards, tmp_path / 'own', monkeypatch, flags)
    assert_pipeline_close(port_log, jax_log, own, ref)


@pytest.fixture(scope='module')
def el0_snapshots(weights, tmp_path_factory):  # noqa: F811
    """The el0 config cut to the test's size, and orbax snapshots of the
    test detector and of an EfficientNet-lite0 regressor, written by the
    JAX package and converted for the port."""
    import optax
    from tpudet3d.core import read_py_config
    from tpudet3d.detect.train import create_detector_state
    from tpudet3d.train.pipeline import setup_training
    from tpudet3d.utils.checkpoint import save_snap
    sys.path.insert(0, SCRIPTS)
    import snapshot_to_torch

    root = tmp_path_factory.mktemp('el0_snaps')
    det, dv, _, _ = weights
    state = create_detector_state(det, optax.sgd(0.1), jax.random.PRNGKey(0))
    save_snap(state.replace(params=dv['params'],
                            batch_stats=dv['batch_stats']), 1,
              str(root / 'det'))
    cfg = config_file(root / 'scene_regressor_el0_64.py',
                      'scene_regressor_el0.py', "model['bf16'] = False",
                      "data['resize'] = (64, 64)",
                      "data['train_batch_size'] = 2",
                      f"output_dir = {str(root / 'unused')!r}")
    _, rv = regressor_weights('efficientnet-lite0', seed=13)
    state = setup_training(read_py_config(cfg),
                           with_loaders=False).state
    save_snap(state.replace(params=rv['params'],
                            batch_stats=rv['batch_stats']), 2,
              str(root / 'reg'))
    for d in ('det', 'reg'):
        snapshot_to_torch.main(['--all', str(root / d)])
    return cfg, str(root / 'det' / 'snap_1'), str(root / 'reg' / 'snap_2')


def test_cli_el0_snapshots_match_jax(el0_snapshots, shards, tmp_path,
                                     monkeypatch, recorded):
    """Both CLIs from the el0 config and the snapshots, each through its
    own ``build_engine`` (the detectors at float32): strict on the JAX
    engine's results and lift, then end to end."""
    import tpudet3d.detect as jax_detect
    import tpudet3d_torch.infer.build as port_build
    cfg, det_snap, reg_snap = el0_snapshots
    demo, jax_cli = _jax_cli()
    _f32_jax_preprocess(monkeypatch)
    load, port_load = jax_detect.load_detector, port_build.load_detector
    monkeypatch.setattr(jax_detect, 'load_detector', lambda path, dtype:
                        load(path, dtype=jnp.float32))
    monkeypatch.setattr(port_build, 'load_detector', lambda path, **kw:
                        port_load(path, **dict(kw, dtype=torch.float32)))
    results = []

    class Recording(_RecordingJaxEngine):
        pass

    Recording.results = results
    monkeypatch.setattr(demo, 'TwoStageEngine', Recording)
    flags = ['--det_tresh', '0', '--reg_config', cfg, '--det_checkpoint',
             det_snap, '--reg_checkpoint', reg_snap]
    port_log, jax_log = recorded
    ref = _run_jax_cli(jax_cli, shards, tmp_path / 'jax', monkeypatch, flags)
    assert sum(k == 'iou' for k, _, _, _ in jax_log) >= 6
    strict = _run_port_cli(shards, tmp_path / 'strict', monkeypatch, flags,
                           replay=results)
    assert_metrics_agree(port_log, jax_log, atol=1e-5)
    for text, ref_text in zip(strict, ref):
        assert_reports_agree(text, ref_text, mean_atol=1e-5)
    port_log.clear()
    built = []
    monkeypatch.setattr(port_cli, 'build_engine', lambda *a, **kw:
                        built.append(port_build.build_engine(*a, **kw))
                        or built[-1])
    own = _run_port_cli(shards, tmp_path / 'own', monkeypatch, flags)
    assert type(built[0].reg_model.backbone).__name__ == 'EfficientNetLite'
    assert built[0].cfg.crop_size == (64, 64)
    assert_pipeline_close(port_log, jax_log, own, ref)


class _KeyedReplay:
    """Stands in for either CLI's engine: the results stored under each
    frame's bytes."""

    def __init__(self, table):
        self.cfg = EngineConfig()
        self.device = torch.device('cpu')
        self._table = table

    def infer_batch(self, frames):
        return [self._table[f.tobytes()] for f in frames]

    def __call__(self, frame):
        return self._table[frame.tobytes()]


def gt_predictions(shards, noise, seed):
    """Engine results for every frame of the shards: the GT keypoints plus
    Gaussian noise, one prediction per GT and a second one of the first
    GT, on full-frame boxes; keyed by the decoded frame's bytes."""
    rng = np.random.RandomState(seed)
    table = {}
    for path in sorted(shards.glob('*/shard-*')):
        for payload in protocol.read_tfrecord(str(path)):
            image, gt2d = port_cli.decode_example(payload)[:2]
            kp = np.concatenate([gt2d, gt2d[:1]])
            kp = (kp + rng.normal(0, noise, kp.shape)).astype(np.float32)
            h, w = image.shape[:2]
            table[image.tobytes()] = {
                'boxes': np.tile(np.float32([0, 0, w, h]), (len(kp), 1)),
                'kp': kp}
    return table


def _per_prediction(log):
    """A recorded log as one ``{kind: (thresholds, greater, metric)}`` per
    prediction (each prediction's records start with its 3D IoU)."""
    preds = []
    for kind, t, g, m in log:
        if kind == 'iou':
            preds.append({})
        preds[-1][kind] = (t, g, m)
    return preds


def metric_tolerances(port_box, jax_box, plane):
    """How far each lifted metric of one matched prediction may move between
    the packages, from the largest distance D between their lifted boxes
    after the ground-plane rescale.  EPnP lifts are exact parallelepipeds,
    so no point of the box moves farther than D.  ADD and ADD-S move by at
    most D (each is 1-Lipschitz in every vertex).  To first order the 3D
    IoU moves by at most 3·D·A/V (A and V the box's surface and volume:
    the intersection moves by at most D·A and the union by 2·D·A), plus
    1e-5 for the float32 IoUs.  Each viewpoint angle moves by at most
    |Δv|/r, v = Rᵀc being the ray to the box centre c in box axes, with
    |Δv| <= |(2·D·|c|/|e_k| + D)_k| (the unit axes turn by 2·D/|e_k|, e_k
    the half-axes) and r = |v| for the polar angle and the length of v in
    the x-z plane for the azimuth, plus 1e-3° for ``fit_box``'s float32
    axes.  The first-order terms are doubled; the 2D error is the same."""
    a, b = (box * protocol.compute_scale(box, plane)
            for box in (port_box, jax_box))
    d = float(np.linalg.norm(a - b, axis=-1).max())
    center, axes = (x.numpy().astype(np.float64) for x in
                    box_axes(torch.from_numpy(a)))
    half = np.linalg.norm(axes, axis=-1)
    area = 8 * sum(np.linalg.norm(np.cross(axes[i], axes[j]))
                   for i, j in ((0, 1), (1, 2), (2, 0)))
    volume = 8 * abs(np.linalg.det(axes))
    v = (axes / half[:, None]) @ center
    dv = np.linalg.norm(2 * d * np.linalg.norm(center) / half + d)
    iou = 2 * 3 * d * area / volume + 1e-5
    return dict(pixel=0.0, add=d + 1e-9, adds=d + 1e-9, add_dedup=d + 1e-9,
                iou=iou, iou_dedup=iou,
                azimuth=2 * np.degrees(dv / np.hypot(v[0], v[2])) + 1e-3,
                polar=2 * np.degrees(dv / np.linalg.norm(v)) + 1e-3)


MEAN_LINES = {'Mean Error 2D': 'pixel', 'Mean 3D IoU': 'iou',
              'Mean Azimuth Error': 'azimuth', 'Mean Polar Error': 'polar'}
AP_LINES = {'AP @3D IoU': 'iou', 'AP @2D Pixel': 'pixel',
            'AP @Azimuth': 'azimuth', 'AP @Polar': 'polar', 'AP @ADD': 'add',
            'AP @ADDS': 'adds', 'AP Dedup @3D IoU': 'iou_dedup',
            'AP Dedup @ADD': 'add_dedup'}


def test_cli_own_lift_matches_jax_on_gt_predictions(shards, tmp_path,
                                                     monkeypatch, recorded):
    """Both CLIs on the same well-conditioned predictions (the shards' GT
    keypoints plus 0.003 noise, with a duplicate per example), each with
    its own lift, protocol and K5.  The float32 lifts agree within 3e-4,
    the bound of test_lift_matches_jax; the 2D errors are equal; every
    lifted metric agrees within the tolerance that metric_tolerances
    derives from the two lifted boxes, and records the same hits and misses
    unless it lies within that tolerance of a threshold.  The reports
    agree: each "Mean" line within the largest tolerance of its metric,
    every other line identical, an AP line excepted only for a metric with
    such a near-tie."""
    demo, jax_cli = _jax_cli()
    table = gt_predictions(shards, 0.003, seed=15)
    lifts = ([], [])
    for module, out in zip((port_cli, jax_cli), lifts):
        lift = module.lift_2d_batched

        def recording(kp, portrait, _lift=lift, _out=out):
            res = _lift(kp, portrait=portrait)
            _out.append(np.array(res, np.float64))
            return res

        monkeypatch.setattr(module, 'lift_2d_batched', recording)
        monkeypatch.setattr(demo if module is jax_cli else module,
                            'build_engine',
                            lambda *a, **kw: _KeyedReplay(table))
    flags = ['--det_tresh', '0']
    ref = _run_jax_cli(jax_cli, shards, tmp_path / 'jax', monkeypatch, flags)
    own = _run_port_cli(shards, tmp_path / 'own', monkeypatch, flags)

    port_lift, jax_lift = (np.concatenate(x) for x in lifts)
    np.testing.assert_allclose(port_lift, jax_lift, rtol=0, atol=3e-4)
    port_preds, jax_preds = (_per_prediction(log) for log in recorded)
    assert len(port_preds) == len(jax_preds) == len(port_lift) == sum(
        len(r['kp']) for r in table.values())
    plane = (np.array([0., 0., -2.]), np.array([0., 0., 1.]))
    tols = [metric_tolerances(p, j, plane)
            for p, j in zip(port_lift, jax_lift)]
    near = set()
    for pred, pred_ref, tol in zip(port_preds, jax_preds, tols):
        assert pred.keys() == pred_ref.keys()
        for kind, (t, g, m) in pred.items():
            m_ref = pred_ref[kind][2]
            assert abs(m - m_ref) <= tol[kind], (kind, m, m_ref, tol[kind])
            if m != m_ref and np.abs(t - m_ref).min() <= tol[kind]:
                near.add(kind)
            else:
                np.testing.assert_array_equal(_hits(t, m, g),
                                              _hits(t, m_ref, g))
    # real overlaps (boxes far from the plane's depth are rescaled off
    # their GT and score exact zeros on both sides)
    assert sum(p['iou'][2] > 0.5 for p in jax_preds) >= 5
    for text, ref_text in zip(own, ref):
        lines, ref_lines = text.splitlines(), ref_text.splitlines()
        assert len(lines) == len(ref_lines)
        for line, ref_line in zip(lines, ref_lines):
            key = line.split(':')[0].strip()
            if key in MEAN_LINES:
                tol = max(t[MEAN_LINES[key]] for t in tols)
                assert abs(float(line.split(': ')[1])
                           - float(ref_line.split(': ')[1])) <= tol, line
            elif AP_LINES.get(key) not in near:
                assert line == ref_line


def test_cli_gt_boxes_matches_jax(cli_engines, shards, tmp_path,
                                  monkeypatch, recorded):
    """--gt_boxes: the port CLI's Regressor (K2 f32 + K4) and lift against
    the JAX CLI's, end to end."""
    flags = ['--det_tresh', '0', '--gt_boxes']
    ref = _run_jax_cli(cli_engines[0], shards, tmp_path / 'jax', monkeypatch,
                       flags)
    own = _run_port_cli(shards, tmp_path / 'own', monkeypatch, flags)
    assert_pipeline_close(*recorded, own, ref)


def test_regressor_matches_jax(weights, cli_engines):  # noqa: F811
    det, dv, reg, rv = weights
    frame = np.random.RandomState(14).randint(0, 256, (240, 320, 3)) \
        .astype(np.uint8)
    dets = [(10.5, 20.0, 110.0, 200.0, 1.0, 0), (0.0, 0.0, 320.0, 240.0,
                                                  1.0, 0),
            (200.0, 100.0, 230.5, 131.0, 1.0, 0)]
    ref = jax_wrappers.Regressor(reg, jax.tree_util.tree_map(jnp.asarray, rv),
                                 crop_size=(64, 64)).get_detections(frame,
                                                                    dets)
    port_reg = port_of(build_model(PortAttrDict(model=dict(
        name='mobilenetv3_large_21k', num_classes=9, bf16=False))), rv)
    out = Regressor(port_reg, crop_size=(64, 64),
                    device='cpu').get_detections(frame, dets)
    assert len(out) == len(ref) == 3
    for (kp, label), (kp_ref, label_ref) in zip(out, ref):
        assert label == int(label_ref)
        np.testing.assert_allclose(kp, np.asarray(kp_ref), rtol=0, atol=1e-4)
    assert Regressor(port_reg, device='cpu').get_detections(frame, []) == []


def test_cli_unported_and_invalid_flags(cli_engines, shards, tmp_path):
    """--gt_boxes bypasses the engine, so --int8 and --tta_flip are refused
    beside it, as the JAX CLI asserts (--int8 itself is served:
    tests/test_torch_port_quant.py)."""
    for flag in ('--int8', '--tta_flip'):
        with pytest.raises(ValueError, match=flag[2:]):
            port_cli.main(['--eval_data', str(shards), '--gt_boxes', flag,
                           '--device', 'cpu', '--report_dir', str(tmp_path)])
    with pytest.raises(ValueError, match='calibration frames'):
        port_cli.main(['--eval_data', str(tmp_path), '--int8', '--classes',
                       'bike', '--device', 'cpu', '--report_dir',
                       str(tmp_path)])
