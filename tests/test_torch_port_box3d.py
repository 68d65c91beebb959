"""The port's K5 plain version, EPnP lift and batched metrics against the
JAX package (CPU, float32, one CPU thread).

Inputs are numpy arrays made from seeds and fed to both packages.
Tolerances: K5 1e-5 absolute against JAX (both float32; the JAX program
computes determinants by LU and sums in XLA's order, the port spells them
out) and 1e-4 against the independent scipy halfspace intersection
(float64, on the host); the float64 host lifts equal to 1e-12.

The float32 lift is the eigenvector of the near-null eigenvalue of a
12×12 float32 system.  Each float32 eigensolver (XLA's, LAPACK's under
PyTorch) lands within about 1e-4 of the float64 lift (1.04e-4 at worst
over 640 sets measured), so the two agree to 1.3e-4 at worst, not 1e-4:
the lift test holds each side within 2e-4 of the float64 lift and the
two within 3e-4 of each other, after both are sign-fixed.  A box
coordinate moved by 1e-4 moves a 3D IoU by up to 1e-3, so the metric
tests feed the JAX lift to both packages and compare every metric to
1e-5; the unpatched run compares ADD, SADD and accuracy to 1e-5 and the
IoU terms to 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet3d.eval import metrics as jax_metrics
from tpudet3d.ops import box3d as jax_box3d
from tpudet3d.ops import geometry as jax_geometry

from tpudet3d_torch.eval import metrics
from tpudet3d_torch.ops import box3d, geometry
from chip_smoke import (box_kps, k5_exact_cases, k5_fuzz_pairs,
                                     rotation)
from torch_port_common import one_cpu_thread, set_no_tf32


@pytest.fixture(autouse=True)
def _cpu_settings():
    set_no_tf32()
    with one_cpu_thread():
        yield


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize('case', [c[0] for c in k5_exact_cases()])
def test_k5_plain_exact_cases_match_jax(case):
    _, b1, b2, want = next(c for c in k5_exact_cases() if c[0] == case)
    ref = float(jax_box3d.iou_oriented_boxes(jnp.asarray(b1),
                                             jnp.asarray(b2)))
    out = float(box3d.iou_oriented_boxes_plain(_t(b1), _t(b2)))
    assert abs(out - ref) <= 1e-5
    assert abs(out - want) <= 1e-5


def test_k5_plain_fuzz_matches_jax():
    a, b = k5_fuzz_pairs(256, seed=1)
    ref = np.asarray(jax_box3d.iou_oriented_boxes(a, b))
    out = box3d.iou_oriented_boxes_plain(_t(a), _t(b)).numpy()
    assert (ref > 0.01).mean() > 0.5          # mostly overlapping pairs
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('p', [1, 129])
def test_k5_plain_matches_jax_pair_counts(p):
    """One pair, and one more than a full 128: the pair counts at which K5's
    launch has a lone CTA or a ragged last one."""
    a, b = k5_fuzz_pairs(p, seed=p)
    ref = np.asarray(jax_box3d.iou_oriented_boxes(a, b))
    out = box3d.iou_oriented_boxes_plain(_t(a), _t(b)).numpy()
    assert out.shape == (p,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_k5_plain_matches_scipy():
    a, b = k5_fuzz_pairs(32, seed=2)
    out = box3d.iou_oriented_boxes_plain(_t(a), _t(b)).numpy()
    host = np.array([box3d.iou_single_host(x, y) for x, y in zip(a, b)])
    ref = np.array([jax_box3d.iou_single_host(x, y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(host, ref)
    np.testing.assert_allclose(out, host, rtol=0, atol=1e-4)


def test_k5_wrapper_batch_shapes():
    a, b = k5_fuzz_pairs(6, seed=3)
    flat = box3d.iou_oriented_boxes(_t(a), _t(b))
    grid = box3d.iou_oriented_boxes(_t(a).reshape(2, 3, 9, 3),
                                    _t(b).reshape(2, 3, 9, 3))
    assert grid.shape == (2, 3)
    np.testing.assert_array_equal(grid.reshape(-1).numpy(), flat.numpy())
    mat = box3d.pairwise_iou_oriented_boxes(_t(a[:2]), _t(b[:3]))
    ref = np.asarray(jax_box3d.pairwise_iou_oriented_boxes(
        jnp.asarray(a[:2]), jnp.asarray(b[:3])))
    assert mat.shape == (2, 3)
    np.testing.assert_allclose(mat.numpy(), ref, rtol=0, atol=1e-5)
    assert box3d.iou_oriented_boxes(_t(a[:0]), _t(b[:0])).shape == (0,)


def test_box_axes_and_volume_match_jax():
    a, _ = k5_fuzz_pairs(16, seed=4)
    c_ref, ax_ref = jax_box3d.box_axes(jnp.asarray(a))
    c, ax = box3d.box_axes(_t(a))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-6)
    np.testing.assert_allclose(ax.numpy(), np.asarray(ax_ref), atol=1e-6)
    np.testing.assert_allclose(box3d.box_volume(ax).numpy(),
                               np.asarray(jax_box3d.box_volume(ax_ref)),
                               rtol=1e-5)


def projected_keypoints(n, portrait, noise, seed):
    """2D keypoints [n,9,2] in [0,1] screen coordinates of random boxes
    1.5-3 m in front of the default camera, plus Gaussian noise."""
    rng = np.random.RandomState(seed)
    cam = geometry.convert_camera_matrix_2_ndc(
        geometry.get_default_camera_matrix())
    out = []
    for _ in range(n):
        box = box_kps(np.r_[rng.uniform(-0.4, 0.4, 2), rng.uniform(-3, -1.5)],
                      rng.uniform(0.1, 0.5, 3),
                      rotation(rng.uniform(-np.pi, np.pi, 3)))
        uv = geometry.project_3d_points(box, cam)
        if portrait:
            xy = np.stack([(uv[:, 1] + 1) / 2, (uv[:, 0] + 1) / 2], -1)
        else:
            xy = np.stack([(uv[:, 0] + 1) / 2, (1 - uv[:, 1]) / 2], -1)
        out.append(xy + noise * rng.normal(size=xy.shape))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize('portrait', [True, False])
def test_lift_matches_jax(portrait):
    kps = np.concatenate([projected_keypoints(32, portrait, 0.0, 5),
                          projected_keypoints(32, portrait, 0.003, 6)])
    ref = np.asarray(jax_geometry.lift_2d_batched(jnp.asarray(kps),
                                                  portrait=portrait))
    out = geometry.lift_2d_batched(torch.from_numpy(kps), portrait=portrait)
    assert out.dtype == torch.float32 and out.shape == (64, 9, 3)
    # both sign-fixed: every box in front of the camera
    assert np.all(ref[:, 0, 2] < 0) and np.all(out.numpy()[:, 0, 2] < 0)
    host = geometry._lift_host(kps.astype(np.float64),
                               geometry.get_default_camera_matrix(), portrait)
    host_ref = jax_geometry._lift_host(
        kps.astype(np.float64), jax_geometry.get_default_camera_matrix(),
        portrait)
    np.testing.assert_allclose(host, host_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(out.numpy(), host, rtol=0, atol=2e-4)
    np.testing.assert_allclose(ref, host, rtol=0, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3e-4)
    listed = geometry.lift_2d(list(kps[:3]), portrait=portrait)
    np.testing.assert_allclose(np.stack(listed), host[:3], rtol=0, atol=0)


def test_camera_helpers_match_jax():
    pts = np.random.RandomState(7).uniform(-1, 1, (5, 9, 3)) \
        - np.array([0, 0, 3.0])
    cam = geometry.get_default_camera_matrix()
    np.testing.assert_array_equal(geometry.convert_camera_matrix_2_ndc(
        cam, (640, 480)), jax_geometry.convert_camera_matrix_2_ndc(
        cam, (640, 480)))
    ref = jax_geometry.project_3d_points(pts, cam)
    np.testing.assert_allclose(geometry.project_3d_points(pts, cam), ref)
    for portrait in (True, False):
        np.testing.assert_allclose(
            geometry.convert_2d_to_ndc(torch.from_numpy(ref),
                                       portrait).numpy(),
            jax_geometry.convert_2d_to_ndc(ref, portrait))


def _metric_inputs(seed=8, b=32):
    rng = np.random.RandomState(seed)
    gt = projected_keypoints(b, True, 0.0, seed)
    pred = (gt + rng.normal(0, 0.02, gt.shape)).astype(np.float32)
    cats = rng.normal(0, 1, (b, 9)).astype(np.float32)
    gt_cats = rng.randint(0, 9, b).astype(np.int32)
    return pred, gt, cats, gt_cats


@pytest.fixture
def jax_lift(monkeypatch):
    """The port's metrics lift through the JAX program."""
    def lift(kp, portrait=False):
        out = jax_geometry.lift_2d_batched(jnp.asarray(kp.numpy()),
                                           portrait=portrait)
        return torch.from_numpy(np.array(out))
    monkeypatch.setattr(metrics, 'lift_2d_batched', lift)


def _assert_metrics_close(out, ref, iou_atol):
    assert [c[0] for c in out[0]] == [c[0] for c in ref[0]]
    per_cls, per_cls_ref = (np.array([c[1:] for c in r[0]])
                            for r in (out, ref))
    atol = np.array([1e-5, 1e-5, iou_atol, 1e-5])
    assert np.all(np.abs(per_cls - per_cls_ref) <= atol)
    assert np.all(np.abs(np.array(out[1:]) - np.array(ref[1:])) <= atol)


@pytest.mark.parametrize('compute_iou', [True, False])
def test_metrics_per_cls_match_jax(jax_lift, compute_iou):
    pred, gt, cats, gt_cats = _metric_inputs()
    ref = jax_metrics.compute_metrics_per_cls(pred, gt, cats, gt_cats,
                                              compute_iou=compute_iou)
    out = metrics.compute_metrics_per_cls(pred, gt, cats, gt_cats,
                                          compute_iou=compute_iou,
                                          device='cpu')
    _assert_metrics_close(out, ref, 1e-5)
    if compute_iou:
        assert 0.1 < out[3] < 1.0


def test_metrics_per_cls_own_lift_match_jax():
    pred, gt, cats, gt_cats = _metric_inputs(seed=10)
    _assert_metrics_close(
        metrics.compute_metrics_per_cls(pred, gt, cats, gt_cats,
                                        device='cpu'),
        jax_metrics.compute_metrics_per_cls(pred, gt, cats, gt_cats), 1e-2)


def test_metric_functions_match_jax(jax_lift):
    pred, gt, cats, gt_cats = _metric_inputs(seed=9)
    for reduce_mean in (True, False):
        ref = jax_metrics.compute_2d_based_iou(pred, gt, reduce_mean)
        out = metrics.compute_2d_based_iou(pred, gt, reduce_mean,
                                           device='cpu')
        assert abs(float(out) - float(ref)) <= 1e-5 * (1 if reduce_mean
                                                      else 32)
        for o, r in zip(metrics.compute_average_distance(
                pred, gt, reduce_mean=reduce_mean, device='cpu'),
                jax_metrics.compute_average_distance(
                    pred, gt, reduce_mean=reduce_mean)):
            assert abs(float(o) - float(r)) <= 1e-5
        assert float(metrics.compute_accuracy(
            cats, gt_cats, reduce_mean, device='cpu')) == float(
            jax_metrics.compute_accuracy(cats, gt_cats, reduce_mean))
