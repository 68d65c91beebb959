"""EPnP 2D→3D lifting and camera geometry (counterpart of
``tpudet3d/ops/geometry.py``).

The whole batch is lifted at once: the ``[...,16,12]`` EPnP system is
assembled from a constant sparsity pattern and the ``[...,12,12]``
eigendecomposition of ``M^T M`` runs batched through
``torch.linalg.eigh`` (a library call, on cuSOLVER on the card).  The
eigenvector of the smallest eigenvalue gives the 4 control points up to
sign, and the sign is fixed so that the box lies in front of the camera.
``_lift_host`` is the float64 numpy path of the exact-parity checks.

Conventions (Objectron): keypoint 0 is the box centre, keypoints 1-8 the 8
box vertices; ``EPNP_ALPHA`` expresses the vertices as combinations of 4
EPnP control points (centre + 3 half-axis endpoints).
"""

import numpy as np
import torch

__all__ = [
    'EPNP_ALPHA', 'get_default_camera_matrix', 'project_3d_points',
    'convert_camera_matrix_2_ndc', 'convert_2d_to_ndc',
    'lift_2d', 'lift_2d_batched',
]

# Control-point alphas for vertices 1..8.
EPNP_ALPHA = np.array([[4, -1, -1, -1],
                       [2, -1, -1, 1],
                       [2, -1, 1, -1],
                       [0, -1, 1, 1],
                       [2, 1, -1, -1],
                       [0, 1, -1, 1],
                       [0, 1, 1, -1],
                       [-2, 1, 1, 1]], dtype=np.float64)


def get_default_camera_matrix():
    """Normalized pinhole camera."""
    return np.array([[1., 0., 0.5],
                     [0., 1., 0.5],
                     [0., 0., 1.]])


def project_3d_points(points, camera_matrix):
    """Pinhole projection with Objectron's -z convention (numpy)."""
    projection = np.matmul(points, np.asarray(camera_matrix).T)
    projection = projection / (-projection[..., 2:3])
    return projection[..., :2]


def convert_camera_matrix_2_ndc(matrix, img_shape=(1, 1)):
    """Camera matrix in pixels → NDC."""
    ndc_mat = np.array(matrix, dtype=np.float64, copy=True)
    ndc_mat[0, 0] *= 2.0 / img_shape[0]
    ndc_mat[1, 1] *= 2.0 / img_shape[1]
    ndc_mat[0, 2] = -ndc_mat[0, 2] * 2.0 / img_shape[0] + 1.0
    ndc_mat[1, 2] = -ndc_mat[1, 2] * 2.0 / img_shape[1] + 1.0
    return ndc_mat


def convert_2d_to_ndc(points, portrait=False):
    """[0,1] screen coords → [-1,1] NDC, for numpy arrays or tensors."""
    stack = torch.stack if isinstance(points, torch.Tensor) else np.stack
    x, y = points[..., 0], points[..., 1]
    if portrait:
        u = y * 2 - 1
        v = x * 2 - 1
    else:
        u = x * 2 - 1
        v = 1 - y * 2
    return stack([u, v], axis=-1)


def _build_m(uv, fx, fy, cx, cy):
    """The EPnP system ``[..., 16, 12]`` of NDC vertex coords ``uv [...,8,2]``:
    row 2i has fx·alpha at the x slots and (cx+u)·alpha at the z slots, row
    2i+1 fy·alpha at the y slots and (cy+v)·alpha at the z slots."""
    alpha = torch.as_tensor(EPNP_ALPHA, dtype=uv.dtype, device=uv.device)
    u, v = uv[..., 0], uv[..., 1]                              # [..., 8]
    ex = (alpha * fx).expand(u.shape + (4,))
    ez = (cx + u)[..., None] * alpha
    oy = (alpha * fy).expand(u.shape + (4,))
    oz = (cy + v)[..., None] * alpha
    zero = torch.zeros_like(ez)
    even = torch.stack([ex, zero, ez], dim=-1)                 # [..., 8, 4, 3]
    odd = torch.stack([zero, oy, oz], dim=-1)
    rows = torch.stack([even, odd], dim=-3)                    # [..., 8, 2, 4, 3]
    return rows.reshape(rows.shape[:-4] + (16, 12))


def lift_2d_batched(keypoints, camera_matrix=None, portrait=False):
    """Batched EPnP lift: a tensor ``[..., 9, 2]`` of normalized 2D
    keypoints → ``[..., 9, 3]`` camera-space 3D points up to scale (z < 0 in
    front of the camera), on the tensor's device.  float64 input stays
    float64, anything else computes in float32."""
    dtype = torch.float64 if keypoints.dtype == torch.float64 \
        else torch.float32
    keypoints = keypoints.to(dtype)
    if camera_matrix is None:
        camera_matrix = get_default_camera_matrix()
    ndc_cam = convert_camera_matrix_2_ndc(np.asarray(camera_matrix))
    # the JAX program rounds the camera constants to the compute dtype
    as_t = np.float64 if dtype == torch.float64 else np.float32
    fx, fy = float(as_t(ndc_cam[0, 0])), float(as_t(ndc_cam[1, 1]))
    cx, cy = float(as_t(ndc_cam[0, 2])), float(as_t(ndc_cam[1, 2]))

    uv = convert_2d_to_ndc(keypoints[..., 1:9, :], portrait=portrait)
    m = _build_m(uv, fx, fy, cx, cy)                          # [..., 16, 12]
    mt_m = m.transpose(-1, -2) @ m                            # [..., 12, 12]
    _, eigvecs = torch.linalg.eigh(mt_m)
    control = eigvecs[..., :, 0].reshape(mt_m.shape[:-2] + (4, 3))
    # all 3D points must sit in front of the camera (z < 0)
    sign = torch.where(control[..., 0, 2] > 0, -1.0, 1.0).to(dtype)
    control = control * sign[..., None, None]
    alpha = torch.as_tensor(EPNP_ALPHA, dtype=dtype, device=keypoints.device)
    vertices = torch.einsum('va,...ac->...vc', alpha, control)  # [..., 8, 3]
    return torch.cat([control[..., 0:1, :], vertices], dim=-2)


def lift_2d(keypoint_sets, camera_matrix=None, portrait=False):
    """List API: list of [9,2] numpy arrays in, list of [9,3] numpy arrays
    out, lifted in float64 on the host."""
    if camera_matrix is None:
        camera_matrix = get_default_camera_matrix()
    batch = np.stack([np.asarray(k, dtype=np.float64) for k in keypoint_sets])
    lifted = _lift_host(batch, np.asarray(camera_matrix), portrait)
    return [lifted[i] for i in range(lifted.shape[0])]


def _lift_host(batch, camera_matrix, portrait):
    """float64 host path for exact-parity checks (numpy eigh)."""
    ndc_cam = convert_camera_matrix_2_ndc(camera_matrix)
    fx, fy = ndc_cam[0, 0], ndc_cam[1, 1]
    cx, cy = ndc_cam[0, 2], ndc_cam[1, 2]
    uv = np.asarray(convert_2d_to_ndc(batch[:, 1:9, :], portrait=portrait))
    alpha = EPNP_ALPHA
    bs = batch.shape[0]
    ex = np.broadcast_to(alpha * fx, (bs, 8, 4))
    oy = np.broadcast_to(alpha * fy, (bs, 8, 4))
    ez = (cx + uv[..., 0])[..., None] * alpha
    oz = (cy + uv[..., 1])[..., None] * alpha
    zero = np.zeros_like(ez)
    even = np.stack([ex, zero, ez], axis=-1)
    odd = np.stack([zero, oy, oz], axis=-1)
    m = np.stack([even, odd], axis=2).reshape(bs, 16, 12)
    mt_m = np.einsum('bki,bkj->bij', m, m)
    _, eigvecs = np.linalg.eigh(mt_m)
    control = eigvecs[:, :, 0].reshape(bs, 4, 3)
    sign = np.where(control[:, 0, 2] > 0, -1.0, 1.0)
    control = control * sign[:, None, None]
    vertices = np.einsum('va,bac->bvc', alpha, control)
    return np.concatenate([control[:, 0:1, :], vertices], axis=1)
