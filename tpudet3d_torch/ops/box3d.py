"""Exact IoU of oriented 3D boxes (counterpart of ``tpudet3d/ops/box3d.py``).

``iou_oriented_boxes_plain`` is the plain PyTorch version of kernel K5
(``kernels/csrc/box3d_iou.cu``); ``iou_oriented_boxes`` is its wrapper.

1. Each box (9 Objectron keypoints: centre + 8 corners in binary ±e1±e2±e3
   order) is a centre and 3 half-axis vectors.  EPnP-lifted boxes are
   exact parallelepipeds, so the 6 face planes are exact.
2. The boundary of ``B1 ∩ B2`` is the union of B1's faces clipped to B2
   and B2's faces clipped to B1.  Each quad face is clipped by the other
   box's 6 halfspaces with a fixed-size Sutherland–Hodgman pass (a convex
   polygon gains at most one vertex per plane → at most 10, buffer 12;
   writes past slot 11 are dropped, as the JAX program's ``mode='drop'``).
3. Volume by the divergence theorem: fan-triangulate each outward-oriented
   clipped polygon and sum signed tetrahedron volumes about the origin,
   the 6 faces of pass 1 and then the 6 of pass 2.

Coincident faces are counted once: pass 1 keeps a face lying on a plane
of the other box when the normals agree (``eps = +tol``) and drops it when
they oppose (touching boxes), pass 2 always drops them (``eps = -tol``),
with ``tol = 1e-5·(1+|b|)``.  Degenerate and non-finite inputs give 0.

The plain version spells out every dot product, cross product and sum in
the order the kernel computes them, without fused multiply-adds, so that
the two round alike.  ``iou_single_host`` is an independent scipy
(halfspace intersection + convex hull) cross-check on the host.
"""

import numpy as np
import torch

from ..kernels.build import check, library, stream_args

__all__ = ['box_axes', 'box_volume', 'iou_oriented_boxes',
           'iou_oriented_boxes_plain', 'pairwise_iou_oriented_boxes',
           'iou_single_host']

_MAXV = 12  # vertex buffer per clipped face polygon (quad + 6 clips ≤ 10)

# Face corner indices (into the 8-corner array, binary order: bit2=e1,
# bit1=e2, bit0=e3), ordered CCW viewed from outside for a right-handed
# (e1, e2, e3).
_FACES = np.array([
    [4, 6, 7, 5],   # +e1
    [0, 1, 3, 2],   # -e1
    [2, 3, 7, 6],   # +e2
    [0, 4, 5, 1],   # -e2
    [1, 5, 7, 3],   # +e3
    [0, 2, 6, 4],   # -e3
], dtype=np.int64)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _mean_rows(x, rows):
    """Mean of ``x[..., rows, :]``, summed in the order of ``rows``."""
    s = x[..., rows[0], :]
    for r in rows[1:]:
        s = s + x[..., r, :]
    return s / float(len(rows))


def box_axes(keypoints):
    """centre ``[...,3]`` and half-axes ``[...,3,3]`` of Objectron 9-keypoint
    boxes ``[...,9,3]``: half-axis i is the mean of the corners with bit i
    set, minus the centre."""
    corners = keypoints[..., 1:9, :]
    center = _mean_rows(corners, range(8))
    e1 = _mean_rows(corners, (4, 5, 6, 7)) - center
    e2 = _mean_rows(corners, (2, 3, 6, 7)) - center
    e3 = _mean_rows(corners, (1, 3, 5, 7)) - center
    return center, torch.stack([e1, e2, e3], dim=-2)


def _det(axes):
    return _dot(axes[..., 0, :], _cross(axes[..., 1, :], axes[..., 2, :]))


def box_volume(axes):
    """Unsigned volume of the parallelepiped: 8·|det(e1, e2, e3)|."""
    return 8.0 * _det(axes).abs()


def _box_halfspaces(center, axes):
    """Outward halfspaces ``A x <= b`` (``[...,6,3]``, ``[...,6]``) in the
    order +e1, -e1, +e2, -e2, +e3, -e3."""
    e1, e2, e3 = axes[..., 0, :], axes[..., 1, :], axes[..., 2, :]
    ns, pts = [], []
    for n, e in ((_cross(e2, e3), e1), (_cross(e3, e1), e2),
                 (_cross(e1, e2), e3)):
        n = n * torch.sign(_dot(n, e))[..., None]
        ns += [n, -n]
        pts += [center + e, center - e]
    ns = torch.stack(ns, dim=-2)
    return ns, _dot(ns, torch.stack(pts, dim=-2))


def _clip(poly, count, normal, offset, eps):
    """One Sutherland–Hodgman pass over a batch of polygons.

    poly ``[F,12,3]``, count ``[F]`` valid vertices, plane ``normal [F,3]``
    / ``offset [F]`` (inside: ``n·x - offset <= eps``).  Vertices are
    emitted in order (each inside vertex, then the crossing after it);
    emissions past slot 11 are dropped but still counted, and reads of
    the next vertex clamp at slot 11, as the JAX program's gathers do."""
    f = poly.shape[0]
    idx = torch.arange(_MAXV, device=poly.device)
    cnt = count[:, None]
    valid = idx < cnt
    d = _dot(poly, normal[:, None, :]) - offset[:, None]            # [F,12]
    inside = d <= eps[:, None]
    nxt = torch.where(idx + 1 >= cnt, 0, idx + 1).clamp(max=_MAXV - 1)
    d_next = d.gather(1, nxt)
    inside_next = d_next <= eps[:, None]
    crossing = (inside != inside_next) & valid
    inside = inside & valid
    denom = d - d_next
    big = denom.abs() > 1e-12
    t = torch.where(big, d / torch.where(big, denom, 1.0), 0.0)
    p_next = poly.gather(1, nxt[..., None].expand(f, _MAXV, 3))
    inter = poly + t[..., None] * (p_next - poly)
    n_emit = inside.long() + crossing.long()
    start = n_emit.cumsum(-1) - n_emit
    out = torch.zeros((f, _MAXV + 1, 3), dtype=poly.dtype, device=poly.device)
    drop = torch.full_like(start, _MAXV)
    vert_slot = torch.where(inside, start, drop).clamp(max=_MAXV)
    cross_slot = torch.where(crossing, start + inside.long(), drop) \
        .clamp(max=_MAXV)
    # emitted slots below 12 are distinct; everything else lands in the
    # scratch slot 12, which is cut off
    out.scatter_(1, vert_slot[..., None].expand(f, _MAXV, 3), poly)
    out.scatter_(1, cross_slot[..., None].expand(f, _MAXV, 3), inter)
    return out[:, :_MAXV], n_emit.sum(-1)


def _fan_volume(poly, count):
    """Six times the signed volume of the cones from the origin over the
    fan-triangulated polygons, summed over the slots in order."""
    p0 = poly[:, 0]
    total = torch.zeros(poly.shape[0], dtype=poly.dtype, device=poly.device)
    for i in range(1, _MAXV):
        det = _dot(p0, _cross(poly[:, i], poly[:, min(i + 1, _MAXV - 1)]))
        total = total + torch.where(i < count - 1, det, 0.0)
    return total


def iou_oriented_boxes_plain(kp1, kp2):
    """Exact IoU of two batches of oriented parallelepipeds.

    kp1, kp2: ``[..., 9, 3]`` Objectron keypoint boxes (float32).  Returns
    ``[...]`` IoU in [0, 1]; non-finite or degenerate inputs give 0."""
    batch_shape = kp1.shape[:-2]
    a = kp1.reshape(-1, 9, 3).float()
    b = kp2.reshape(-1, 9, 3).float()
    p = a.shape[0]
    c1, ax1 = box_axes(a)
    c2, ax2 = box_axes(b)
    det1, det2 = _det(ax1), _det(ax2)
    v1, v2 = 8.0 * det1.abs(), 8.0 * det2.abs()
    h1, h2 = torch.sign(det1), torch.sign(det2)
    n1, o1 = _box_halfspaces(c1, ax1)
    n2, o2 = _box_halfspaces(c2, ax2)
    faces = torch.as_tensor(_FACES, device=a.device) + 1            # [6,4]
    # faces 0-5: box 1's, clipped by box 2's planes; 6-11: the reverse
    quads = torch.cat([a[:, faces], b[:, faces]], dim=1)            # [P,12,4,3]
    hand = torch.cat([h1[:, None].expand(p, 6), h2[:, None].expand(p, 6)], 1)
    normals = torch.cat([n2[:, None].expand(p, 6, 6, 3),
                         n1[:, None].expand(p, 6, 6, 3)], 1)        # [P,12,6,3]
    offsets = torch.cat([o2[:, None].expand(p, 6, 6),
                         o1[:, None].expand(p, 6, 6)], 1)           # [P,12,6]
    face_n = _cross(quads[..., 1, :] - quads[..., 0, :],
                    quads[..., 2, :] - quads[..., 0, :]) * hand[..., None]
    tol = 1e-5 * (1.0 + offsets.abs())
    first = torch.arange(12, device=a.device)[:, None] < 6
    eps = torch.where(first, tol * torch.sign(
        _dot(face_n[:, :, None, :], normals)), -tol)

    poly = torch.zeros((p, 12, _MAXV, 3), dtype=a.dtype, device=a.device)
    poly[:, :, :4] = quads
    poly = poly.reshape(p * 12, _MAXV, 3)
    count = torch.full((p * 12,), 4, dtype=torch.long, device=a.device)
    normals = normals.reshape(p * 12, 6, 3)
    offsets = offsets.reshape(p * 12, 6)
    eps = eps.reshape(p * 12, 6)
    for i in range(6):
        poly, count = _clip(poly, count, normals[:, i], offsets[:, i],
                            eps[:, i])
    vols = (_fan_volume(poly, count) / 6.0).reshape(p, 12) * hand
    s1, s2 = vols[:, 0], vols[:, 6]
    for j in range(1, 6):
        s1 = s1 + vols[:, j]
        s2 = s2 + vols[:, 6 + j]
    vi = torch.minimum((s1 + s2).clamp(min=0.0), torch.minimum(v1, v2))
    union = v1 + v2 - vi
    ok = union > 1e-12
    iou = torch.where(ok, vi / torch.where(ok, union, 1.0), 0.0)
    iou = torch.where(torch.isfinite(iou), iou, 0.0).clamp(0.0, 1.0)
    return iou.reshape(batch_shape)


def iou_oriented_boxes(kp1, kp2):
    """K5: see :func:`iou_oriented_boxes_plain`.  Tensors ``[..., 9, 3]`` of
    one shape on one device; on the card float32."""
    if kp1.shape != kp2.shape or kp1.shape[-2:] != (9, 3):
        raise ValueError(f'expected two [..., 9, 3] tensors of one shape, '
                         f'got {tuple(kp1.shape)} and {tuple(kp2.shape)}')
    if kp1.device.type == 'cpu' and kp2.device.type == 'cpu':
        return iou_oriented_boxes_plain(kp1, kp2)
    if kp1.device.type != 'cuda' or kp2.device != kp1.device:
        raise ValueError(f'unsupported devices {kp1.device}, {kp2.device}')
    batch_shape = kp1.shape[:-2]
    a = kp1.reshape(-1, 9, 3).float().contiguous()
    b = kp2.reshape(-1, 9, 3).float().contiguous()
    p = a.shape[0]
    out = torch.empty((p,), dtype=torch.float32, device=a.device)
    if p:
        err = library().tpd_box3d_iou(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), p, *stream_args(a))
        check(err, 'iou_oriented_boxes')
        iou_oriented_boxes.launches += 1
    return out.reshape(batch_shape)


iou_oriented_boxes.launches = 0


def pairwise_iou_oriented_boxes(kps_a, kps_b):
    """``[N,9,3]`` × ``[M,9,3]`` → ``[N,M]`` IoU matrix, in one call."""
    n, m = kps_a.shape[0], kps_b.shape[0]
    return iou_oriented_boxes(
        kps_a[:, None].expand(n, m, 9, 3).contiguous(),
        kps_b[None].expand(n, m, 9, 3).contiguous())


def iou_single_host(kp1, kp2):
    """Independent host-side exact IoU via scipy halfspace intersection
    (copy of the JAX package's cross-check); not used on any path."""
    import scipy.spatial
    from scipy.optimize import linprog

    def halfspaces(kp):
        corners = np.asarray(kp, dtype=np.float64)[1:9]
        center = corners.mean(0)
        e1 = corners[4:8].mean(0) - center
        e2 = corners[[2, 3, 6, 7]].mean(0) - center
        e3 = corners[[1, 3, 5, 7]].mean(0) - center
        ns, bs = [], []
        for e, (u, v) in zip((e1, e2, e3), ((e2, e3), (e3, e1), (e1, e2))):
            n = np.cross(u, v)
            n *= np.sign(n @ e)
            ns += [n, -n]
            bs += [n @ (center + e), -n @ (center - e)]
        return np.array(ns), np.array(bs)

    def volume(kp):
        corners = np.asarray(kp, dtype=np.float64)[1:9]
        center = corners.mean(0)
        e1 = corners[4:8].mean(0) - center
        e2 = corners[[2, 3, 6, 7]].mean(0) - center
        e3 = corners[[1, 3, 5, 7]].mean(0) - center
        return 8.0 * abs(np.linalg.det(np.stack([e1, e2, e3])))

    A1, b1 = halfspaces(kp1)
    A2, b2 = halfspaces(kp2)
    A = np.vstack([A1, A2])
    b = np.concatenate([b1, b2])
    # Chebyshev centre as the interior point for HalfspaceIntersection
    norms = np.linalg.norm(A, axis=1, keepdims=True)
    res = linprog(c=np.r_[np.zeros(3), -1.0],
                  A_ub=np.hstack([A, norms]), b_ub=b,
                  bounds=[(None, None)] * 3 + [(0, None)], method='highs')
    if not res.success or res.x[3] < 1e-12:
        return 0.0
    interior = res.x[:3]
    try:
        hs = scipy.spatial.HalfspaceIntersection(
            np.hstack([A, -b[:, None]]), interior)
        hull = scipy.spatial.ConvexHull(hs.intersections)
        vi = hull.volume
    except Exception:  # qhull errors → 0, like the reference
        return 0.0
    v1, v2 = volume(kp1), volume(kp2)
    union = v1 + v2 - vi
    return float(vi / union) if union > 0 else 0.0
