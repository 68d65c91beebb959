// K5 iou_oriented_boxes: exact IoU of P pairs of oriented parallelepipeds,
// each given as 9 Objectron keypoints (centre + 8 corners in binary
// +-e1+-e2+-e3 order), f32 [P,9,3] x 2 -> f32 [P].
//
// Replaces: tpudet3d/ops/box3d.py:161-209 iou_oriented_boxes with
//   _clip_polygon_by_plane (:80) and _clip_face_volume (:119).
//
// Bound on the H100: launch latency.  A pair reads 216 bytes and needs
// about 4 kflop (7 per clip visit of a valid vertex, 12 per crossing, 15
// per fan triangle, ~1 k of set-up; chip_smoke.py's k5_work counts them
// on the data); at P = 128 that is 28 KB (8 ns at 3.35 TB/s) and 0.5 Mflop
// (7 ns at 67 TFLOP/s f32), and the protocol calls it on at most 8 pairs
// of one example.
//
// Design: 12 threads per pair, one per face (faces 0-5 are box 1's,
// clipped by box 2's 6 halfspaces; faces 6-11 box 2's, clipped by box
// 1's).  Each thread derives both boxes' axes and planes itself, clips its
// quad with 6 Sutherland-Hodgman passes between two 12-vertex buffers in
// local memory, and fan-triangulates the result into a signed volume.  The
// pair's first thread sums the 12 face volumes in a fixed order (faces 0-5,
// then 6-11) and finishes the IoU.  Every product, sum and quotient is
// written with the round-to-nearest intrinsics in the order of the plain
// PyTorch version (ops/box3d.py), so nothing is contracted into a fused
// multiply-add and the two agree bit for bit on the card.  The division of
// the fan sum by 6 is a product with the f32 reciprocal, as PyTorch
// divides a tensor by a scalar on the card.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxV = 12;           // vertex buffer per clipped polygon
constexpr int kPairsPerBlock = 8;
constexpr int kThreads = kPairsPerBlock * 12;

// face corner indices into the 8 corners, CCW seen from outside for a
// right-handed (e1, e2, e3): +e1, -e1, +e2, -e2, +e3, -e3
__constant__ int kFaces[6][4] = {{4, 6, 7, 5}, {0, 1, 3, 2}, {2, 3, 7, 6},
                                 {0, 4, 5, 1}, {1, 5, 7, 3}, {0, 2, 6, 4}};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s)};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}
// torch.sign: -1, 0 or 1, NaN stays NaN
__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
}

__device__ __forceinline__ V3 corner(const float* kp, int i) {
  const float* p = kp + (1 + i) * 3;
  return {p[0], p[1], p[2]};
}

// mean of the listed corners, summed in list order
template <int N>
__device__ __forceinline__ V3 mean_corners(const float* kp, const int* rows) {
  V3 s = corner(kp, rows[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) s = add(s, corner(kp, rows[i]));
  return scale(s, 1.f / N);  // 1/8 and 1/4: exact
}

struct Box {
  V3 c, e[3];
  float det;
  V3 n[6];
  float b[6];
};

__device__ void make_box(const float* kp, Box& box) {
  const int all[8] = {0, 1, 2, 3, 4, 5, 6, 7};
  const int r1[4] = {4, 5, 6, 7}, r2[4] = {2, 3, 6, 7}, r3[4] = {1, 3, 5, 7};
  box.c = mean_corners<8>(kp, all);
  box.e[0] = sub(mean_corners<4>(kp, r1), box.c);
  box.e[1] = sub(mean_corners<4>(kp, r2), box.c);
  box.e[2] = sub(mean_corners<4>(kp, r3), box.c);
  box.det = dot(box.e[0], cross(box.e[1], box.e[2]));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    V3 n = cross(box.e[(a + 1) % 3], box.e[(a + 2) % 3]);
    n = scale(n, sgn(dot(n, box.e[a])));
    box.n[2 * a] = n;
    box.n[2 * a + 1] = neg(n);
    box.b[2 * a] = dot(n, add(box.c, box.e[a]));
    box.b[2 * a + 1] = dot(neg(n), sub(box.c, box.e[a]));
  }
}

// signed volume contributed by face f of box `own`, clipped by the planes
// of box `other` (pass 1 for faces of box 1, pass 2 for box 2)
__device__ float face_volume(const float* kp_own, const Box& own,
                             const Box& other, int face, bool first_pass) {
  V3 buf[2][kMaxV];
#pragma unroll
  for (int i = 0; i < kMaxV; ++i) buf[0][i] = buf[1][i] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) buf[0][j] = corner(kp_own, kFaces[face][j]);
  const float hand = sgn(own.det);
  const V3 face_n = scale(cross(sub(buf[0][1], buf[0][0]),
                                sub(buf[0][2], buf[0][0])), hand);
  int count = 4, cur = 0;
  float d[kMaxV];
  for (int k = 0; k < 6; ++k) {
    const V3 nrm = other.n[k];
    const float off = other.b[k];
    const float tol = __fmul_rn(1e-5f, __fadd_rn(1.f, fabsf(off)));
    const float eps = first_pass ? __fmul_rn(tol, sgn(dot(face_n, nrm)))
                                 : -tol;
    const V3* in = buf[cur];
    V3* out = buf[cur ^ 1];
    const int n_valid = min(count, kMaxV);
    for (int i = 0; i < n_valid; ++i) d[i] = __fsub_rn(dot(in[i], nrm), off);
    int emitted = 0;
    for (int i = 0; i < n_valid; ++i) {
      // the next vertex wraps at count; a read past slot 11 clamps to it
      const int nxt = min(i + 1 >= count ? 0 : i + 1, kMaxV - 1);
      const bool inside = d[i] <= eps;
      const bool inside_next = d[nxt] <= eps;
      if (inside) {
        if (emitted < kMaxV) out[emitted] = in[i];
        ++emitted;
      }
      if (inside != inside_next) {
        const float denom = __fsub_rn(d[i], d[nxt]);
        const float t = fabsf(denom) > 1e-12f ? __fdiv_rn(d[i], denom) : 0.f;
        if (emitted < kMaxV)
          out[emitted] = add(in[i], scale(sub(in[nxt], in[i]), t));
        ++emitted;
      }
    }
    count = emitted;
    cur ^= 1;
  }
  // fan triangulation: cones (origin, p0, p_i, p_i+1) for 1 <= i < count-1
  const V3* poly = buf[cur];
  float total = 0.f;
  for (int i = 1; i < kMaxV; ++i) {
    const float det =
        dot(poly[0], cross(poly[i], poly[min(i + 1, kMaxV - 1)]));
    total = __fadd_rn(total, i < count - 1 ? det : 0.f);
  }
  return __fmul_rn(__fmul_rn(total, 1.f / 6.f), hand);
}

__global__ void __launch_bounds__(kThreads)
box3d_iou_kernel(const float* __restrict__ kp1, const float* __restrict__ kp2,
                 float* __restrict__ out, int P) {
  __shared__ float vols[kPairsPerBlock][12];
  const int local = threadIdx.x / 12, face = threadIdx.x % 12;
  const int p = blockIdx.x * kPairsPerBlock + local;
  Box b1, b2;
  if (p < P) {
    const float* a = kp1 + (size_t)p * 27;
    const float* b = kp2 + (size_t)p * 27;
    make_box(a, b1);
    make_box(b, b2);
    vols[local][face] = face < 6 ? face_volume(a, b1, b2, face, true)
                                 : face_volume(b, b2, b1, face - 6, false);
  }
  __syncthreads();
  if (p >= P || face != 0) return;
  float s1 = vols[local][0], s2 = vols[local][6];
#pragma unroll
  for (int j = 1; j < 6; ++j) {
    s1 = __fadd_rn(s1, vols[local][j]);
    s2 = __fadd_rn(s2, vols[local][6 + j]);
  }
  const float v1 = __fmul_rn(8.f, fabsf(b1.det));
  const float v2 = __fmul_rn(8.f, fabsf(b2.det));
  // clamp(min=0) then minimum(., min(v1, v2)), NaN-propagating like torch
  float vi = __fadd_rn(s1, s2);
  vi = vi < 0.f ? 0.f : vi;
  const float vmin = (v1 != v1 || v2 != v2) ? NAN : fminf(v1, v2);
  vi = (vi != vi || vmin != vmin) ? NAN : fminf(vi, vmin);
  const float uni = __fsub_rn(__fadd_rn(v1, v2), vi);
  float iou = uni > 1e-12f ? __fdiv_rn(vi, uni) : 0.f;
  if (!isfinite(iou)) iou = 0.f;
  out[p] = fminf(fmaxf(iou, 0.f), 1.f);
}

}  // namespace

extern "C" int tpd_box3d_iou(const void* kp1, const void* kp2, void* out,
                             int p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  box3d_iou_kernel<<<tpd::ceil_div(p, kPairsPerBlock), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kp1), static_cast<const float*>(kp2),
      static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}
