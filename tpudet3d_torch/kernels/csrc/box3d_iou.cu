// K5 iou_oriented_boxes: exact IoU of P pairs of oriented parallelepipeds,
// each given as 9 Objectron keypoints (centre + 8 corners in binary
// +-e1+-e2+-e3 order), f32 [P,9,3] x 2 -> f32 [P].
//
// Replaces: tpudet3d/ops/box3d.py:161-209 iou_oriented_boxes with
//   _clip_polygon_by_plane (:80) and _clip_face_volume (:119).
//
// Bound on the H100: the launch plus one round trip to memory and a chain
// of dependent steps, not bytes.  A pair reads 216 bytes and needs about
// 4 kflop (7 per clip visit of a valid vertex, 12 per crossing, 15 per
// fan triangle, ~1 k of set-up, counted on random pairs through the
// plain version); at P = 128 that is 28 KB (8 ns at 3.35 TB/s) and 0.5
// Mflop (7 ns at 67 TFLOP/s f32), and the protocol calls it on at most 8 pairs
// of one example.  What is left is the depth of the chain: set-up, six
// clip passes, the fan and the sums.
//
// Design: a CTA of 192 threads per pair.  Six of its threads derive the
// two boxes' planes once (one per box and axis) into shared memory while
// every lane loads its face's corners.  Then each of the 12 faces (0-5
// box 1's, clipped by box 2's 6 halfspaces; 6-11 box 2's, clipped by box
// 1's) takes a 16-lane segment: lane i holds vertex slot i (lanes 12-15
// idle), and each Sutherland-Hodgman pass is the plain version's _clip
// (ops/box3d.py) across lanes: the distance in parallel, the next
// vertex by a shuffle, inside and crossing bits by two ballots, each
// emission's slot by the popcount of the lower lanes' bits, and a scatter
// into the face's shared double buffer (slot 12 drops emissions past
// slot 11, which still count).  The lanes' fan determinants are summed
// in slot order by shuffles, and one thread of the CTA sums the 12 face
// volumes in a fixed order (faces 0-5, then 6-11) and finishes the IoU.
// Every product, sum and quotient is written with the round-to-nearest
// intrinsics in the order of the plain PyTorch version, so nothing is
// contracted into a fused multiply-add and the two agree bit for bit on
// the card.  The division of the fan sum by 6 is a product with the f32
// reciprocal, as PyTorch divides a tensor by a scalar on the card.  No
// array is indexed at run time outside shared memory, so nothing lives
// in local memory.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxV = 12;           // vertex slots of a clipped polygon
constexpr int kSeg = 16;            // lanes per face
constexpr int kPairThreads = 12 * kSeg;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ V3 shfl(V3 v, int src) {
  return {__shfl_sync(kFull, v.x, src, kSeg),
          __shfl_sync(kFull, v.y, src, kSeg),
          __shfl_sync(kFull, v.z, src, kSeg)};
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

// what the faces of the other box are clipped by, and the sign of det
struct Planes {
  V3 n[6];
  float b[6];
  float det;
};

struct Pair {
  Planes box[2];
  float4 poly[12][2][kMaxV + 1];  // per face: double buffer, slot 12 drops
  float vols[12];
};

// axis a of the box with keypoints kp: its two planes, and with a = 0 the
// determinant, each in the order of the plain version's _box_halfspaces
__device__ void make_planes(const float* kp, int a, Planes& out) {
  const int all[8] = {0, 1, 2, 3, 4, 5, 6, 7};
  const int r1[4] = {4, 5, 6, 7}, r2[4] = {2, 3, 6, 7}, r3[4] = {1, 3, 5, 7};
  const V3 c = mean_corners<8>(kp, all);
  const V3 e0 = sub(mean_corners<4>(kp, r1), c);
  const V3 e1 = sub(mean_corners<4>(kp, r2), c);
  const V3 e2 = sub(mean_corners<4>(kp, r3), c);
  const V3 ea = a == 0 ? e0 : (a == 1 ? e1 : e2);
  V3 n = a == 0 ? cross(e1, e2) : (a == 1 ? cross(e2, e0) : cross(e0, e1));
  n = scale(n, sgn(dot(n, ea)));
  out.n[2 * a] = n;
  out.n[2 * a + 1] = neg(n);
  out.b[2 * a] = dot(n, add(c, ea));
  out.b[2 * a + 1] = dot(neg(n), sub(c, ea));
  if (a == 0) out.det = dot(e0, cross(e1, e2));
}

__global__ void __launch_bounds__(kPairThreads)
box3d_iou_kernel(const float* __restrict__ kp1, const float* __restrict__ kp2,
                 float* __restrict__ out) {
  __shared__ Pair s;
  const int t = threadIdx.x;
  const int p = blockIdx.x;
  const int face = t / kSeg, i = t % kSeg;
  const bool first = face < 6;  // a face of box 1, clipped by box 2
  const int own = first ? 0 : 1, f = first ? face : face - 6;
  const float* kp_own = (own ? kp2 : kp1) + (size_t)p * 27;

  // 1. the face's quad and its normal, while threads 0-5 make the planes
  V3 v = {0.f, 0.f, 0.f};
  const V3 q0 = corner(kp_own, kFaces[f][0]);
  const V3 q_n = cross(sub(corner(kp_own, kFaces[f][1]), q0),
                       sub(corner(kp_own, kFaces[f][2]), q0));
  if (i < 4) v = corner(kp_own, kFaces[f][i]);
  if (t < 6)
    make_planes((t < 3 ? kp1 : kp2) + (size_t)p * 27, t % 3, s.box[t / 3]);
  __syncthreads();

  const Planes& other = s.box[own ^ 1];
  const float hand = sgn(s.box[own].det);
  const V3 face_n = scale(q_n, hand);
  const int shift = t & 16;  // this segment's ballot bits
  const unsigned lower = (1u << i) - 1u;
  int count = 4;
  // 2. six Sutherland-Hodgman passes, one plane each
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const V3 nrm = other.n[k];
    const float off = other.b[k];
    const float tol = __fmul_rn(1e-5f, __fadd_rn(1.f, fabsf(off)));
    const float eps = first ? __fmul_rn(tol, sgn(dot(face_n, nrm))) : -tol;
    const float d = __fsub_rn(dot(v, nrm), off);
    // the next vertex wraps at count; a read past slot 11 clamps to it
    const int nxt = min(i + 1 >= count ? 0 : i + 1, kMaxV - 1);
    const float d_next = __shfl_sync(kFull, d, nxt, kSeg);
    const V3 v_next = shfl(v, nxt);
    const bool valid = i < count && i < kMaxV;
    const bool in = d <= eps;
    const bool inside = valid && in;
    const bool crossing = valid && in != (d_next <= eps);
    const unsigned in_bits =
        (__ballot_sync(kFull, inside) >> shift) & 0xffff;
    const unsigned cr_bits =
        (__ballot_sync(kFull, crossing) >> shift) & 0xffff;
    const int start = __popc(in_bits & lower) + __popc(cr_bits & lower);
    float4* poly = s.poly[face][(k & 1) ^ 1];
    if (inside) poly[min(start, kMaxV)] = make_float4(v.x, v.y, v.z, 0.f);
    if (crossing) {
      const float denom = __fsub_rn(d, d_next);
      const float tt = fabsf(denom) > 1e-12f ? __fdiv_rn(d, denom) : 0.f;
      const V3 x = add(v, scale(sub(v_next, v), tt));
      poly[min(start + (int)inside, kMaxV)] =
          make_float4(x.x, x.y, x.z, 0.f);
    }
    count = __popc(in_bits) + __popc(cr_bits);
    __syncwarp();
    const float4 q = poly[min(i, kMaxV)];  // lanes 12-15: the drop slot
    v = {q.x, q.y, q.z};
  }
  // 3. fan triangulation: cones (origin, p0, p_i, p_i+1) for
  // 1 <= i < count-1, summed in slot order
  const V3 p0 = shfl(v, 0);
  const float det = dot(p0, cross(v, shfl(v, min(i + 1, kMaxV - 1))));
  const float term = i < count - 1 ? det : 0.f;
  float total = 0.f;
#pragma unroll
  for (int j = 1; j < kMaxV; ++j)
    total = __fadd_rn(total, __shfl_sync(kFull, term, j, kSeg));
  if (i == 0) s.vols[face] = __fmul_rn(__fmul_rn(total, 1.f / 6.f), hand);
  __syncthreads();
  if (t != 0) return;
  // 4. the pair's IoU
  float s1 = s.vols[0], s2 = s.vols[6];
#pragma unroll
  for (int j = 1; j < 6; ++j) {
    s1 = __fadd_rn(s1, s.vols[j]);
    s2 = __fadd_rn(s2, s.vols[6 + j]);
  }
  const float v1 = __fmul_rn(8.f, fabsf(s.box[0].det));
  const float v2 = __fmul_rn(8.f, fabsf(s.box[1].det));
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
  const auto* a = static_cast<const float*>(kp1);
  const auto* b = static_cast<const float*>(kp2);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  box3d_iou_kernel<<<p, kPairThreads, 0, s>>>(a, b, o);
  return (int)cudaGetLastError();
}
