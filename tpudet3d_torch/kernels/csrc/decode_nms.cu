// K3 decode_nms: SSD detection decode for a batch of images.  Per image:
// softmax over [A, C+1] logits, delta decode against the anchors, a
// per-class score floor and top-K, hard greedy NMS or Gaussian soft-NMS
// with a duplicate cutoff, optional box voting, then the global top
// max_det over the C*K survivors -> [max_det, 6] (x1, y1, x2, y2, score,
// label), score-descending, padded rows with score 0.
//
// Replaces: tpudet3d/detect/nms.py:86-144 decode_detections with
//   greedy_nms (:25), soft_nms (:41) and tpudet3d/detect/coder.py:34
//   decode_boxes, as the serving program calls it with
//   K = max(4 * max_det, 32) (tpudet3d/infer/engine.py:225-232).
//
// Bound on the H100: neither bytes nor operations.  At batch 16 it reads
// about 1.8 MB (logits and deltas) and writes 3 KB, about 0.5 us at
// 3.35 TB/s; the work is a chain of K dependent steps per (image, class),
// so latency (launch, block-wide reductions, the serial NMS chain) sets
// its time.
//
// Design: kernel 1 runs one block per (class, image).  It writes the
// class's scores for all A anchors into shared memory (8 KB for A = 2044),
// selects the top K by K block-wide argmax rounds, decodes only those K
// boxes, and runs the NMS chain in one warp with the boxes in shared memory
// (a ballot per step of greedy NMS, a warp argmax per round of soft-NMS).
// Kernel 2 runs one warp per image and merges the C*K candidates.  Ties
// break as lax.top_k and jnp.argmax do: higher score first, then lower
// index.  Scores, IoUs and decoded boxes are computed with the same IEEE
// operations in the same order as the plain PyTorch version (no fused
// multiply-adds there), so the two agree bit for bit on the card except in
// the box-vote sums.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// inv_sigma is 1/sigma rounded to f32: the plain version multiplies by
// the same reciprocal, as PyTorch does for a division by a scalar
struct Params {
  float score_thr, iou_thr, inv_sigma, dup_iou, vote_iou, log_clip;
};

__device__ __forceinline__ float iou(const float* a, const float* b) {
  const float iw = fmaxf(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float aa = __fmul_rn(fmaxf(__fsub_rn(a[2], a[0]), 0.f),
                             fmaxf(__fsub_rn(a[3], a[1]), 0.f));
  const float ab = __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.f),
                             fmaxf(__fsub_rn(b[3], b[1]), 0.f));
  const float uni = __fsub_rn(__fadd_rn(aa, ab), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// (v, i) beats (bv, bi): higher value, then lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// argmax over the warp; every lane gets the result
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
class_nms_kernel(const float* __restrict__ logits,
                 const float* __restrict__ deltas,
                 const float* __restrict__ anchors,
                 float* __restrict__ cls_boxes, float* __restrict__ cls_scores,
                 int A, int C, int K, Params prm) {
  extern __shared__ float smem[];
  float* s_score = smem;          // [A] class scores, -inf once selected
  float* s_top = s_score + A;     // [K] pre-NMS scores of the top K
  float* s_kept = s_top + K;      // [K] scores after NMS
  float* s_box = s_kept + K;      // [K, 4] decoded boxes
  int* s_idx = reinterpret_cast<int*>(s_box + 4 * K);  // [K] anchor index
  int* s_flag = s_idx + K;        // [K] keep (greedy) / processed (soft)
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];

  const int c = blockIdx.x, n = blockIdx.y, C1 = C + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* lg = logits + (size_t)n * A * C1;

  // softmax over all C + 1 logits, sequential sum, then the score floor
  for (int a = tid; a < A; a += kThreads) {
    const float* l = lg + (size_t)a * C1;
    float m = l[0];
    for (int j = 1; j < C1; ++j) m = fmaxf(m, l[j]);
    float s = 0.f, ec = 0.f;
    for (int j = 0; j < C1; ++j) {
      const float e = expf(__fsub_rn(l[j], m));
      s = __fadd_rn(s, e);
      if (j == c) ec = e;
    }
    const float p = __fdiv_rn(ec, s);
    s_score[a] = p > prm.score_thr ? p : 0.f;
  }
  __syncthreads();

  // top K by K rounds of block argmax
  for (int r = 0; r < K; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int a = tid; a < A; a += kThreads)
      if (better(s_score[a], a, bv, bi)) {
        bv = s_score[a];
        bi = a;
      }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kThreads / 32 ? red_v[lane] : -INFINITY;
      bi = lane < kThreads / 32 ? red_i[lane] : 0x7fffffff;
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_idx[r] = bi;
        s_top[r] = bv;
        s_score[bi] = -INFINITY;
      }
    }
    __syncthreads();
  }

  // decode the K selected boxes (coder.decode_boxes, DEFAULT_STDS)
  for (int t = tid; t < K; t += kThreads) {
    const int a = s_idx[t];
    const float* an = anchors + (size_t)a * 4;
    const float* d = deltas + ((size_t)n * A + a) * 4;
    const float d0 = __fmul_rn(d[0], 0.1f), d1 = __fmul_rn(d[1], 0.1f);
    const float d2 = __fmul_rn(d[2], 0.2f), d3 = __fmul_rn(d[3], 0.2f);
    const float aw = __fsub_rn(an[2], an[0]), ah = __fsub_rn(an[3], an[1]);
    const float acx = __fadd_rn(an[0], __fmul_rn(aw, 0.5f));
    const float acy = __fadd_rn(an[1], __fmul_rn(ah, 0.5f));
    const float cx = __fadd_rn(acx, __fmul_rn(d0, aw));
    const float cy = __fadd_rn(acy, __fmul_rn(d1, ah));
    const float lc = prm.log_clip;
    const float bw = __fmul_rn(aw, expf(fminf(fmaxf(d2, -lc), lc)));
    const float bh = __fmul_rn(ah, expf(fminf(fmaxf(d3, -lc), lc)));
    float* b = s_box + 4 * t;
    b[0] = __fsub_rn(cx, __fmul_rn(bw, 0.5f));
    b[1] = __fsub_rn(cy, __fmul_rn(bh, 0.5f));
    b[2] = __fadd_rn(cx, __fmul_rn(bw, 0.5f));
    b[3] = __fadd_rn(cy, __fmul_rn(bh, 0.5f));
  }
  __syncthreads();

  // NMS chain in warp 0
  if (warp == 0) {
    if (prm.inv_sigma > 0.f) {
      for (int j = lane; j < K; j += 32) {
        s_kept[j] = s_top[j];
        s_flag[j] = 0;
      }
      __syncwarp();
      for (int r = 0; r < K; ++r) {
        float bv = -INFINITY;
        int bi = 0x7fffffff;
        for (int j = lane; j < K; j += 32) {
          const float v = s_flag[j] ? -1.f : s_kept[j];
          if (better(v, j, bv, bi)) {
            bv = v;
            bi = j;
          }
        }
        warp_argmax(bv, bi);
        if (bv > 0.f) {
          for (int j = lane; j < K; j += 32) {
            if (s_flag[j] || j == bi) continue;
            const float o = iou(s_box + 4 * bi, s_box + 4 * j);
            const float dcy =
                o > prm.dup_iou
                    ? 0.f
                    : expf(__fmul_rn(-__fmul_rn(o, o), prm.inv_sigma));
            s_kept[j] = __fmul_rn(s_kept[j], dcy);
          }
        }
        __syncwarp();
        if (lane == 0) s_flag[bi] = 1;
        __syncwarp();
      }
      for (int j = lane; j < K; j += 32)
        s_kept[j] = s_kept[j] > prm.score_thr ? s_kept[j] : 0.f;
    } else {
      for (int j = lane; j < K; j += 32) s_flag[j] = s_top[j] > 0.f;
      __syncwarp();
      for (int i = 1; i < K; ++i) {
        bool sup = false;
        for (int j = lane; j < i; j += 32)
          sup |= s_flag[j] && iou(s_box + 4 * i, s_box + 4 * j) > prm.iou_thr;
        sup = __any_sync(0xffffffffu, sup);
        if (lane == 0 && sup) s_flag[i] = 0;
        __syncwarp();
      }
      for (int j = lane; j < K; j += 32)
        s_kept[j] = s_flag[j] ? s_top[j] : 0.f;
    }
  }
  __syncthreads();

  // box voting, then the class's K rows to the scratch output
  const size_t row0 = ((size_t)n * C + c) * K;
  for (int i = tid; i < K; i += kThreads) {
    const float* bi = s_box + 4 * i;
    float out[4] = {bi[0], bi[1], bi[2], bi[3]};
    if (prm.vote_iou > 0.f && s_kept[i] > 0.f) {
      float ws = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < K; ++j) {
        const float* bj = s_box + 4 * j;
        const float wgt = iou(bi, bj) > prm.vote_iou ? s_top[j] : 0.f;
        ws += wgt;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += wgt * bj[q];
      }
      const float den = fmaxf(ws, 1e-9f);
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q] = acc[q] / den;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) cls_boxes[(row0 + i) * 4 + q] = out[q];
    cls_scores[row0 + i] = s_kept[i];
  }
}

// one warp per image: global top max_det over the C*K class survivors
__global__ void merge_kernel(const float* __restrict__ cls_boxes,
                             const float* __restrict__ cls_scores,
                             float* __restrict__ out, int CK, int K,
                             int max_det) {
  extern __shared__ float s_sc[];  // [CK]
  const int n = blockIdx.x, lane = threadIdx.x;
  const float* sc = cls_scores + (size_t)n * CK;
  const float* bx = cls_boxes + (size_t)n * CK * 4;
  for (int j = lane; j < CK; j += 32) s_sc[j] = sc[j];
  __syncwarp();
  for (int r = 0; r < max_det; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = lane; j < CK; j += 32)
      if (better(s_sc[j], j, bv, bi)) {
        bv = s_sc[j];
        bi = j;
      }
    warp_argmax(bv, bi);
    if (lane == 0) {
      float* o = out + ((size_t)n * max_det + r) * 6;
      o[0] = bx[bi * 4 + 0];
      o[1] = bx[bi * 4 + 1];
      o[2] = bx[bi * 4 + 2];
      o[3] = bx[bi * 4 + 3];
      o[4] = bv;
      o[5] = (float)(bi / K);
      s_sc[bi] = -INFINITY;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int tpd_decode_nms(const void* logits, const void* deltas,
                              const void* anchors, void* cls_boxes,
                              void* cls_scores, void* out, int n, int a, int c,
                              int k, int max_det, float score_thr,
                              float iou_thr, float inv_sigma, float dup_iou,
                              float vote_iou, float log_clip, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params prm = {score_thr, iou_thr, inv_sigma, dup_iou, vote_iou,
                      log_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)(a + 8 * k) * 4;
  class_nms_kernel<<<dim3(c, n), kThreads, smem1, s>>>(
      static_cast<const float*>(logits), static_cast<const float*>(deltas),
      static_cast<const float*>(anchors), static_cast<float*>(cls_boxes),
      static_cast<float*>(cls_scores), a, c, k, prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<n, 32, (size_t)c * k * 4, s>>>(
      static_cast<const float*>(cls_boxes),
      static_cast<const float*>(cls_scores), static_cast<float*>(out), c * k,
      k, max_det);
  return (int)cudaGetLastError();
}
