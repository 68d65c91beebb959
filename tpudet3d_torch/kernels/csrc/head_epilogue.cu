// K4 head_epilogue: the regressor-head epilogue of one serving pass over B
// crops.  From the pre-activation head output [B',9,18] f32 (bias added)
// and the class logits [B',C] (f32 or bf16), B' = 2B with flip TTA
// (originals, then their mirrors): sigmoid, TTA mirror-average, class
// argmax (lower index on ties), head select, then either the next pass's
// crop boxes (refine) -> f32 [B,4] or the packed rows -> f32 [B,26]
// (boxes, score, det label, kp[18], reg label, conf_mask).
//
// Replaces: tpudet3d/models/wrapper.py:61-64 (export sigmoid) and in
//   tpudet3d/infer/engine.py :33-48 tta_flip_average, :54-77
//   refine_boxes, :270-276 argmax + head gather, :291-300 the pack.
//
// Bound on the H100: the launch plus one round trip to memory, not bytes.
// At B = 128 the function needs 17 KB (the selected head of each crop,
// logits, boxes, dets) and writes 13 KB: 9 ns at 3.35 TB/s; this kernel
// reads every crop's 9 heads, 100 KB in all (34 ns), against a launch of
// a few microseconds and a dependent load of about half a microsecond.
//
// Design: one warp per crop, kWarps crops per CTA (32 CTAs at B = 128).
// Every load the crop needs is issued first and at once: its whole
// 162-float pre-activation row (and its mirror's, with TTA) by all 32
// lanes into a per-warp shared buffer, its C logits (and the mirror's) on
// lanes 0..C-1, its box and detection.  So the head select waits on no
// second round trip: the argmax is one warp reduction (the largest of
// order-preserving keys, then a ballot for its lowest lane), and lane
// j < 18 then reads the selected head's value j from shared memory.
// Refine mode reduces the 9 keypoints' extents by fminf /
// fmaxf shuffles within each parity of lanes (x on even lanes, y on odd);
// pack mode writes the crop's 26 floats from lanes 0..25 in one coalesced
// store.  Every float operation is the one PyTorch runs in the plain
// version (infer/epilogue.py), in the same order and rounding: the bf16
// TTA sum is rounded to bf16 before it is halved, the sigmoid is
// 1/(1+exp(-x)) with an IEEE reciprocal, and products and sums use the
// round-to-nearest intrinsics so nothing is fused into a multiply-add.
// The min / max reductions are order-free, so the kernel agrees with the
// plain version bit for bit.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;           // crops per CTA, one warp each
constexpr int kRow = 9 * 18;        // pre-activations of one crop
constexpr int kLoads = (kRow + 31) / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int B, C, bf16_logits, tta, refine;
  float flip_c, w, h, margin, edge_grow, eps_lo, eps_hi, det_conf;
};

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float logit(const void* logits, size_t i,
                                       int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(logits)[i])
              : static_cast<const float*>(logits)[i];
}

// the TTA-averaged logit in the logits' dtype, as a float
__device__ __forceinline__ float avg_logit(float a, float m,
                                           const Params& p) {
  if (!p.tta) return a;
  const float s = __fadd_rn(a, m);
  if (!p.bf16_logits) return __fmul_rn(0.5f, s);
  const float sb = __bfloat162float(__float2bfloat16_rn(s));
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(0.5f, sb)));
}

// a key whose unsigned order is torch.argmax's order of the values: every
// NaN above +inf, -0.0 equal to +0.0, and every key above 0
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kWarps * 32)
head_epilogue_kernel(const float* __restrict__ pre, const void* logits,
                     const float* __restrict__ boxes,
                     const float* __restrict__ dets, float* __restrict__ out,
                     Params p) {
  __shared__ float rows[kWarps][2][kRow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= p.B) return;  // the whole warp leaves together

  // 1. every load of the crop, before any value is used
  const float* row = pre + (size_t)b * kRow;
  const float* row_m = pre + (size_t)(b + p.B) * kRow;
  float r[kLoads], rm[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = lane + 32 * k;
    r[k] = i < kRow ? row[i] : 0.f;
    rm[k] = p.tta && i < kRow ? row_m[i] : 0.f;
  }
  float a = 0.f, m = 0.f;
  if (lane < p.C) {
    a = logit(logits, (size_t)b * p.C + lane, p.bf16_logits);
    if (p.tta) m = logit(logits, (size_t)(b + p.B) * p.C + lane,
                         p.bf16_logits);
  }
  const float* box = boxes + (size_t)b * 4;
  float bx[4] = {0.f, 0.f, 0.f, 0.f};
  float own = 0.f;  // pack mode: the input value that lane writes
  if (p.refine) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bx[j] = box[j];
  } else if (lane < 4) {
    own = box[lane];
  } else if (lane == 4 || lane == 5 || lane == 25) {
    own = dets[(size_t)b * 6 + (lane == 5 ? 5 : 4)];
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = lane + 32 * k;
    if (i < kRow) {
      rows[warp][0][i] = r[k];
      if (p.tta) rows[warp][1][i] = rm[k];
    }
  }

  // 2. argmax over the classes, lane c holding class c (lanes >= C key 0):
  // the warp's largest key, and of the lanes that hold it the lowest, so
  // the first NaN, else the first maximum, as torch.argmax
  const unsigned key = lane < p.C ? order_key(avg_logit(a, m, p)) : 0u;
  const unsigned top = __reduce_max_sync(kFull, key);
  const int label = __ffs(__ballot_sync(kFull, key == top)) - 1;
  __syncwarp();

  // 3. lane j < 18 takes the selected head's value j; the other lanes carry
  // NaN, which fminf and fmaxf pass over
  float kp = NAN;
  if (lane < 18) {
    const float s = sigmoid(rows[warp][0][label * 18 + lane]);
    if (!p.tta) {
      kp = s;
    } else {
      float mm = sigmoid(rows[warp][1][label * 18 + lane]);
      if ((lane & 1) == 0) mm = __fsub_rn(p.flip_c, mm);  // mirror x back
      kp = __fmul_rn(0.5f, __fadd_rn(s, mm));
    }
  }

  if (p.refine) {
    // 4a. axis lane & 1: the keypoints' extent in the crop and in pixels
    const int ax = lane & 1;
    const float side = ax ? __fsub_rn(bx[3], bx[1]) : __fsub_rn(bx[2], bx[0]);
    float kmin = kp, kmax = kp;
    float pmin = __fadd_rn(__fmul_rn(kp, side), ax ? bx[1] : bx[0]);
    float pmax = pmin;
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
      kmin = fminf(kmin, __shfl_xor_sync(kFull, kmin, off));
      kmax = fmaxf(kmax, __shfl_xor_sync(kFull, kmax, off));
      pmin = fminf(pmin, __shfl_xor_sync(kFull, pmin, off));
      pmax = fmaxf(pmax, __shfl_xor_sync(kFull, pmax, off));
    }
    // lanes 0, 1 write lo (x, y), lanes 2, 3 hi
    if (lane < 4) {
      const float lim = ax ? p.h : p.w;
      const float grow = fmaxf(__fmul_rn(p.edge_grow, side), p.margin);
      const float pad_lo = kmin <= p.eps_lo ? grow : p.margin;
      const float pad_hi = kmax >= p.eps_hi ? grow : p.margin;
      const float lo = fminf(fmaxf(__fsub_rn(pmin, pad_lo), 0.f),
                             __fsub_rn(lim, 1.f));
      const float hi = fminf(fmaxf(__fadd_rn(pmax, pad_hi), 0.f), lim);
      out[(size_t)b * 4 + lane] =
          lane < 2 ? lo : fmaxf(hi, __fadd_rn(lo, 1.f));
    }
    return;
  }
  // 4b. the packed row: box(4), score, det label, kp(18), label, conf_mask
  const float kp_at = __shfl_up_sync(kFull, kp, 6);
  if (lane < 26) {
    float v = own;
    if (lane >= 6 && lane < 24) v = kp_at;
    if (lane == 24) v = (float)label;
    if (lane == 25) v = own > p.det_conf ? 1.f : 0.f;
    out[(size_t)b * 26 + lane] = v;
  }
}

}  // namespace

extern "C" int tpd_head_epilogue(const void* pre, const void* logits,
                                 const void* boxes, const void* dets,
                                 void* out, int b, int c, int bf16_logits,
                                 int tta, float flip_c, int refine, float w,
                                 float h, float margin, float edge_grow,
                                 float eps_lo, float eps_hi, float det_conf,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p = {b, c, bf16_logits, tta, refine, flip_c, w, h, margin,
                    edge_grow, eps_lo, eps_hi, det_conf};
  head_epilogue_kernel<<<tpd::ceil_div(b, kWarps), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), logits,
      static_cast<const float*>(boxes), static_cast<const float*>(dets),
      static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}
