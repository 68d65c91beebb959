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
// Bound on the H100: launch latency.  At B = 128 the function needs to
// read about 17 KB (the selected head's 18 pre-activations per crop,
// logits, boxes, dets) and write 13 KB: 9 ns at 3.35 TB/s, against a
// launch of a few microseconds.  One fused launch takes the place of the
// 8 small PyTorch kernels the serving path ran for this epilogue.
//
// Design: one thread per crop.  The thread averages and compares its C
// logits, then reads only the selected head's 18 values (36 with TTA), so
// the other 8 heads are never passed through the sigmoid.  Every float
// operation is the one PyTorch runs in the plain version
// (infer/epilogue.py), in the same order and rounding: the bf16 TTA sum is
// rounded to bf16 before it is halved, the sigmoid is 1/(1+exp(-x)) with
// an IEEE reciprocal, and products and sums use the round-to-nearest
// intrinsics so nothing is fused into a multiply-add.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

struct Params {
  int B, C, bf16_logits, tta, refine;
  float flip_c, w, h, margin, edge_grow, eps_lo, eps_hi, det_conf;
};

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float logit(const void* logits, int row, int c,
                                       const Params& p) {
  const size_t i = (size_t)row * p.C + c;
  return p.bf16_logits
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(logits)[i])
             : static_cast<const float*>(logits)[i];
}

// the TTA-averaged logit in the logits' dtype, as a float
__device__ __forceinline__ float avg_logit(const void* logits, int b, int c,
                                           const Params& p) {
  const float a = logit(logits, b, c, p);
  if (!p.tta) return a;
  const float s = __fadd_rn(a, logit(logits, b + p.B, c, p));
  if (!p.bf16_logits) return __fmul_rn(0.5f, s);
  const float sb = __bfloat162float(__float2bfloat16_rn(s));
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(0.5f, sb)));
}

__global__ void __launch_bounds__(kThreads)
head_epilogue_kernel(const float* __restrict__ pre, const void* logits,
                     const float* __restrict__ boxes,
                     const float* __restrict__ dets, float* __restrict__ out,
                     Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  // argmax: the first maximum wins; a NaN counts as the maximum, as in
  // torch.argmax
  float best = avg_logit(logits, b, 0, p);
  int label = 0;
  for (int c = 1; c < p.C; ++c) {
    const float v = avg_logit(logits, b, c, p);
    if (v > best || (v != v && best == best)) {
      best = v;
      label = c;
    }
  }
  const float* head = pre + ((size_t)b * 9 + label) * 18;
  const float* head_m = pre + ((size_t)(b + p.B) * 9 + label) * 18;
  float kp[18];
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    const float s = sigmoid(head[j]);
    if (!p.tta) {
      kp[j] = s;
    } else {
      float m = sigmoid(head_m[j]);
      if ((j & 1) == 0) m = __fsub_rn(p.flip_c, m);  // mirror x back
      kp[j] = __fmul_rn(0.5f, __fadd_rn(s, m));
    }
  }
  const float* box = boxes + (size_t)b * 4;
  if (p.refine) {
    const float bw = __fsub_rn(box[2], box[0]);
    const float bh = __fsub_rn(box[3], box[1]);
    float kmin[2] = {kp[0], kp[1]}, kmax[2] = {kp[0], kp[1]};
    float pmin[2], pmax[2];
    pmin[0] = pmax[0] = __fadd_rn(__fmul_rn(kp[0], bw), box[0]);
    pmin[1] = pmax[1] = __fadd_rn(__fmul_rn(kp[1], bh), box[1]);
#pragma unroll
    for (int k = 1; k < 9; ++k) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float v = kp[2 * k + a];
        const float px =
            __fadd_rn(__fmul_rn(v, a ? bh : bw), a ? box[1] : box[0]);
        kmin[a] = fminf(kmin[a], v);
        kmax[a] = fmaxf(kmax[a], v);
        pmin[a] = fminf(pmin[a], px);
        pmax[a] = fmaxf(pmax[a], px);
      }
    }
    float* o = out + (size_t)b * 4;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float side = a ? bh : bw, lim = a ? p.h : p.w;
      const float grow = fmaxf(__fmul_rn(p.edge_grow, side), p.margin);
      const float pad_lo = kmin[a] <= p.eps_lo ? grow : p.margin;
      const float pad_hi = kmax[a] >= p.eps_hi ? grow : p.margin;
      const float lo = fminf(fmaxf(__fsub_rn(pmin[a], pad_lo), 0.f),
                             __fsub_rn(lim, 1.f));
      const float hi = fminf(fmaxf(__fadd_rn(pmax[a], pad_hi), 0.f), lim);
      o[a] = lo;
      o[2 + a] = fmaxf(hi, __fadd_rn(lo, 1.f));
    }
    return;
  }
  const float* det = dets + (size_t)b * 6;
  float* o = out + (size_t)b * 26;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = box[j];
  o[4] = det[4];
  o[5] = det[5];
#pragma unroll
  for (int j = 0; j < 18; ++j) o[6 + j] = kp[j];
  o[24] = (float)label;
  o[25] = det[4] > p.det_conf ? 1.f : 0.f;
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
  head_epilogue_kernel<<<tpd::ceil_div(b, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), logits,
      static_cast<const float*>(boxes), static_cast<const float*>(dets),
      static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}
