// K1 preprocess_resize: uint8 NHWC frames -> antialiased bilinear resize,
// optional BGR->RGB reversal and a scale (1/255 on the serving path), stored
// as bf16 or f32 NHWC (= a channels_last NCHW tensor for the detector).
//
// Replaces: the JAX serving program's preprocessing,
//   tpudet3d/infer/engine.py:218-221 (frame[..., ::-1], resize, / 255) over
//   tpudet3d/ops/image.py:19-28 resize_bilinear = jax.image.resize(...,
//   'bilinear'), whose default antialias=True widens the triangle filter by
//   the downscale factor (support 2.4 rows x 4.27 columns for 720p -> 300^2)
//   and normalises the weights of each output pixel per axis.
//
// Bound on the H100: bytes.  At batch 16 of 720p it must read 44.2 MB of
// uint8 and write 8.6 MB of bf16: about 16 us at 3.35 TB/s.  It does about
// 45 multiply-adds per output channel, far below any compute limit.
//
// Design: one thread per output pixel, all three channels.  The frame is
// read as uint8 directly (no float frame is ever materialised) and the
// channel reversal is index arithmetic.  Each thread computes its triangle
// weights and the two per-axis normalisers itself and accumulates in f32.
// Neighbouring threads read overlapping windows, which L1/L2 serve; the
// separable two-pass form that would read each byte once is for a later PR.
#include "common.cuh"

namespace {

template <typename T>
__global__ void resize_bilinear_u8_kernel(const uint8_t* __restrict__ in,
                                          T* __restrict__ out, int h, int w,
                                          int oh, int ow, float inv_sy,
                                          float inv_sx, int reverse,
                                          float scale) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  if (ox >= ow) return;
  // jax.image.resize: sample = (o + 0.5) * inv_scale - 0.5, filter width
  // max(inv_scale, 1), weight = max(0, 1 - |sample - i| / width)
  const float ky = fmaxf(inv_sy, 1.f), kx = fmaxf(inv_sx, 1.f);
  const float sy = __fsub_rn(__fmul_rn(oy + 0.5f, inv_sy), 0.5f);
  const float sx = __fsub_rn(__fmul_rn(ox + 0.5f, inv_sx), 0.5f);
  const int y_lo = max(0, (int)ceilf(sy - ky));
  const int y_hi = min(h - 1, (int)floorf(sy + ky));
  const int x_lo = max(0, (int)ceilf(sx - kx));
  const int x_hi = min(w - 1, (int)floorf(sx + kx));
  float ty = 0.f, tx = 0.f;
  for (int i = y_lo; i <= y_hi; ++i)
    ty += fmaxf(0.f, 1.f - fabsf(sy - (float)i) / ky);
  for (int j = x_lo; j <= x_hi; ++j)
    tx += fmaxf(0.f, 1.f - fabsf(sx - (float)j) / kx);
  const uint8_t* img = in + (size_t)n * h * w * 3;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int i = y_lo; i <= y_hi; ++i) {
    const float wy = fmaxf(0.f, 1.f - fabsf(sy - (float)i) / ky);
    const uint8_t* row = img + (size_t)i * w * 3;
    float r[3] = {0.f, 0.f, 0.f};
    for (int j = x_lo; j <= x_hi; ++j) {
      const float wx = fmaxf(0.f, 1.f - fabsf(sx - (float)j) / kx);
      const uint8_t* p = row + j * 3;
      r[0] += wx * (float)p[0];
      r[1] += wx * (float)p[1];
      r[2] += wx * (float)p[2];
    }
    acc[0] += wy * r[0];
    acc[1] += wy * r[1];
    acc[2] += wy * r[2];
  }
  const float norm = scale / (ty * tx);
  T* o = out + (((size_t)n * oh + oy) * ow + ox) * 3;
  o[0] = tpd::from_float<T>(acc[reverse ? 2 : 0] * norm);
  o[1] = tpd::from_float<T>(acc[1] * norm);
  o[2] = tpd::from_float<T>(acc[reverse ? 0 : 2] * norm);
}

}  // namespace

extern "C" int tpd_resize_bilinear_u8(const void* in, void* out, int n, int h,
                                      int w, int oh, int ow, float inv_sy,
                                      float inv_sx, int reverse, float scale,
                                      int out_bf16, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(128);
  const dim3 grid(tpd::ceil_div(ow, block.x), oh, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (out_bf16)
    resize_bilinear_u8_kernel<<<grid, block, 0, s>>>(
        src, static_cast<__nv_bfloat16*>(out), h, w, oh, ow, inv_sy, inv_sx,
        reverse, scale);
  else
    resize_bilinear_u8_kernel<<<grid, block, 0, s>>>(
        src, static_cast<float*>(out), h, w, oh, ow, inv_sy, inv_sx, reverse,
        scale);
  return (int)cudaGetLastError();
}
