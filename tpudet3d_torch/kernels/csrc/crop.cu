// K2 crop_resize_normalize: for every box, a bilinear crop-resize of its
// uint8 NHWC frame to oh x ow, optional BGR->RGB reversal, per-channel
// x * scale - offset, stored as bf16 or f32 NHWC; with ``mirror`` the
// horizontally mirrored copy of every crop is written in the same launch
// (the TTA batch: all originals, then all mirrors).
//
// Replaces: tpudet3d/ops/image.py:86-139 crop_and_resize (two dense
//   interpolation matmuls per crop, a TPU choice) with the semantics of its
//   gather form crop_and_resize_gather (:59-75): cv2 pixel-centre sampling
//   src = (dst + 0.5) * (box / out) - 0.5 + x0, box side floored at 1 px,
//   source coordinate clamped to the frame (border), no antialias; plus the
//   normalisation and TTA concat of tpudet3d/infer/engine.py:254-266.
//
// Bound on the H100: bytes.  128 crops of 224^2 at batch 16: at most the
// 44.2 MB of frames read once and 38.5 MB of bf16 crops written, about
// 25 us at 3.35 TB/s; the four taps of a pixel are 12 bytes, all from L2.
//
// Design: one thread per output pixel of one crop (grid.y = box), four
// uint8 taps per channel, f32 arithmetic, one bf16 store per channel.  The
// box is read from device memory in the kernel, so the host never waits
// for the detector's output.
#include "common.cuh"

namespace {

struct Norm {
  float s[3];
  float o[3];
};

template <typename T>
__global__ void crop_resize_u8_kernel(const uint8_t* __restrict__ frames,
                                      const float* __restrict__ boxes,
                                      T* __restrict__ out, int h, int w,
                                      int k, int oh, int ow, float inv_oh,
                                      float inv_ow, int n_boxes, int reverse,
                                      Norm nm, int mirror) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= oh * ow) return;
  const int oy = p / ow, ox = p - oy * ow;
  const float* bx = boxes + (size_t)b * 4;
  const float x0 = bx[0], y0 = bx[1], x1 = bx[2], y1 = bx[3];
  const float bw = fmaxf(x1 - x0, 1.f), bh = fmaxf(y1 - y0, 1.f);
  // (dst + 0.5) * (side / out) - 0.5 + start rounded as XLA computes it
  // (and the plain version repeats): the division as a product with the
  // f32 reciprocal, the multiply and -0.5 as one fused multiply-add
  float sy = __fadd_rn(fmaf(oy + 0.5f, __fmul_rn(bh, inv_oh), -0.5f), y0);
  float sx = __fadd_rn(fmaf(ox + 0.5f, __fmul_rn(bw, inv_ow), -0.5f), x0);
  sy = fminf(fmaxf(sy, 0.f), (float)(h - 1));
  sx = fminf(fmaxf(sx, 0.f), (float)(w - 1));
  const float fy = floorf(sy), fx = floorf(sx);
  const int iy0 = (int)fy, ix0 = (int)fx;
  const int iy1 = min(iy0 + 1, h - 1), ix1 = min(ix0 + 1, w - 1);
  const float wy = sy - fy, wx = sx - fx;
  const uint8_t* img = frames + (size_t)(b / k) * h * w * 3;
  const uint8_t* p00 = img + ((size_t)iy0 * w + ix0) * 3;
  const uint8_t* p01 = img + ((size_t)iy0 * w + ix1) * 3;
  const uint8_t* p10 = img + ((size_t)iy1 * w + ix0) * 3;
  const uint8_t* p11 = img + ((size_t)iy1 * w + ix1) * 3;
  T* o = out + (((size_t)b * oh + oy) * ow + ox) * 3;
  T* om = out + (((size_t)(n_boxes + b) * oh + oy) * ow + (ow - 1 - ox)) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int sc = reverse ? 2 - c : c;
    const float top = (1.f - wx) * (float)p00[sc] + wx * (float)p01[sc];
    const float bot = (1.f - wx) * (float)p10[sc] + wx * (float)p11[sc];
    const float v = ((1.f - wy) * top + wy * bot) * nm.s[c] - nm.o[c];
    const T t = tpd::from_float<T>(v);
    o[c] = t;
    if (mirror) om[c] = t;
  }
}

}  // namespace

extern "C" int tpd_crop_resize_u8(const void* frames, const void* boxes,
                                  void* out, int n, int h, int w, int k,
                                  int oh, int ow, float inv_oh, float inv_ow,
                                  int reverse, float s0,
                                  float s1, float s2, float o0, float o1,
                                  float o2, int mirror, int out_bf16,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Norm nm = {{s0, s1, s2}, {o0, o1, o2}};
  const int n_boxes = n * k;
  const dim3 block(256);
  const dim3 grid(tpd::ceil_div(oh * ow, block.x), n_boxes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* bx = static_cast<const float*>(boxes);
  if (out_bf16)
    crop_resize_u8_kernel<<<grid, block, 0, s>>>(
        f, bx, static_cast<__nv_bfloat16*>(out), h, w, k, oh, ow, inv_oh,
        inv_ow, n_boxes, reverse, nm, mirror);
  else
    crop_resize_u8_kernel<<<grid, block, 0, s>>>(
        f, bx, static_cast<float*>(out), h, w, k, oh, ow, inv_oh, inv_ow,
        n_boxes, reverse, nm, mirror);
  return (int)cudaGetLastError();
}
