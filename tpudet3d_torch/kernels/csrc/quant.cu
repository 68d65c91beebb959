// K6 quantize_input and K7 int8_rescale: the two elementwise halves of the
// int8 convolution of int8 serving (ops/quant.py int8_conv); the int8
// product between them is torch._int_mm.
//
// Replaces: tpudet3d/infer/quant.py quant_interceptor, :158-160 (K6: the
//   input quantized per tensor, with the conv's zero padding) and
//   :171-177 (K7: the int32 sums cast, scaled per channel, plus the bias).
//
// K6: x [N,C,H,W] f32 or bf16, read through its strides (channels-last on
// the serving path) -> int8 [M, Kp], M = N*Ho*Wo rows of the conv's taps
// in the weight's [ky, kx, c] order, each clip(rint(x * inv), -127, 127)
// with inv = 127/s_x rounded to f32 on the host; taps outside the frame
// and columns K..Kp-1 are 0.  K7: int32 [M, Np] -> [M, N] f32 or bf16:
// each sum cast to the output dtype, times the channel's scale cast to
// it, plus the channel's bias cast to it, each result rounded to the
// output dtype (JAX's order: cast, multiply, add).
//
// Bound on the H100: bytes.  Both read and write each element once and do
// a handful of operations on it.  At the largest quantized conv of the
// serving call (the detector's first 1x1 convs at 150x150, batch 16:
// 360,000 rows of 32 bf16 channels) K6 moves 35 MB (10 us at 3.35 TB/s);
// the regressor's 1x1 convs at 112x112 move up to 30 MB a crop batch.
//
// Design: one thread per 16 output bytes (K6: 16 taps of a row, Kp is a
// multiple of 16; K7: 8 channels of a row).  K6 walks its 16 taps with a
// running (ky, kx, c) so no tap costs a division, loads each through the
// strides (neighbouring threads read neighbouring channels, so a warp's
// loads of a 1x1 conv's rows are contiguous), and packs the 16 bytes into
// one 16-byte store.  K7 loads its 8 sums as two 16-byte loads and stores
// 8 outputs as one or two 16-byte stores where the widths allow it, else
// element by element.  Products and sums use the round-to-nearest
// intrinsics, so nothing is fused and both agree with the plain PyTorch
// versions bit for bit.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct QuantParams {
  int n, c, h, w;
  long long sn, sc, sy, sx;  // element strides of x
  int kh, kw, sh, sw, ph, pw, ho, wo;
  int k, kp, m;
  float inv;
};

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_input_kernel(const T* __restrict__ x, int8_t* __restrict__ out,
                      QuantParams p) {
  const int chunks = p.kp >> 4;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)p.m * chunks) return;
  const int row = (int)(t / chunks), chunk = (int)(t % chunks);
  const int ox = row % p.wo, oy = (row / p.wo) % p.ho,
            n = row / (p.wo * p.ho);
  const int k0 = chunk << 4;
  int tap = k0 / p.c, ci = k0 - tap * p.c;
  int ky = tap / p.kw, kx = tap - ky * p.kw;
  const T* base = x + n * p.sn;
  const int iy0 = oy * p.sh - p.ph, ix0 = ox * p.sw - p.pw;
  unsigned words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int q = 0;
    const int iy = iy0 + ky, ix = ix0 + kx;
    if (k0 + j < p.k && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
      const float v = load_float(base + ci * p.sc + iy * p.sy + ix * p.sx);
      q = (int)fminf(fmaxf(rintf(__fmul_rn(v, p.inv)), -127.f), 127.f);
    }
    words[j >> 2] |= (unsigned)(q & 0xff) << ((j & 3) * 8);
    if (++ci == p.c) {
      ci = 0;
      if (++kx == p.kw) {
        kx = 0;
        ++ky;
      }
    }
  }
  *reinterpret_cast<uint4*>(out + (size_t)row * p.kp + k0) =
      make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ float round_to(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
int8_rescale_kernel(const int* __restrict__ y, const float* __restrict__ scale,
                    const float* __restrict__ bias, void* __restrict__ out,
                    int m, int n, int np, int vec) {
  using Out = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  const int chunks = (n + 7) >> 3;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)m * chunks) return;
  const int row = (int)(t / chunks), c0 = (int)(t % chunks) << 3;
  const int* src = y + (size_t)row * np + c0;
  Out* dst = static_cast<Out*>(out) + (size_t)row * n + c0;
  int sums[8];
  if (vec) {
    const int4 a = *reinterpret_cast<const int4*>(src);
    const int4 b = *reinterpret_cast<const int4*>(src + 4);
    sums[0] = a.x; sums[1] = a.y; sums[2] = a.z; sums[3] = a.w;
    sums[4] = b.x; sums[5] = b.y; sums[6] = b.z; sums[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) sums[j] = c0 + j < n ? src[j] : 0;
  }
  alignas(16) Out vals[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = min(c0 + j, n - 1);
    float v = round_to(__int2float_rn(sums[j]), kBf16);
    v = round_to(__fmul_rn(v, round_to(scale[c], kBf16)), kBf16);
    if (bias != nullptr)
      v = round_to(__fadd_rn(v, round_to(bias[c], kBf16)), kBf16);
    vals[j] = tpd::from_float<Out>(v);
  }
  if (vec) {
    const uint4* v4 = reinterpret_cast<const uint4*>(vals);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(vals) / 16); ++i) d4[i] = v4[i];
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < n) dst[j] = vals[j];
  }
}

unsigned grid_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int tpd_quantize_input(const void* x, void* out, int bf16, int n,
                                  int c, int h, int w, int sn, int sc, int sy,
                                  int sx, int kh, int kw, int sh, int sw,
                                  int ph, int pw, int ho, int wo, int kp,
                                  float inv, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kp % 16 != 0 || kp < kh * kw * c) return (int)cudaErrorInvalidValue;
  const QuantParams p = {n,  c,  h,  w,  sn, sc, sy, sx, kh, kw,
                         sh, sw, ph, pw, ho, wo, kh * kw * c, kp,
                         n * ho * wo, inv};
  const unsigned grid = grid_for((long long)p.m * (kp / 16));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    quantize_input_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(out), p);
  else
    quantize_input_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(out), p);
  return (int)cudaGetLastError();
}

extern "C" int tpd_int8_rescale(const void* y, const void* scale,
                                const void* bias, void* out, int m, int n,
                                int np, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || np < n) return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores need whole groups of 8 in both widths
  const int vec = (n % 8 == 0) && (np % 8 == 0);
  const unsigned grid = grid_for((long long)m * ((n + 7) / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* yi = static_cast<const int*>(y);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (bf16)
    int8_rescale_kernel<true><<<grid, kThreads, 0, s>>>(yi, sc, bi, out, m, n,
                                                         np, vec);
  else
    int8_rescale_kernel<false><<<grid, kThreads, 0, s>>>(yi, sc, bi, out, m,
                                                          n, np, vec);
  return (int)cudaGetLastError();
}
