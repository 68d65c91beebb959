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
// Design: one CTA per output tile of tile_y x tile_x pixels of one frame
// (16 x 32 where it fits; ops/image.py resize_plan shrinks tile_y for large
// downscales), all three channels, in four steps:
//   1. stage the tile's input footprint in shared memory once: 16-byte
//      cp.async copies of the aligned chunks that hold a row's bytes (the
//      bytes around a row's ends are staged too, and never read), single
//      bytes only where a chunk would leave the frames' tensor, so any
//      base and row stride is taken.  The footprint starts at a column
//      that is a multiple of 4, so that rows whose start is 4-byte aligned
//      in memory (any frame whose width is a multiple of 4) are read as
//      aligned words;
//   2. meanwhile build one tap table per axis: for each output row its
//      (weight, staged row offset) pairs, for each output column its
//      weights laid out from the float4 of its first staged column.  The
//      weights are normalised per axis as resize_weights does (total, eps
//      rule, inside mask), with reciprocals: built with IEEE divisions the
//      tables cost as much as the staging;
//   3. vertical pass: one (tile row, 4 input pixels) per thread, three
//      32-bit shared loads and one table load per tap, into an f32
//      intermediate of one plane per channel, [3][tile_y][cols], stored as
//      float4s (the plain version also reduces along y first);
//   4. horizontal pass: one output pixel per thread, float4 loads of its
//      weights (zero-padded to whole float4s) and of each channel plane, x
//      scale, rounded once.  The channel reversal is index arithmetic here.
// Each input byte leaves device memory once, apart from the halo rows and
// columns that neighbouring tiles share, and the staging alone runs at the
// byte bound; the two passes take most of the time, issuing instructions
// and shared-memory loads (PERF.md).  So the vertical pass multiplies
// each byte as the denormal float of the same bits (x * 2^-149) by its
// weight scaled by 2^126, and scales the sum by 2^23: every rounding is the
// one of w * x, and a byte costs a permute and a fused multiply-add, with
// no conversion besides.  (Denormals are kept: the kernels are built
// without flush-to-zero.)
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColAlign = 4;  // ops/image.py K1_COL_ALIGN

// Byte offsets in one CTA's dynamic shared memory.  ops/image.py
// resize_footprint computes the same total; the entry point checks that
// the two agree.
struct Layout {
  int tile_y, tile_x, rows, cols, taps_y, taps_x;
  int stage_stride;  // bytes per staged row: a multiple of 16 that leaves
                     // room for a row's shift (< 16) and the 4-pixel group
                     // reads past its end
  int inter_stride;  // floats per row of a plane of the intermediate
  int taps_x4;       // x weights per output column, padded to float4s
  int xw, ytab, ny, x4, stage, bytes;
};

int align16(int v) { return (v + 15) & ~15; }

Layout make_layout(int tile_y, int tile_x, int rows, int cols, int taps_y,
                   int taps_x) {
  Layout l{tile_y, tile_x, rows, cols, taps_y, taps_x};
  l.stage_stride = align16(cols * 3 + 29);
  // a column's taps start up to 3 columns into their first float4, and
  // the last column's float4s reach taps_x4 - 1 columns past it
  l.taps_x4 = (taps_x + 3 + 3) / 4 * 4;
  l.inter_stride = (cols + l.taps_x4 - 1 + 3) & ~3;
  int off = 3 * tile_y * l.inter_stride * 4;  // the f32 intermediate first
  l.xw = off;
  off += tile_x * l.taps_x4 * 4;
  l.ytab = off;
  off += tile_y * taps_y * 8;
  l.ny = off;
  off += tile_y * 4;
  l.x4 = off;
  off += tile_x * 4;
  l.stage = align16(off);
  l.bytes = l.stage + rows * l.stage_stride;
  return l;
}

// jax.image.resize's sample position of output o, rounded as the plain
// version rounds it: (o + 0.5) * inv_scale - 0.5, no contraction.
__device__ __forceinline__ float sample_at(int o, float inv) {
  return __fsub_rn(__fmul_rn((float)o + 0.5f, inv), 0.5f);
}

// First and last input index of the filter window around s; outside it
// every weight is 0.
__device__ __forceinline__ int window_lo(float s, float k) {
  return max(0, (int)ceilf(__fsub_rn(s, k)));
}
__device__ __forceinline__ int window_hi(float s, float k, int n) {
  return min(n - 1, (int)floorf(__fadd_rn(s, k)));
}

// The triangle filter max(0, 1 - |s - i| / k), with 1/k given.
__device__ __forceinline__ float tap_weight(float s, int i, float inv_k) {
  return fmaxf(0.f, 1.f - fabsf(s - (float)i) * inv_k);
}

// The taps of output o of an axis of n inputs whose tile staged the inputs
// [origin, origin + staged): emit(q, weight, staged index) for each, and
// their count.  Two reciprocals and no division: the weights differ from
// resize_weights' quotients by an ulp or so.
template <typename Emit>
__device__ int build_taps(int o, int n, float inv, float k, int taps,
                          int origin, int staged, Emit emit) {
  const float s = sample_at(o, inv);
  const int lo = window_lo(s, k);
  const int cnt = max(0, min(min(window_hi(s, k, n) - lo + 1, taps),
                             origin + staged - lo));
  const float inv_k = __frcp_rn(k);
  float total = 0.f;
  for (int q = 0; q < cnt; ++q) total += tap_weight(s, lo + q, inv_k);
  const bool keep = fabsf(total) > 1000.f * FLT_EPSILON && s >= -0.5f &&
                    s <= (float)n - 0.5f;
  const float norm = keep ? __frcp_rn(total) : 0.f;
  for (int q = 0; q < cnt; ++q)
    emit(q, tap_weight(s, lo + q, inv_k) * norm, lo - origin + q);
  return cnt;
}

// The 12 bytes at p[off..off+11] as three words, aligned or not.
__device__ __forceinline__ void load12(const uint8_t* p, int off,
                                       unsigned v[3]) {
  const unsigned* w = reinterpret_cast<const unsigned*>(p + (off & ~3));
  if ((off & 3) == 0) {
    v[0] = w[0];
    v[1] = w[1];
    v[2] = w[2];
    return;
  }
  const unsigned w3 = w[3], sh = 8 * (off & 3);
  v[0] = __funnelshift_r(w[0], w[1], sh);
  v[1] = __funnelshift_r(w[1], w[2], sh);
  v[2] = __funnelshift_r(w[2], w3, sh);
}

// Byte b of v as the denormal float of the same bits, b * 2^-149.
__device__ __forceinline__ float byte_denormal(unsigned v, int b) {
  return __uint_as_float(__byte_perm(v, 0u, 0x4440 | b));
}

// acc + w.x * p.x + w.y * p.y + w.z * p.z + w.w * p.w, in that order
__device__ __forceinline__ float dot4(float4 w, float4 p, float acc) {
  acc = fmaf(w.x, p.x, acc);
  acc = fmaf(w.y, p.y, acc);
  acc = fmaf(w.z, p.z, acc);
  return fmaf(w.w, p.w, acc);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 CTAs an SM: as many as the shared memory of a 16-row tile allows
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    resize_tiled_u8_kernel(const uint8_t* __restrict__ in,
                           T* __restrict__ out, int h, int w, int oh, int ow,
                           float inv_y, float inv_x, int reverse, float scale,
                           Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* inter = reinterpret_cast<float*>(smem);
  float* xw = reinterpret_cast<float*>(smem + l.xw);
  float2* ytab = reinterpret_cast<float2*>(smem + l.ytab);
  int* ny = reinterpret_cast<int*>(smem + l.ny);
  int* x4 = reinterpret_cast<int*>(smem + l.x4);
  uint8_t* stage = smem + l.stage;

  const int oy0 = blockIdx.y * l.tile_y, ox0 = blockIdx.x * l.tile_x;
  const int ty_n = min(l.tile_y, oh - oy0), tx_n = min(l.tile_x, ow - ox0);
  const float ky = fmaxf(inv_y, 1.f), kx = fmaxf(inv_x, 1.f);
  // the tile's footprint: input rows [r0, r0 + n_rows), columns
  // [c0, c0 + n_cols); the windows move monotonically with the output
  const int r0 = window_lo(sample_at(oy0, inv_y), ky);
  const int n_rows = max(0, min(window_hi(sample_at(oy0 + ty_n - 1, inv_y),
                                          ky, h) - r0 + 1, l.rows));
  const int c0 = window_lo(sample_at(ox0, inv_x), kx) & ~(kColAlign - 1);
  const int n_cols = max(0, min(window_hi(sample_at(ox0 + tx_n - 1, inv_x),
                                          kx, w) - c0 + 1, l.cols));
  const int row_bytes = n_cols * 3;
  const size_t frame_bytes = (size_t)h * w * 3;
  const uint8_t* img = in + blockIdx.z * frame_bytes;
  const uint8_t* in_end = in + gridDim.z * frame_bytes;
  // staged row r's byte j lands at stage[r * stride + shift(r) + j], where
  // shift(r) is the row start's offset in its 16-byte chunk
  auto row_start = [&](int r) {
    return img + ((size_t)(r0 + r) * w + c0) * 3;
  };
  auto shift = [&](int r) {
    return (int)(reinterpret_cast<uintptr_t>(row_start(r)) & 15);
  };

  // 1. stage
  const int chunks = (row_bytes + 30) / 16;
  for (int i = threadIdx.x; i < n_rows * chunks; i += kThreads) {
    const int r = i / chunks, q = i - r * chunks;
    const int lo = 16 * q - shift(r);  // the chunk's first byte in the row
    if (lo >= row_bytes) continue;
    const uint8_t* a = row_start(r) + lo;
    uint8_t* d = stage + r * l.stage_stride + 16 * q;
    if (a >= in && a + 16 <= in_end) {
      cp_async16(d, a);
    } else {
      // a chunk that would leave the tensor: its bytes inside the row one
      // by one, all loads issued before any store
      uint8_t v[16];
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (lo + b >= 0 && lo + b < row_bytes) v[b] = a[b];
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (lo + b >= 0 && lo + b < row_bytes) d[b] = v[b];
    }
  }
  // 2. tap tables, while the copies fly.  The y weights carry 2^126 for
  // the vertical pass's denormal bytes.
  const int stride = l.stage_stride;
  for (int t = threadIdx.x; t < ty_n + tx_n; t += kThreads) {
    if (t < ty_n) {
      float2* tab = ytab + t * l.taps_y;
      ny[t] = build_taps(oy0 + t, h, inv_y, ky, l.taps_y, r0, n_rows,
                         [&](int q, float wt, int r) {
                           tab[q] = make_float2(
                               wt * 0x1p126f,
                               __int_as_float(r * stride + shift(r)));
                         });
    } else {
      // the weights of output column u laid out from the float4 that holds
      // its first tap, zero elsewhere
      const int u = t - ty_n;
      float* wts = xw + u * l.taps_x4;
      for (int k = 0; k < l.taps_x4; ++k) wts[k] = 0.f;
      int first = 0;
      build_taps(ox0 + u, w, inv_x, kx, l.taps_x, c0, n_cols,
                 [&](int q, float wt, int c) {
                   if (q == 0) first = c & ~3;
                   wts[c - first] = wt;
                 });
      x4[u] = first / 4;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. vertical pass, one (tile row, 4 input pixels) per thread; pixels
  // past the row's end are computed from whatever the stage holds there,
  // and the rest of the row is zeroed: the horizontal pass reads them all,
  // with weight 0
  const int groups = (n_cols + 3) / 4, row_groups = l.inter_stride / 4;
  const int plane = l.tile_y * l.inter_stride;
  for (int i = threadIdx.x; i < ty_n * row_groups; i += kThreads) {
    const int t = i / row_groups, g = i - t * row_groups;
    if (g >= groups) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        *reinterpret_cast<float4*>(inter + c * plane + t * l.inter_stride +
                                   4 * g) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float2* tab = ytab + t * l.taps_y;
    const int cnt = ny[t];
    float acc[12] = {};
    for (int q = 0; q < cnt; ++q) {
      const float2 e = tab[q];
      unsigned v[3];
      load12(stage, __float_as_int(e.y) + 12 * g, v);
#pragma unroll
      for (int b = 0; b < 12; ++b)
        acc[b] = fmaf(e.x, byte_denormal(v[b / 4], b % 4), acc[b]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      *reinterpret_cast<float4*>(inter + c * plane + t * l.inter_stride +
                                 4 * g) =
          make_float4(acc[c] * 0x1p23f, acc[3 + c] * 0x1p23f,
                      acc[6 + c] * 0x1p23f, acc[9 + c] * 0x1p23f);
  }
  __syncthreads();

  // 4. horizontal pass, one output pixel per thread: float4 loads of the
  // weights and of each channel plane
  const size_t base = ((size_t)blockIdx.z * oh + oy0) * ow + ox0;
  const int w4 = l.taps_x4 / 4, plane4 = plane / 4;
  for (int i = threadIdx.x; i < ty_n * tx_n; i += kThreads) {
    const int t = i / tx_n, u = i - t * tx_n;
    const float4* src =
        reinterpret_cast<const float4*>(inter + t * l.inter_stride) + x4[u];
    const float4* wts = reinterpret_cast<const float4*>(xw + u * l.taps_x4);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < w4; ++k) {
      const float4 wt = wts[k];
      a0 = dot4(wt, src[k], a0);
      a1 = dot4(wt, src[k + plane4], a1);
      a2 = dot4(wt, src[k + 2 * plane4], a2);
    }
    T* o = out + (base + (size_t)t * ow + u) * 3;
    o[0] = tpd::from_float<T>((reverse ? a2 : a0) * scale);
    o[1] = tpd::from_float<T>(a1 * scale);
    o[2] = tpd::from_float<T>((reverse ? a0 : a2) * scale);
  }
}

template <typename T>
int launch(const uint8_t* in, T* out, int n, int h, int w, int oh, int ow,
           float inv_sy, float inv_sx, int reverse, float scale,
           const Layout& l, int device, cudaStream_t s) {
  // the dynamic shared memory opted into so far, per device
  static int opted[64] = {};
  if (l.bytes > 48 * 1024 && (device >= 64 || l.bytes > opted[device])) {
    cudaError_t err = cudaFuncSetAttribute(
        resize_tiled_u8_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted[device] = l.bytes;
  }
  const dim3 grid(tpd::ceil_div(ow, l.tile_x), tpd::ceil_div(oh, l.tile_y),
                  n);
  resize_tiled_u8_kernel<T><<<grid, kThreads, l.bytes, s>>>(
      in, out, h, w, oh, ow, inv_sy, inv_sx, reverse, scale, l);
  return (int)cudaGetLastError();
}

}  // namespace

// tile_y .. smem_bytes come from ops/image.py resize_plan: the tile, the
// most input rows and columns a tile stages, the most taps per output
// along each axis, and the shared-memory bytes of that layout.
extern "C" int tpd_resize_bilinear_u8(const void* in, void* out, int n, int h,
                                      int w, int oh, int ow, float inv_sy,
                                      float inv_sx, int reverse, float scale,
                                      int out_bf16, int tile_y, int tile_x,
                                      int rows, int cols, int taps_y,
                                      int taps_x, int smem_bytes, int device,
                                      void* stream) {
  const Layout l = make_layout(tile_y, tile_x, rows, cols, taps_y, taps_x);
  if (l.bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (out_bf16)
    return launch(src, static_cast<__nv_bfloat16*>(out), n, h, w, oh, ow,
                  inv_sy, inv_sx, reverse, scale, l, device, s);
  return launch(src, static_cast<float*>(out), n, h, w, oh, ow, inv_sy,
                inv_sx, reverse, scale, l, device, s);
}
