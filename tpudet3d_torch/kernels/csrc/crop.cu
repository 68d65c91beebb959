// K2 crop_resize_normalize: for every box, a bilinear crop-resize of its
// uint8 NHWC frame to oh x ow, optional BGR->RGB reversal, per-channel
// x * scale - offset, stored as bf16 or f32 NHWC; with ``mirror`` the
// horizontally mirrored copy of every crop is written in the same launch
// (the TTA batch: all originals, then all mirrors).
//
// Replaces: tpudet3d/ops/image.py:87-139 crop_and_resize (two dense
//   interpolation matmuls per crop, a TPU choice) with the semantics of its
//   gather form crop_and_resize_gather (:59-75): cv2 pixel-centre sampling
//   src = (dst + 0.5) * (box / out) - 0.5 + x0, box side floored at 1 px,
//   source coordinate clamped to the frame (border), no antialias; plus the
//   normalisation and TTA concat of tpudet3d/infer/engine.py:254-266.
//
// Bound on the H100: bytes.  128 crops of 224^2 at batch 16: the source
// pixels the crops touch read once and 38.5 MB of bf16 crops written,
// about 15 us at 3.35 TB/s.
//
// Design: one CTA per band of ``band`` output rows of one crop (the box is
// read from device memory in the kernel, so the host never waits for the
// detector's output; ops/image.py crop_plan takes the tallest band that
// still gives every SM two CTAs), in passes of as many of the band's rows
// as the stage holds, each in three steps:
//   1. stage the pass's source rows in shared memory with 16-byte cp.async
//      copies of the aligned chunks that hold the box's column span (single
//      bytes where a chunk would leave the frames' tensor).  The rows are
//      the span from the pass's first top row to its last bottom row when
//      that is at most two per output row (upscaling shares rows between
//      output rows), else a top and a bottom row per output row.  The
//      stage has a fixed size; a staged row takes the box's span, so the
//      narrower the box, the more rows a pass holds (two whole frame rows
//      always fit, so any box does);
//   2. meanwhile build the tap tables: once per CTA, per output column its
//      x weight and the byte offset of its left tap in a staged row; per
//      pass row its two y weights and the offsets of its staged rows.  A
//      sample position is computed once per column and once per row, with
//      the rounding of the plain version (the side times the f32
//      reciprocal, one fused multiply-add, then the start added);
//   3. one thread per run of 8 consecutive output pixels of a row: per
//      pixel, two 32-bit shared loads per source row (three where the left
//      tap is a word's last byte) bring both taps' 6 bytes; each byte
//      becomes the denormal float of the same bits (b * 2^-149, a byte
//      permute, no conversion) and is multiplied by its x weight scaled by
//      2^126, so every product rounds as w * b does; the normalisation
//      scale carries the 2^23 back.  The 8 pixels' 24 values go out as
//      three 16-byte stores in bf16 (six in f32), and the mirror copy's
//      run, aligned too when ow is a multiple of 8, from the same registers
//      in reverse pixel order.  (Denormals are kept: the kernels are built
//      without flush-to-zero.)
// What holds it (PERF.md §6), on the device of an H100 at the serving
// shape: each CTA's chain of staging, compute and stores.  Copies that
// return after a phase take 0.0095 ms for the first pass's staging and
// tables, 0.016 with the compute and 0.029 for the stores alone (a lane's
// 16-byte stores each write half a 32-byte sector), against 0.031 for the
// kernel.  Whole-sector stores cut the stores alone to 0.014-0.018 but
// not the kernel: through a shared buffer 0.036-0.039 (80-96 registers,
// fewer CTAs an SM), by lane pairs swapping chunks 0.032.  Sizing a
// staged row to the box's span in a fixed 32 KB stage, in place of
// 2 * band whole frame rows, with bands of 16 rows in place of 4, took the
// kernel from 0.038 to 0.031 ms.  Also slower: a 24 or 48 KB stage, 256
// threads, persistent CTAs that stage the next band while computing one
// (double buffers halve the CTAs an SM holds).  Fewer shared-memory
// wavefronts in step 3 (float2 x entries, a third word only where
// needed) changed nothing.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 8;  // output pixels per thread, ops/image.py K2_RUN

struct Norm {
  float s[3];  // scale[c] * 2^23
  float o[3];
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

// Byte offsets in one CTA's dynamic shared memory; ops/image.py
// crop_footprint computes the same total and the entry point checks that
// the two agree.  The x table is [kRun][runs] float2s (entry of column
// x at (x % kRun) * runs + x / kRun, so that the lanes of a warp, which
// hold consecutive runs, read consecutive entries), the y table [band]
// float4s, then the stage of kStageBytes, or of two rows of ``stride``
// where that is more: a whole frame row (3w), its shift in a 16-byte chunk
// (< 16) and the three words read at the last pixel's taps.  A pass's
// rows lie in the stage at the stride of the box's own span.
constexpr int kStageBytes = 32768;  // ops/image.py K2_STAGE_BYTES

struct Layout {
  int band, runs, stride, ytab, stage, stage_bytes, bytes;
};

Layout make_layout(int w, int ow, int band) {
  Layout l;
  l.band = band;
  l.runs = (ow + kRun - 1) / kRun;
  l.stride = align16(3 * w + 24);
  l.ytab = 8 * kRun * l.runs;
  l.stage = align16(l.ytab + 16 * band);
  l.stage_bytes = 2 * l.stride > kStageBytes ? 2 * l.stride : kStageBytes;
  l.bytes = l.stage + l.stage_bytes;
  return l;
}

struct Tap {
  int i0;   // first source index; the second is min(i0 + 1, n - 1)
  float f;  // the second's weight
};

// Output dst's source position along an axis of n pixels, rounded as the
// plain version rounds it: (dst + 0.5) * step - 0.5 as one fused
// multiply-add, then + start, clamped to [0, n - 1].
__device__ __forceinline__ Tap tap_at(int dst, float step, float start,
                                      int n) {
  float s = __fadd_rn(fmaf((float)dst + 0.5f, step, -0.5f), start);
  s = fminf(fmaxf(s, 0.f), (float)(n - 1));
  const float fl = floorf(s);
  return {(int)fl, __fsub_rn(s, fl)};
}

// Byte b of v as the denormal float of the same bits, b * 2^-149.
__device__ __forceinline__ float byte_denormal(unsigned v, int b) {
  return __uint_as_float(__byte_perm(v, 0u, 0x4440 | b));
}

// The horizontal interpolation of one source row at a pixel: its left tap
// at p and the right one at p + 3 (p + 3 is read even where the right tap
// is the clamped left one: its weight is 0 there), per source channel,
// scaled by 2^-23.  The six bytes lie in two words unless p is the last
// byte of one: only then is a third read.
__device__ __forceinline__ void row_taps(const uint8_t* p, float a0, float a1,
                                         float out[3]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const unsigned* wp = reinterpret_cast<const unsigned*>(addr & ~uintptr_t(3));
  const unsigned sh = 8u * (unsigned)(addr & 3);
  const unsigned w0 = wp[0], w1 = wp[1];
  const unsigned w2 = sh == 24u ? wp[2] : 0u;
  const unsigned lo = __funnelshift_r(w0, w1, sh);  // bytes 0-3
  const unsigned hi = __funnelshift_r(w1, w2, sh);  // bytes 4-7
  out[0] = __fmaf_rn(a1, byte_denormal(lo, 3),
                     __fmul_rn(a0, byte_denormal(lo, 0)));
  out[1] = __fmaf_rn(a1, byte_denormal(hi, 0),
                     __fmul_rn(a0, byte_denormal(lo, 1)));
  out[2] = __fmaf_rn(a1, byte_denormal(hi, 1),
                     __fmul_rn(a0, byte_denormal(lo, 2)));
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

// The 24 values of a run (pixel-major, 3 channels) as 16-byte stores; dst
// is 16-byte aligned.  rev: the pixels in reverse order.
__device__ __forceinline__ void store_run(float* dst, const float (&v)[24],
                                          bool rev) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j, p = i / 3, c = i % 3;
      e[j] = rev ? v[3 * (kRun - 1 - p) + c] : v[i];
    }
    d[q] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store_run(__nv_bfloat16* dst,
                                          const float (&v)[24], bool rev) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    unsigned u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float e[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 8 * q + 2 * j + h, p = i / 3, c = i % 3;
        e[h] = rev ? v[3 * (kRun - 1 - p) + c] : v[i];
      }
      u[j] = pack_bf16(e[0], e[1]);
    }
    d[q] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// grid (bands, boxes): CTA (i, b) writes output rows [i * band, ...) of
// crop b, and of its mirror.
template <typename T, bool kReverse>
__global__ void __launch_bounds__(kThreads)
    crop_band_kernel(const uint8_t* __restrict__ frames,
                     const float* __restrict__ boxes, T* __restrict__ out,
                     int n, int h, int w, int k, int oh, int ow, float inv_oh,
                     float inv_ow, Norm nm, int mirror, Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* xtab = reinterpret_cast<float2*>(smem);
  float4* ytab = reinterpret_cast<float4*>(smem + l.ytab);
  uint8_t* stage = smem + l.stage;

  const int b = blockIdx.y, oy0 = blockIdx.x * l.band;
  const int nrow = min(l.band, oh - oy0);
  const float* bx = boxes + (size_t)b * 4;
  const float x0 = bx[0], y0 = bx[1], x1 = bx[2], y1 = bx[3];
  const float step_x = __fmul_rn(fmaxf(__fsub_rn(x1, x0), 1.f), inv_ow);
  const float step_y = __fmul_rn(fmaxf(__fsub_rn(y1, y0), 1.f), inv_oh);
  const size_t frame_bytes = (size_t)h * w * 3;
  const uint8_t* img = frames + (size_t)(b / k) * frame_bytes;
  const uint8_t* in_end = frames + (size_t)n * frame_bytes;

  // the box's column span [c0, c1] (the taps' columns grow with the
  // output column), the stride of a staged row and the rows a pass holds
  const int c0 = tap_at(0, step_x, x0, w).i0;
  const int c1 = min(tap_at(ow - 1, step_x, x0, w).i0 + 1, w - 1);
  const int span = 3 * (c1 - c0 + 1);
  const int stride = align16(span + 24);
  const int cap = l.stage_bytes / stride;  // >= 2
  const int chunks = (span + 30) / 16;
  auto row_start = [&](int r) { return img + ((size_t)r * w + c0) * 3; };
  // staged row s's span byte j lands at stage[s * stride + shift + j],
  // where shift is the span start's offset in its 16-byte chunk
  auto shift = [&](const uint8_t* p) {
    return (int)(reinterpret_cast<uintptr_t>(p) & 15);
  };
  auto top_row = [&](int r) { return tap_at(oy0 + r, step_y, y0, h).i0; };

  for (int r0 = 0; r0 < nrow;) {
    // the pass's rows [r0, r0 + m): all the band's remaining rows where
    // they fit, else the most that do (each row needs at most two)
    const int lo = top_row(r0);
    // source rows from the first row's top tap to the m-th row's bottom one
    auto rows = [&](int m) {
      return min(top_row(r0 + m - 1) + 1, h - 1) - lo + 1;
    };
    auto need = [&](int m) { return min(rows(m), 2 * m); };
    int m = nrow - r0;
    if (need(m) > cap) {
      m = 1;
      while (need(m + 1) <= cap) ++m;
    }
    const bool contiguous = rows(m) <= 2 * m;
    const int n_stage = need(m);
    auto src_row = [&](int s) {
      if (contiguous) return lo + s;
      const int i0 = top_row(r0 + (s >> 1));
      return (s & 1) ? min(i0 + 1, h - 1) : i0;
    };

    // 1. stage: a warp per staged row, a lane per 16-byte chunk
    for (int s = threadIdx.x / 32; s < n_stage; s += kThreads / 32) {
      const uint8_t* row = row_start(src_row(s));
      const int sh = shift(row);
      for (int q = threadIdx.x % 32; q < chunks; q += 32) {
        const int first = 16 * q - sh;  // the chunk's first span byte
        if (first >= span) break;
        const uint8_t* a = row + first;
        uint8_t* d = stage + s * stride + 16 * q;
        if (a >= frames && a + 16 <= in_end) {
          cp_async16(d, a);
        } else {
          // a chunk that would leave the tensor: its span bytes one by
          // one, all loads issued before any store
          uint8_t v[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (first + j >= 0 && first + j < span) v[j] = a[j];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (first + j >= 0 && first + j < span) d[j] = v[j];
        }
      }
    }

    // 2. tap tables, while the copies fly: the x table in the first pass
    // only (columns past ow are never stored)
    const int nx = r0 == 0 ? kRun * l.runs : 0;
    for (int t = threadIdx.x; t < nx + m; t += kThreads) {
      if (t < nx) {
        float2 e = make_float2(0.f, __int_as_float(0));
        if (t < ow) {
          const Tap tx = tap_at(t, step_x, x0, w);
          e = make_float2(tx.f, __int_as_float(3 * (tx.i0 - c0)));
        }
        xtab[(t % kRun) * l.runs + t / kRun] = e;
      } else {
        const int r = t - nx;
        const Tap ty = tap_at(oy0 + r0 + r, step_y, y0, h);
        const int i1 = min(ty.i0 + 1, h - 1);
        const int s0 = contiguous ? ty.i0 - lo : 2 * r;
        const int s1 = contiguous ? i1 - lo : 2 * r + 1;
        ytab[r] = make_float4(
            __fsub_rn(1.f, ty.f), ty.f,
            __int_as_float(s0 * stride + shift(row_start(ty.i0))),
            __int_as_float(s1 * stride + shift(row_start(i1))));
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // 3. a run of kRun output pixels per thread
    const bool vec = ow % kRun == 0;
    const int n_boxes = gridDim.y;
    for (int i = threadIdx.x; i < m * l.runs; i += kThreads) {
      const int r = i / l.runs, g = i - r * l.runs;
      const float4 ye = ytab[r];
      const uint8_t* top = stage + __float_as_int(ye.z);
      const uint8_t* bot = stage + __float_as_int(ye.w);
      float v[3 * kRun];
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        const float2 xe = xtab[p * l.runs + g];
        const int xo = __float_as_int(xe.y);
        // the weights 1 - f and f, scaled by 2^126 (exactly)
        const float a0 = __fmul_rn(__fsub_rn(1.f, xe.x), 0x1p126f);
        const float a1 = __fmul_rn(xe.x, 0x1p126f);
        float tv[3], bv[3];
        row_taps(top + xo, a0, a1, tv);
        row_taps(bot + xo, a0, a1, bv);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int sc = kReverse ? 2 - c : c;
          const float u = __fmaf_rn(ye.y, bv[sc], __fmul_rn(ye.x, tv[sc]));
          v[3 * p + c] = __fmaf_rn(u, nm.s[c], -nm.o[c]);
        }
      }
      const int oy = oy0 + r0 + r, ox = g * kRun;
      T* o = out + (((size_t)b * oh + oy) * ow + ox) * 3;
      T* om = out + ((size_t)(n_boxes + b) * oh + oy) * ow * 3;
      if (vec) {
        store_run(o, v, false);
        if (mirror) store_run(om + (ow - kRun - ox) * 3, v, true);
      } else {
#pragma unroll
        for (int p = 0; p < kRun; ++p) {
          if (ox + p >= ow) break;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const T t = tpd::from_float<T>(v[3 * p + c]);
            o[3 * p + c] = t;
            if (mirror) om[(ow - 1 - ox - p) * 3 + c] = t;
          }
        }
      }
    }
    r0 += m;
    if (r0 < nrow) __syncthreads();  // before the next pass's stage
  }
}

template <typename T, bool kReverse>
int launch(const uint8_t* frames, const float* boxes, T* out, int n, int h,
           int w, int k, int oh, int ow, float inv_oh, float inv_ow,
           const Norm& nm, int mirror, const Layout& l, int device,
           cudaStream_t s) {
  // the dynamic shared memory opted into so far, per device
  static int opted[64] = {};
  if (l.bytes > 48 * 1024 && l.bytes > opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        crop_band_kernel<T, kReverse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (err != cudaSuccess) return (int)err;
    opted[device] = l.bytes;
  }
  const dim3 grid(tpd::ceil_div(oh, l.band), n * k);
  crop_band_kernel<T, kReverse><<<grid, kThreads, l.bytes, s>>>(
      frames, boxes, out, n, h, w, k, oh, ow, inv_oh, inv_ow, nm, mirror, l);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* frames, const void* boxes, void* out, int n, int h,
             int w, int k, int oh, int ow, float inv_oh, float inv_ow,
             int reverse, const Norm& nm, int mirror, const Layout& l,
             int device, cudaStream_t s) {
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* bx = static_cast<const float*>(boxes);
  T* o = static_cast<T*>(out);
  if (reverse)
    return launch<T, true>(f, bx, o, n, h, w, k, oh, ow, inv_oh, inv_ow, nm,
                           mirror, l, device, s);
  return launch<T, false>(f, bx, o, n, h, w, k, oh, ow, inv_oh, inv_ow, nm,
                          mirror, l, device, s);
}

}  // namespace

// band .. smem_bytes come from ops/image.py crop_plan: output rows per
// CTA, runs of kRun per output row, bytes per staged row and the
// shared-memory bytes of that layout; the entry refuses a mismatch and any
// shape the kernel does not take.
extern "C" int tpd_crop_resize_u8(const void* frames, const void* boxes,
                                  void* out, int n, int h, int w, int k,
                                  int oh, int ow, float inv_oh, float inv_ow,
                                  int reverse, float s0, float s1, float s2,
                                  float o0, float o1, float o2, int mirror,
                                  int out_bf16, int band, int runs,
                                  int stride, int smem_bytes, int device,
                                  void* stream) {
  if (n < 1 || h < 1 || w < 1 || k < 1 || oh < 1 || ow < 1 || band < 1 ||
      n * k > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout l = make_layout(w, ow, band);
  if (l.runs != runs || l.stride != stride || l.bytes != smem_bytes)
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Norm nm = {{s0 * 0x1p23f, s1 * 0x1p23f, s2 * 0x1p23f}, {o0, o1, o2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_t<__nv_bfloat16>(frames, boxes, out, n, h, w, k, oh, ow,
                                   inv_oh, inv_ow, reverse, nm, mirror, l,
                                   device, s);
  return launch_t<float>(frames, boxes, out, n, h, w, k, oh, ow, inv_oh,
                         inv_ow, reverse, nm, mirror, l, device, s);
}
