// K6 quantize_input and K7 int8_rescale: the two elementwise halves of the
// int8 convolution of int8 serving (ops/quant.py int8_conv); the int8
// product between them is torch._int_mm.
//
// Replaces: tpudet3d/infer/quant.py quant_interceptor, :158-160 (K6: the
//   input quantized per tensor, with the conv's zero padding) and
//   :171-177 (K7: the int32 sums cast, scaled per channel, plus the bias).
//
// K6: x [N,C,H,W] f32 or bf16 of any strides (channels-last on the
// serving path) -> int8 [M, Kp], M = N*Ho*Wo rows of the conv's taps
// in the weight's [ky, kx, c] order, each clip(rint(x * inv), -127, 127)
// with inv = 127/s_x rounded to f32 on the host; taps outside the frame
// and columns K..Kp-1 are 0.  K7: int32 [M, Np] -> [M, N] f32 or bf16:
// each sum cast to the output dtype, times the channel's scale cast to
// it, plus the channel's bias cast to it, each result rounded to the
// output dtype (JAX's order: cast, multiply, add).
//
// Bound on the H100: bytes.  Both read and write each element once and do
// a handful of operations on it.  A MNv3 batch-16 int8 serving call runs
// 65 K6 launches over 1.13 GB: 63 are 1x1 convs on contiguous
// channels-last rows (~1.02 GB, up to 90 MB each), 2 are the 3x3
// stride-2 stems on C = 3 (~110 MB).
//
// K6 design: one of three routes per call, chosen by ops/quant.py
// quantize_plan, which make_layout below mirrors (the entry refuses a
// route or geometry that differs from its own):
// - rows (a 1x1, stride 1, pad 0 conv on channels-last rows of whole
//   16-byte vectors at an aligned address): the rows are the input's own
//   [M, C] matrix, so a thread makes 16 output bytes from 16-byte loads
//   (8 bf16 or 4 f32 values each), issuing the loads of U chunks (128
//   bytes) before it converts and stores any; a padded row's last chunk
//   loads its real vectors and zeros the rest.  At most 4 CTAs a SM
//   stride over the chunks, so a small conv runs as one short wave.
// - staged (another conv on channels-last input): at most 4 CTAs a SM
//   stride over bands of output rows.  For each band a CTA copies its
//   input rows, contiguous in memory, into shared memory with 16-byte
//   cp.async copies (the next band's copies fly while it works on this
//   one), quantizes each value once into an int8 tile whose rows outside
//   the frame and pad columns are zero, then builds each output row's Kp
//   bytes from the tile by per-thread tap offsets and writes them as
//   coalesced 16-byte stores.
// - strided (anything else): a thread per 16 output bytes walks its 16
//   taps with a running (ky, kx, c), loads each through the strides and
//   packs them into one 16-byte store.
// K7: a thread per 8 channels of a row loads its 8 sums as two 16-byte
// loads and stores 8 outputs as one or two 16-byte stores where the
// widths allow it, else element by element.  Products and sums use the
// round-to-nearest intrinsics, so nothing is fused and both agree with
// the plain PyTorch versions bit for bit.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // ops/quant.py K6_THREADS
constexpr int kRowsCtasPerSm = 4;          // K6_ROWS_CTAS_PER_SM
constexpr int kStagedCtasPerSm = 6;        // K6_STAGED_CTAS_PER_SM
constexpr int kBandsPerSm = 8;             // K6_BANDS_PER_SM
constexpr int kBands[] = {16, 8, 4, 2, 1};  // K6_BANDS
constexpr int kStageBytes = 36864;         // K6_STAGE_BYTES
constexpr int kSmemLimit = 232448;         // ops/image.py SMEM_LIMIT
enum Route { kRows = 0, kStaged = 1, kStrided = 2 };  // quant.py _ROUTES

struct QuantParams {
  int n, c, h, w;
  long long sn, sc, sy, sx;  // element strides of x
  int kh, kw, sh, sw, ph, pw, ho, wo;
  int k, kp, m;
  float inv;
};

// route, CTAs, output rows per band and dynamic shared bytes (quant.py
// QuantPlan); for the staged route also its staged rows, the tile's row
// width and the bytes of one raw stage (quant.py quantize_footprint)
struct Layout {
  int route, ctas, band, smem_bytes;
  int rows, tile_width, raw_bytes;
};

long long ceil_div_ll(long long a, long long b) { return (a + b - 1) / b; }

bool channels_last(const QuantParams& p) {
  return (p.n == 1 || p.sn == (long long)p.h * p.w * p.c) &&
         (p.c == 1 || p.sc == 1) &&
         (p.h == 1 || p.sy == (long long)p.w * p.c) &&
         (p.w == 1 || p.sx == p.c);
}

Layout staged_footprint(const QuantParams& p, int esize, int band) {
  Layout l = {kStaged, 0, band, 0, 0, 0, 0};
  l.rows = (band - 1) * p.sh + p.kh;
  const long long in_frame = l.rows < p.h ? l.rows : p.h;
  const long long raw =
      ceil_div_ll(in_frame * p.w * p.c * esize, 16) * 16 + 16;
  l.tile_width = (p.w + 2 * p.pw) * ((p.c + 3) & ~3);
  const long long bytes = 2 * raw + (long long)l.rows * l.tile_width;
  l.raw_bytes = raw > kSmemLimit ? kSmemLimit + 1 : (int)raw;
  l.smem_bytes = bytes > kSmemLimit ? kSmemLimit + 1 : (int)bytes;
  return l;
}

Layout make_layout(const QuantParams& p, int esize, uintptr_t addr, int sms) {
  const long long chunks = (long long)p.m * (p.kp / 16);
  const Layout strided = {kStrided, (int)ceil_div_ll(chunks, kThreads), 0, 0,
                          0, 0, 0};
  if (!channels_last(p) || (long long)p.m * p.kp >= (1LL << 31))
    return strided;
  if (p.kh == 1 && p.kw == 1 && p.sh == 1 && p.sw == 1 && p.ph == 0 &&
      p.pw == 0) {
    if ((p.c * esize) % 16 != 0 || addr % 16 != 0) return strided;
    const long long ctas = ceil_div_ll(chunks, kThreads);
    const long long cap = (long long)sms * kRowsCtasPerSm;
    return {kRows, (int)(ctas < cap ? ctas : cap), 0, 0, 0, 0, 0};
  }
  if (p.kp / 16 > kThreads) return strided;
  Layout pick = staged_footprint(p, esize, 1);
  for (int b : kBands) {
    const Layout l = staged_footprint(p, esize, b);
    if (l.smem_bytes <= kStageBytes &&
        (long long)p.n * ceil_div_ll(p.ho, b) >=
            (long long)kBandsPerSm * sms) {
      pick = l;
      break;
    }
  }
  if (pick.smem_bytes > kSmemLimit) return strided;
  const long long bands = (long long)p.n * ceil_div_ll(p.ho, pick.band);
  const long long cap = (long long)sms * kStagedCtasPerSm;
  pick.ctas = (int)(bands < cap ? bands : cap);
  return pick;
}

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// clip(rint(v * inv), -127, 127): the product rounded, not fused
__device__ __forceinline__ int quantize1(float v, float inv) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The 16 values held by 16 / (16 / sizeof(T)) 16-byte loads, quantized
// and packed in order into 16 bytes.
template <typename T>
__device__ __forceinline__ uint4 quantize16(const uint4* v, float inv) {
  unsigned words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float f;
    if (sizeof(T) == 2) {  // bf16: the low half of a word is the even value
      const unsigned w = word_of(v[j >> 3], (j >> 1) & 3);
      f = __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
    } else {
      f = __uint_as_float(word_of(v[j >> 2], j & 3));
    }
    words[j >> 2] |= (unsigned)(quantize1(f, inv) & 0xff) << ((j & 3) * 8);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// The rows route: chunk t is output bytes [16t, 16t + 16), row t / ch,
// channels from 16 (t % ch); the loads of U chunks, a grid's width
// apart, are issued before any is converted.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads, kRowsCtasPerSm)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ out,
                     unsigned chunks, int c, int kp, float inv) {
  constexpr int kVals = 16 / sizeof(T);  // values of a 16-byte load
  constexpr int kLoads = 16 / kVals;     // loads of a 16-value chunk
  const unsigned ch = (unsigned)kp >> 4, step = gridDim.x * kThreads;
  const uint4* src = reinterpret_cast<const uint4*>(x);
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < chunks;
       base += U * step) {
    uint4 v[U][kLoads];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned t = base + u * step;
      unsigned first = t * 16;  // the chunk's first value in x
      int real = 16;            // its values inside the row
      if (c != kp) {
        const unsigned row = t / ch, k0 = (t - row * ch) * 16;
        first = row * (unsigned)c + k0;
        real = c - (int)k0;
      }
#pragma unroll
      for (int l = 0; l < kLoads; ++l)
        v[u][l] = t < chunks && l * kVals < real
                      ? __ldg(src + first / kVals + l)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned t = base + u * step;
      if (t < chunks)
        *reinterpret_cast<uint4*>(out + (size_t)t * 16) =
            quantize16<T>(v[u], inv);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every group of copies but the one committed last.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Band b of the staged route: output rows [oy0, oy0 + rows) of image n,
// staged rows first .. first + nrows - 1 (input rows), of which [lo, hi)
// lie inside the frame.
struct Band {
  int n, oy0, rows, first, nrows, lo, hi;
};

__device__ __forceinline__ Band band_of(int b, const QuantParams& p,
                                        int band) {
  const int per_image = (p.ho + band - 1) / band;
  Band r;
  r.n = b / per_image;
  r.oy0 = (b - r.n * per_image) * band;
  r.rows = min(band, p.ho - r.oy0);
  r.first = r.oy0 * p.sh - p.ph;
  r.nrows = (r.rows - 1) * p.sh + p.kh;
  r.lo = max(r.first, 0);
  r.hi = min(r.first + r.nrows, p.h);
  return r;
}

// Issues the copies of band bd's rows inside the frame, contiguous in
// channels-last memory, into ``raw`` from the 16-byte chunk that holds
// their first byte; returns that byte's offset in ``raw``.
template <typename T>
__device__ __forceinline__ int stage_band(const T* x, unsigned char* raw,
                                          const Band& bd,
                                          const QuantParams& p) {
  if (bd.hi <= bd.lo) return 0;
  const size_t wc = (size_t)p.w * p.c;
  const uintptr_t g =
      reinterpret_cast<uintptr_t>(x + ((size_t)bd.n * p.h + bd.lo) * wc);
  const uintptr_t a0 = g & ~uintptr_t(15);
  const int shift = (int)(g - a0);
  const int n16 =
      (int)((shift + (bd.hi - bd.lo) * wc * sizeof(T) + 15) >> 4);
  for (int i = threadIdx.x; i < n16; i += kThreads)
    cp_async16(raw + 16 * i,
               reinterpret_cast<const void*>(a0 + 16 * (size_t)i));
  return shift;
}

// Step 2 of the staged route for C = 3: pixel px of staged row r (3
// values at raw offset (r * w + px) * 3) quantized into one tile word,
// its fourth byte 0.
template <typename T>
__device__ __forceinline__ void quantize_pixels(const T* vals,
                                                unsigned* tile32, int wt4,
                                                int rows,
                                                const QuantParams& p) {
  int r = threadIdx.x / p.w, px = threadIdx.x - r * p.w;
  const int dr = kThreads / p.w, dpx = kThreads - dr * p.w;
  for (int i = threadIdx.x; i < rows * p.w; i += kThreads) {
    const T* v = vals + 3 * i;
    tile32[r * wt4 + px + p.pw] =
        (unsigned)(quantize1(load_float(v), p.inv) & 0xff) |
        (unsigned)(quantize1(load_float(v + 1), p.inv) & 0xff) << 8 |
        (unsigned)(quantize1(load_float(v + 2), p.inv) & 0xff) << 16;
    r += dr;
    px += dpx;
    if (px >= p.w) {
      px -= p.w;
      ++r;
    }
  }
}

// Step 3 of the staged route for a 3x3 conv on C = 3 (K = 27, Kp = 32):
// an output row is the 9 tap words' first 3 bytes in order, then 5 zero
// bytes, packed by byte permutes; a thread makes whole rows.
__device__ __forceinline__ void stem_rows(const unsigned* tile32, int wt4,
                                          int8_t* dst, int rows,
                                          const QuantParams& p) {
  for (int row = threadIdx.x; row < rows; row += kThreads) {
    const int oy = row / p.wo, ox = row - oy * p.wo;
    const unsigned* src = tile32 + oy * p.sh * wt4 + ox * p.sw;
    unsigned t[9];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) t[ky * 3 + kx] = src[ky * wt4 + kx];
    uint4* d = reinterpret_cast<uint4*>(dst + (size_t)row * 32);
    d[0] = make_uint4(__byte_perm(t[0], t[1], 0x4210),
                      __byte_perm(t[1], t[2], 0x5421),
                      __byte_perm(t[2], t[3], 0x6542),
                      __byte_perm(t[4], t[5], 0x4210));
    d[1] = make_uint4(__byte_perm(t[5], t[6], 0x5421),
                      __byte_perm(t[6], t[7], 0x6542), t[8], 0u);
  }
}

// The staged route: each CTA walks bands blockIdx.x, + gridDim.x, ...
// (band b is band b % per_image of image b / per_image), with the next
// band's rows in flight while it quantizes the current one.  Shared
// memory: two raw stages of l.raw_bytes, then the int8 tile of l.rows rows
// of l.tile_width bytes: row r holds input row first + r, a pixel every
// P = c rounded up to 4 bytes, with pw zero pixels each side.  kStem: the
// 3x3 conv on C = 3 (the stems), whose pixels are one word each.
template <typename T, bool kStem>
__global__ void __launch_bounds__(kThreads, kStagedCtasPerSm)
quantize_staged_kernel(const T* __restrict__ x, int8_t* __restrict__ out,
                       QuantParams p, Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* tile = reinterpret_cast<int8_t*>(smem + 2 * l.raw_bytes);
  const int tid = threadIdx.x, pitch = (p.c + 3) & ~3;
  const int left = p.pw * pitch, right = left + p.w * pitch;
  const int total = p.n * ((p.ho + l.band - 1) / l.band);
  // generic step 3: thread tid builds 16-byte chunk q = tid % ch of a
  // band's output rows tid / ch, tid / ch + per, ...; off[j] is byte
  // 16q + j's offset in the tile from the row's first tap (-1 for the
  // zero columns K..Kp-1)
  const int ch = p.kp >> 4, per = kThreads / ch, q = tid % ch;
  int off[16];
  if (!kStem) {
    int k = q * 16, tap = k / p.c, c = k - tap * p.c;
    int ky = tap / p.kw, kx = tap - ky * p.kw;
#pragma unroll
    for (int j = 0; j < 16; ++j, ++k) {
      off[j] = k < p.k ? ky * l.tile_width + kx * pitch + c : -1;
      if (++c == p.c) {
        c = 0;
        if (++kx == p.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
  }
  int b = blockIdx.x, shift_next = 0;
  if (b < total) shift_next = stage_band(x, smem, band_of(b, p, l.band), p);
  cp_async_commit();
  for (int i = 0; b < total; ++i, b += gridDim.x) {
    unsigned char* raw = smem + (i & 1) * l.raw_bytes;
    const int shift = shift_next;
    const Band bd = band_of(b, p, l.band);
    // 1. the next band's copies in flight, this band's landed; the tile's
    // zeros: rows outside the frame, the pad pixels of the rows inside
    if (b + (int)gridDim.x < total)
      shift_next = stage_band(x, smem + ((i + 1) & 1) * l.raw_bytes,
                              band_of(b + gridDim.x, p, l.band), p);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    for (int r = 0; r < bd.nrows; ++r) {
      int8_t* row = tile + r * l.tile_width;
      if (bd.first + r < bd.lo || bd.first + r >= bd.hi) {
        for (int c = tid; c < l.tile_width; c += kThreads) row[c] = 0;
      } else {
        for (int c = tid; c < left; c += kThreads) row[c] = 0;
        for (int c = right + tid; c < l.tile_width; c += kThreads) row[c] = 0;
      }
    }
    // 2. each staged value quantized once
    const T* vals = reinterpret_cast<const T*>(raw + shift);
    const int in_rows = bd.hi - bd.lo;
    int8_t* dst = out + ((size_t)bd.n * p.ho + bd.oy0) * p.wo * p.kp;
    const int rows = bd.rows * p.wo;
    if (kStem) {
      const int wt4 = l.tile_width >> 2;
      unsigned* tile32 = reinterpret_cast<unsigned*>(tile);
      quantize_pixels(vals, tile32 + (bd.lo - bd.first) * wt4, wt4, in_rows,
                      p);
      __syncthreads();
      // 3. the band's output rows from the tile
      stem_rows(tile32, wt4, dst, rows, p);
      continue;
    }
    {
      int8_t* t = tile + (bd.lo - bd.first) * l.tile_width + left;
      const int wc = p.w * p.c, count = in_rows * wc;
      // (r, px, c) of value e, advanced by kThreads values a step
      int r = tid / wc, px = (tid - r * wc) / p.c;
      int c = tid - r * wc - px * p.c;
      const int dr = kThreads / wc, dpx = (kThreads - dr * wc) / p.c;
      const int dc = kThreads - dr * wc - dpx * p.c;
      for (int e = tid; e < count; e += kThreads) {
        t[r * l.tile_width + px * pitch + c] =
            (int8_t)quantize1(load_float(vals + e), p.inv);
        r += dr;
        px += dpx;
        c += dc;
        if (c >= p.c) {
          c -= p.c;
          ++px;
        }
        if (px >= p.w) {
          px -= p.w;
          ++r;
        }
      }
    }
    __syncthreads();
    // 3. the band's output rows from the tile, 16-byte stores
    if (tid < per * ch) {
      for (int row = tid / ch; row < rows; row += per) {
        const int oy = row / p.wo, ox = row - oy * p.wo;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(tile) +
            oy * p.sh * l.tile_width + ox * p.sw * pitch;
        unsigned words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (off[j] >= 0)
            words[j >> 2] |= (unsigned)src[off[j]] << ((j & 3) * 8);
        *reinterpret_cast<uint4*>(dst + (size_t)row * p.kp + q * 16) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
  }
}

// The strided route: a thread per 16 output bytes, its taps read through
// the strides.
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
    if (k0 + j < p.k && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
      q = quantize1(load_float(base + ci * p.sc + iy * p.sy + ix * p.sx),
                    p.inv);
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

template <typename T>
int launch_quantize(const void* xv, void* outv, const QuantParams& p,
                    const Layout& l, int device, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  int8_t* out = static_cast<int8_t*>(outv);
  if (l.route == kRows) {
    constexpr int U = sizeof(T) == 2 ? 4 : 2;  // 128 bytes of loads a thread
    quantize_rows_kernel<T, U><<<l.ctas, kThreads, 0, s>>>(
        x, out, (unsigned)((long long)p.m * (p.kp / 16)), p.c, p.kp, p.inv);
  } else if (l.route == kStaged) {
    const bool stem = p.c == 3 && p.kh == 3 && p.kw == 3;
    auto kernel = stem ? quantize_staged_kernel<T, true>
                       : quantize_staged_kernel<T, false>;
    // the dynamic shared memory opted into so far, per device and kernel
    static int opted[2][64] = {};
    if (l.smem_bytes > 48 * 1024 && l.smem_bytes > opted[stem][device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_bytes);
      if (err != cudaSuccess) return (int)err;
      opted[stem][device] = l.smem_bytes;
    }
    kernel<<<l.ctas, kThreads, l.smem_bytes, s>>>(x, out, p, l);
  } else {
    quantize_input_kernel<T><<<l.ctas, kThreads, 0, s>>>(x, out, p);
  }
  return (int)cudaGetLastError();
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

// route .. smem_bytes come from ops/quant.py quantize_plan (route 0 rows,
// 1 staged, 2 strided; CTAs; output rows per CTA; dynamic shared bytes)
// for a card of ``sms`` SMs; the entry refuses a plan that differs from
// make_layout's and any shape the kernels do not take.
extern "C" int tpd_quantize_input(const void* x, void* out, int bf16, int n,
                                  int c, int h, int w, int sn, int sc, int sy,
                                  int sx, int kh, int kw, int sh, int sw,
                                  int ph, int pw, int ho, int wo, int kp,
                                  float inv, int route, int ctas, int band,
                                  int smem_bytes, int sms, int device,
                                  void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || kh < 1 || kw < 1 || sh < 1 ||
      sw < 1 || ph < 0 || pw < 0 || sms < 1 || kp % 16 != 0 ||
      kp < kh * kw * c || ho != (h + 2 * ph - kh) / sh + 1 ||
      wo != (w + 2 * pw - kw) / sw + 1 || ho < 1 || wo < 1)
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const QuantParams p = {n,  c,  h,  w,  sn, sc, sy, sx, kh, kw,
                         sh, sw, ph, pw, ho, wo, kh * kw * c, kp,
                         n * ho * wo, inv};
  const Layout l = make_layout(p, bf16 ? 2 : 4, reinterpret_cast<uintptr_t>(x),
                               sms);
  if (l.route != route || l.ctas != ctas || l.band != band ||
      l.smem_bytes != smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_quantize<__nv_bfloat16>(x, out, p, l, device, s);
  return launch_quantize<float>(x, out, p, l, device, s);
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
