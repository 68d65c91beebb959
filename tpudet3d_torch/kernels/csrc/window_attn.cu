// K8 window_attention: shifted-window multi-head self-attention of the
// Swin regressor (Liu et al., arXiv:2103.14030), from the qkv
// projection's output on the whole token map [B,H,W,3C] bf16 to the
// attention's output on the same map [B,H,W,C] bf16.  Per window of
// window x window tokens of the map cyclically shifted by -shift, and per
// head (32 channels): s = (q k^T) * scale + bias + mask in f32, the bias
// gathered from the relative-position table [(2w-1)^2, heads] f32 and the
// mask -100 between tokens of different regions of the shifted map;
// p = softmax(s) in f32, rounded to bf16; o = p v accumulated in f32,
// rounded to bf16.  The plain version is ops/attention.py
// window_attention_plain.
//
// Replaces no TPU kernel: the JAX package has no Swin backbone.  Added
// because no library call computes the function without copies around
// it: F.scaled_dot_product_attention needs the bias and the shift mask
// as a [windows, heads, n, n] tensor and the roll and the window
// partition as copies of the map, before and after.
//
// Bound on the H100: memory.  Per window and head the function reads
// 49 tokens x 96 bf16 (9.4 KB) and writes 49 x 32 (3.1 KB) for
// 2 * 2 * 49 * 49 * 32 = 307 KFLOP: 25 FLOP a byte, against the card's
// 295 bf16 FLOP a byte.  At 256 crops of 224^2 Swin-T's 12 blocks move
// 2.9 GB (0.87 ms at 3.35 TB/s) for 72 GFLOP (0.07 ms at 989 TFLOP/s).
//
// Design: one CTA of 4 warps per window and group of kHeadsPerCta heads
// (grid x: windows, y: head groups).  The CTA computes once where each of
// its tokens lies: token t = (r, c) of window (wy, wx) sits at
// ((wy*w + r + shift) mod H, (wx*w + c + shift) mod W) of the unshifted
// map, so the roll and the partition are addresses, and the output is
// written back at the same place; with the mask on, each token's region
// of the shifted map.  Per head, each thread holds its share of the
// head's q, k and v rows (64 B a token each, 16-byte loads) and of the
// head's column of the bias table in registers: the next head's loads
// are issued before the current head is computed, so their latency hides
// behind the compute.  Stored to shared memory, q and k as rows and v
// transposed, in tiles of 64 tokens whose pad rows stay zero, so that
// every MMA operand is one 32-bit shared load without bank conflicts.
// Each warp takes 16 query rows: S = Q K^T by bf16 mma.sync m16n8k16
// (f32 accumulators) into registers; the softmax of each row on the
// accumulators (a row's 64 columns lie in the 4 lanes of a quad: max and
// sum by two shuffles each), with the bias's row of the table the
// difference of a row key and a column key and the mask a comparison of
// regions (the keys computed once a CTA, a column's in shared memory);
// the probabilities (times the sum's reciprocal) rounded to bf16 straight
// into the A fragments of O = P V (the accumulator layout of two n-tiles
// is the A layout of one k-step); O written out as bf16 pairs for the
// valid rows.  At most 128 registers a thread, so that 4 CTAs share an
// SM.  No tensor but the output is made, nothing is
// allocated, and the launch is on the caller's stream, so a CUDA graph
// captures it.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kHd = 32;          // channels a head
constexpr int kT = 64;           // a window's tokens, padded (window <= 8)
constexpr int kWarps = 4;        // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kHeadsPerCta = 3;
constexpr int kChunks = 3 * kHd / 8;  // 16-byte chunks of q, k, v a token
constexpr int kLoads = kT * kChunks / kThreads;  // a thread's, at most
constexpr int kLdQ = 40;         // bf16 row stride of the q and k tiles
constexpr int kLdV = 72;         // bf16 row stride of v transposed
constexpr int kMaxTable = 15 * 15;
constexpr int kBiasLoads = (kMaxTable + kThreads - 1) / kThreads;
constexpr float kMaskValue = -100.f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int B, H, W, C, heads, window, shift, masked, nwh, nww;
  float scale;
};

struct __align__(16) Smem {
  __nv_bfloat16 q[kT * kLdQ];
  __nv_bfloat16 k[kT * kLdQ];
  __nv_bfloat16 vt[kHd * kLdV];  // [channel][token]
  float bias[kMaxTable];
  long long off[kT];     // token's position (b*H + y)*W + x in the map
  int ty[kT], tx[kT];    // token's row and column in its window
  int region[kT];        // token's region of the shifted map
  int col_key[kT];       // as a column of S: key | region << 8, -1 pad
};

__device__ __forceinline__ int axis_region(int i, int size, int window,
                                           int shift) {
  return (i >= size - window) + (i >= size - shift);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// this thread's share of head h's q, k and v rows and of its column of
// the bias table, into registers
__device__ __forceinline__ void fetch(uint4 (&held)[kLoads],
                                      float (&bias)[kBiasLoads],
                                      const __nv_bfloat16* __restrict__ qkv,
                                      const float* __restrict__ table,
                                      const long long* off, int tid, int n,
                                      int tw, long long C3, int C, int heads,
                                      int h) {
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = tid + u * kThreads;
    if (i < n * kChunks) {
      const int t = i / kChunks, part = i % kChunks;
      held[u] = *reinterpret_cast<const uint4*>(
          qkv + off[t] * C3 + (part / 4) * C + h * kHd + (part % 4) * 8);
    }
  }
  if (table != nullptr) {
#pragma unroll
    for (int u = 0; u < kBiasLoads; ++u) {
      const int i = tid + u * kThreads;
      if (i < tw * tw) bias[u] = table[(size_t)i * heads + h];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    window_attn_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ table,
                       __nv_bfloat16* __restrict__ out, Params p) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int w = p.window, n = w * w, tw = 2 * w - 1;
  const int per_img = p.nwh * p.nww;
  const int b = blockIdx.x / per_img, rem = blockIdx.x % per_img;
  const int wy = rem / p.nww, wx = rem % p.nww;
  const long long C3 = 3LL * p.C;

  for (int t = tid; t < kT; t += kThreads) {
    const bool real = t < n;
    const int r = real ? t / w : 0, c = real ? t % w : 0;
    const int ys = wy * w + r, xs = wx * w + c;
    sm.off[t] = ((long long)b * p.H + (ys + p.shift) % p.H) * p.W +
                (xs + p.shift) % p.W;
    sm.ty[t] = r;
    sm.tx[t] = c;
    sm.region[t] = p.masked ? axis_region(ys, p.H, w, p.shift) * 3 +
                                  axis_region(xs, p.W, w, p.shift)
                            : 0;
    sm.col_key[t] = real ? (r * tw + c) | (sm.region[t] << 8) : -1;
  }
  // the pad tokens of q, k and v stay zero for every head
  for (int i = tid; i < (kT - n) * kLdQ; i += kThreads) {
    sm.q[n * kLdQ + i] = __float2bfloat16_rn(0.f);
    sm.k[n * kLdQ + i] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < kHd * (kT - n); i += kThreads)
    sm.vt[(i / (kT - n)) * kLdV + n + i % (kT - n)] =
        __float2bfloat16_rn(0.f);
  __syncthreads();

  const int h0 = blockIdx.y * kHeadsPerCta;
  const int h_end = min(p.heads, h0 + kHeadsPerCta);
  uint4 held[kLoads];
  float bias_held[kBiasLoads];
  fetch(held, bias_held, qkv, table, sm.off, tid, n, tw, C3, p.C, p.heads,
        h0);
  // this lane's two rows of S: a row's key r and a column's key c give
  // the bias's row of the table as r - c
  const int r0 = warp * 16;
  const int ra = r0 + g, rb = r0 + g + 8;
  const bool va = ra < n, vb = rb < n;
  const int key_a = sm.ty[ra] * tw + sm.tx[ra] + (w - 1) * (tw + 1);
  const int key_b = sm.ty[rb] * tw + sm.tx[rb] + (w - 1) * (tw + 1);
  const int reg_a = sm.region[ra], reg_b = sm.region[rb];

  for (int h = h0; h < h_end; ++h) {
    __syncthreads();   // the previous head's tiles are read
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      if (i < n * kChunks) {
        const int t = i / kChunks, part = i % kChunks;
        const int which = part / 4, c0 = (part % 4) * 8;
        if (which < 2) {
          *reinterpret_cast<uint4*>((which ? sm.k : sm.q) + t * kLdQ + c0) =
              held[u];
        } else {
          // v transposed: each 32-bit word holds channels 2e (low half)
          // and 2e + 1
          const uint32_t words[4] = {held[u].x, held[u].y, held[u].z,
                                     held[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sm.vt[(c0 + 2 * e) * kLdV + t] =
                __ushort_as_bfloat16((unsigned short)(words[e] & 0xffffu));
            sm.vt[(c0 + 2 * e + 1) * kLdV + t] =
                __ushort_as_bfloat16((unsigned short)(words[e] >> 16));
          }
        }
      }
    }
    if (table != nullptr) {
#pragma unroll
      for (int u = 0; u < kBiasLoads; ++u) {
        const int i = tid + u * kThreads;
        if (i < tw * tw) sm.bias[i] = bias_held[u];
      }
    }
    __syncthreads();
    if (h + 1 < h_end)   // in flight while this head runs
      fetch(held, bias_held, qkv, table, sm.off, tid, n, tw, C3, p.C,
            p.heads, h + 1);

    if (r0 >= n) continue;
    // S = Q K^T: 8 n-tiles of 8 keys, 2 k-steps of 16 channels
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const __nv_bfloat16* base = sm.q + ra * kLdQ + kk * 16 + 2 * t4;
      qa[kk][0] = ld32(base);
      qa[kk][1] = ld32(base + 8 * kLdQ);
      qa[kk][2] = ld32(base + 8);
      qa[kk][3] = ld32(base + 8 * kLdQ + 8);
    }
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const __nv_bfloat16* kb = sm.k + (8 * j + g) * kLdQ + kk * 16 + 2 * t4;
        mma_bf16(s[j], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }
    // the logits, their rows' max and the probabilities, in f32
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = sm.col_key[8 * j + 2 * t4 + (e & 1)];
        const bool row_a = e < 2;
        float v = -INFINITY;
        if (c >= 0) {
          v = __fmul_rn(s[j][e], p.scale);
          if (row_a ? va : vb) {
            if (table != nullptr)
              v = __fadd_rn(v, sm.bias[(row_a ? key_a : key_b) - (c & 255)]);
            if (p.masked && (row_a ? reg_a : reg_b) != (c >> 8))
              v = __fadd_rn(v, kMaskValue);
          }
        }
        s[j][e] = v;
        if (row_a) ma = fmaxf(ma, v); else mb = fmaxf(mb, v);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, o));
      mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, o));
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] == -INFINITY
                            ? 0.f : expf(s[j][e] - (e < 2 ? ma : mb));
        s[j][e] = x;
        if (e < 2) sa += x; else sb += x;
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sa += __shfl_xor_sync(kFull, sa, o);
      sb += __shfl_xor_sync(kFull, sb, o);
    }
    // P as the A fragments of 4 k-steps of 16 keys, then O = P V
    const float ia = __frcp_rn(sa), ib = __frcp_rn(sb);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(__fmul_rn(s[2 * kk][0], ia),
                            __fmul_rn(s[2 * kk][1], ia));
      pa[kk][1] = pack_bf16(__fmul_rn(s[2 * kk][2], ib),
                            __fmul_rn(s[2 * kk][3], ib));
      pa[kk][2] = pack_bf16(__fmul_rn(s[2 * kk + 1][0], ia),
                            __fmul_rn(s[2 * kk + 1][1], ia));
      pa[kk][3] = pack_bf16(__fmul_rn(s[2 * kk + 1][2], ib),
                            __fmul_rn(s[2 * kk + 1][3], ib));
    }
    __nv_bfloat16* oa = out + sm.off[ra] * p.C + h * kHd + 2 * t4;
    __nv_bfloat16* ob = out + sm.off[rb] * p.C + h * kHd + 2 * t4;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* vb2 = sm.vt + (8 * jn + g) * kLdV + 16 * kk + 2 * t4;
        mma_bf16(o, pa[kk], ld32(vb2), ld32(vb2 + 8));
      }
      if (va)
        *reinterpret_cast<uint32_t*>(oa + 8 * jn) = pack_bf16(o[0], o[1]);
      if (vb)
        *reinterpret_cast<uint32_t*>(ob + 8 * jn) = pack_bf16(o[2], o[3]);
    }
  }
}

}  // namespace

extern "C" int tpd_window_attention(const void* qkv, const void* table,
                                    void* out, int b, int h, int w, int c,
                                    int heads, int window, int shift,
                                    int masked, float scale, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (c != heads * kHd || window < 1 || window * window > kT ||
      (2 * window - 1) * (2 * window - 1) > kMaxTable || h % window ||
      w % window || shift < 0 || shift >= window)
    return (int)cudaErrorInvalidValue;
  const Params p = {b, h, w, c, heads, window, shift, masked,
                    h / window, w / window, scale};
  const dim3 grid(b * p.nwh * p.nww, tpd::ceil_div(heads, kHeadsPerCta));
  window_attn_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(table), static_cast<__nv_bfloat16*>(out), p);
  return (int)cudaGetLastError();
}
