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
// about 1.8 MB (logits and deltas) and writes 3 KB, 0.56 us at 3.35 TB/s.
// One CTA per (class, image) is 144 CTAs at batch 16, all resident at
// once (about 22 KB of shared memory each), so the time is the launch
// plus one CTA's chain of dependent steps, most ending in a barrier.  The
// first design spent it on K rounds of block argmax for the top K, on a
// second kernel for the merge and on a softmax repeated by every class's
// CTA.  This one shortens the chain:
// - one launch: the C class CTAs of an image form a thread-block cluster
//   (C <= 16; 9 needs the non-portable cluster size).  Each CTA copies
//   the logits of its slice of ceil(A/C) anchors into shared memory with
//   16-byte cp.async, computes their softmax once and writes each class's
//   score bits into that class's CTA through distributed shared memory;
// - the top K is a radix select over the score bits (which order like
//   the non-negative floats): 8-bit shared-memory histograms, most
//   significant digit first, ending early when a bucket is taken whole;
//   then an index-ordered compaction and a rank sort of the K picks,
//   whose anchors and deltas are loaded before the rank loop;
// - greedy NMS: the block turns the K x K IoUs into suppression bit rows;
//   one lane runs the chain over a word of 32 boxes with the rows in
//   registers (an AND and an OR per box), and the warp ORs the kept rows
//   into the later words.  Soft-NMS: the block computes the decay
//   factors (kept in shared memory up to K = 128); the K dependent rounds
//   stay, each two warp reductions and one multiply per held score, and
//   stop at the first round whose best score is at or below the floor
//   (later rounds only move scores that the floor zeroes).  Box voting:
//   a warp per survivor;
// - the merge: each class's list is already sorted (the survivors in the
//   order they were kept, then the zero rows by index).  After a cluster
//   barrier each CTA copies the first min(K, max_det) scores of every
//   list from the other CTAs' shared memory, ranks its own entries among
//   them by binary search and writes its rows of the top max_det itself:
//   no second kernel, no scratch in device memory.
// Ties break as lax.top_k and jnp.argmax do: higher score first, then
// lower index.  Scores, IoUs and decoded boxes are computed with the same
// IEEE operations in the same order as the plain PyTorch version (no fused
// multiply-adds there), so the two agree bit for bit on the card except in
// the box-vote sums.
//
// K above 256 (max_det above 64 on the serving path; lax.top_k takes any
// K <= A) runs a second instantiation of the same kernel, kLarge: the
// rank sort, decode, list and merge loop over the candidates; the greedy
// chain keeps two words of removed bits per lane (K <= 2048) and ORs each
// kept box's row into the later words with coalesced loads; soft-NMS
// decays the scores in place in shared memory (64 slots per lane); the
// bit rows skip the words left of the diagonal.  The rows (K * ceil(K/32)
// words) stay in shared memory while the CTA's layout fits, which is up
// to about K = 1100 at A = 2044; above that they go to a device scratch that
// the wrapper allocates, N * C * K * ceil(K/32) words.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // the radix scan takes one bin per thread
constexpr int kWarps = kThreads / 32;
constexpr int kSmallK = 256;        // the first instantiation's K
constexpr int kMaxK = 2048;         // two words of removed bits per lane
constexpr int kSlots = kSmallK / 32; // scores per lane in the soft-NMS warp
constexpr int kMatrixMaxK = 128;     // decays in shared memory up to this K
constexpr int kMaxCluster = 16;      // classes per image (cluster size)
constexpr int kMaxSmem = 232448;

// inv_sigma is 1/sigma rounded to f32: the plain version multiplies by
// the same reciprocal, as PyTorch does for a division by a scalar
struct Params {
  float score_thr, iou_thr, inv_sigma, dup_iou, vote_iou, log_clip;
};

__host__ __device__ inline int up16(int b) { return (b + 15) & ~15; }

// Byte offsets of the shared-memory regions and the words of device
// scratch per CTA; detect/nms.py decode_nms_plan computes the same total
// and words.  Region 0 holds the CTA's slice of logits, then the soft-NMS
// decays and the greedy bit rows, then the other classes' score lists.
// Above kSmallK there are no decays, and the bit rows move to the scratch
// when they would not fit.
struct Layout {
  int key, hist, misc, perk, bytes, scratch;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout make_layout(int a, int c, int k,
                                              int max_det) {
  const int w = (k + 31) / 32, m = k < max_det ? k : max_det;
  const int logits = ((a + c - 1) / c * (c + 1) + 4) * 4;
  const int tail = up16(a * 4) + 2 * 256 * 4 + 64 * 4 + k * 60;
  int nms = (k <= kMatrixMaxK ? k * k * 4 : 0) + k * w * 4;
  Layout l;
  l.scratch = 0;
  if (k > kSmallK &&
      up16(imax(imax(logits, nms), c * m * 4)) + tail > kMaxSmem) {
    nms = 0;
    l.scratch = k * w;
  }
  l.key = up16(imax(imax(logits, nms), c * m * 4));  // [A] score bits
  l.hist = l.key + up16(a * 4);     // [2][256] radix histograms
  l.misc = l.hist + 2 * 256 * 4;    // [64] scan totals and scalars
  l.perk = l.misc + 64 * 4;         // 15 words per candidate
  l.bytes = l.perk + k * 60;
  return l;
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Exclusive prefix sum of v over the block in thread order; every thread
// calls it.  s_tot holds kWarps ints; callers separate two uses of the
// same s_tot by a barrier.
__device__ __forceinline__ int block_scan_excl(int v, int* s_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_tot[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_tot[w];
  return before + x - v;
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

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Greedy NMS over the bit rows for K up to kMaxK, by one warp: lane l
// holds words l and l + 32 of the removed bits.  Word by word, lane 0 runs
// the chain over the word's 32 boxes with their rows in registers (zero
// scores start removed), then every lane ORs the kept boxes' rows into its
// later words, a row's words read by consecutive lanes.
__device__ __forceinline__ void greedy_chain_large(
    const float* s_top, const unsigned* mask, float* s_kept, int* s_ord,
    int* s_ns, int K, int W, int lane) {
  unsigned rem0 = 0u, rem1 = 0u;
  int ns = 0;
  for (int w = 0; w < W; ++w) {
    const int i = 32 * w + lane;
    const bool pos = i < K && s_top[i] > 0.f;
    unsigned cur = __shfl_sync(0xffffffffu, w < 32 ? rem0 : rem1, w & 31) |
                   ~__ballot_sync(0xffffffffu, pos);
    if (lane == 0) {
      unsigned rows[32];
#pragma unroll
      for (int b = 0; b < 32; ++b)
        rows[b] = 32 * w + b < K ? mask[(size_t)(32 * w + b) * W + w] : 0u;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        cur |= rows[b] & (((cur >> b) & 1u) - 1u);
    }
    const unsigned kept = ~__shfl_sync(0xffffffffu, cur, 0);
    const bool kept_i = (kept >> lane) & 1u;
    if (kept_i) s_ord[ns + __popc(kept & ((1u << lane) - 1u))] = i;
    if (i < K) s_kept[i] = kept_i ? s_top[i] : 0.f;
    ns += __popc(kept);
    const bool own0 = lane > w && lane < W;
    const bool own1 = lane + 32 > w && lane + 32 < W;
#pragma unroll 8
    for (int b = 0; b < 32; ++b) {
      if (!((kept >> b) & 1u)) continue;
      const unsigned* row = mask + (size_t)(32 * w + b) * W;
      if (own0) rem0 |= row[lane];
      if (own1) rem1 |= row[lane + 32];
    }
  }
  if (lane == 0) *s_ns = ns;
}

// Gaussian soft-NMS for K up to kMaxK, by one warp, on the scores in
// s_kept (decayed in place): lane l holds slots j = l + 32 r, bit r of
// done marks slot r processed.  Each round takes the highest unprocessed
// score (lowest index among equals) by two warp reductions and decays the
// others by exp(-iou^2 / sigma), 0 above the duplicate cutoff, computing
// the IoUs on the fly; it stops at the first round whose best score is at
// or below the floor.  The processed scores are the survivors.
__device__ __forceinline__ void soft_nms_large(
    const float* s_top, const float* s_box, float* s_kept, int* s_ord,
    int* s_ns, int K, int W, int lane, const Params& prm) {
  unsigned long long done = 0ull;
  for (int r = 0; r < W; ++r) {
    const int j = 32 * r + lane;
    if (j < K)
      s_kept[j] = s_top[j];
    else
      done |= 1ull << r;
  }
  const float stop = fmaxf(prm.score_thr, 0.f);
  int ns = 0;
  for (int round = 0; round < K; ++round) {
    unsigned best = 0u;
    int bj = 0x7fffffff;
    for (int r = 0; r < W; ++r) {
      if ((done >> r) & 1ull) continue;
      const unsigned v = __float_as_uint(s_kept[32 * r + lane]);
      if (v > best) {
        best = v;
        bj = 32 * r + lane;
      }
    }
    const unsigned top = __reduce_max_sync(0xffffffffu, best);
    if (!(__uint_as_float(top) > stop)) break;
    const int bi = (int)__reduce_min_sync(
        0xffffffffu, best == top ? (unsigned)bj : 0xffffffffu);
    if (lane == 0) s_ord[ns] = bi;
    ++ns;
    const float* bb = s_box + 4 * bi;
    for (int r = 0; r < W; ++r) {
      const int j = 32 * r + lane;
      if ((done >> r) & 1ull || j == bi) continue;
      const float o = iou(bb, s_box + 4 * j);
      const float dcy =
          o > prm.dup_iou ? 0.f
                          : expf(__fmul_rn(-__fmul_rn(o, o), prm.inv_sigma));
      s_kept[j] = __fmul_rn(s_kept[j], dcy);
    }
    if ((bi & 31) == lane) done |= 1ull << (bi >> 5);
  }
  for (int r = 0; r < W; ++r) {
    const int j = 32 * r + lane;
    if (j < K && !((done >> r) & 1ull)) s_kept[j] = 0.f;
  }
  if (lane == 0) *s_ns = ns;
}

// grid (C, N), cluster (C, 1, 1): CTA c of cluster n is class c of image
// n.  kLarge: K above kSmallK (see the note at the top).
template <bool kLarge>
__global__ void __launch_bounds__(kThreads, 2)
    decode_nms_kernel(const float* __restrict__ logits,
                      const float* __restrict__ deltas,
                      const float* __restrict__ anchors,
                      float* __restrict__ out, unsigned* __restrict__ scratch,
                      int A, int C, int K, int max_det, Params prm,
                      Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool soft = prm.inv_sigma > 0.f, vote = prm.vote_iou > 0.f;
  const bool full = !kLarge && K <= kMatrixMaxK;
  const int W = (K + 31) >> 5, M = min(K, max_det);
  // region 0: the CTA's slice of logits, then the soft-NMS decays [K, K]
  // (up to kMatrixMaxK) and the greedy bit rows [K, W] (or the rows in the
  // device scratch), then the first M scores of every class [C, M]
  float* stage = reinterpret_cast<float*>(smem);
  float* decay_m = stage;
  unsigned* mask = reinterpret_cast<unsigned*>(smem) + (full ? K * K : 0);
  if (kLarge && L.scratch)
    mask = scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * L.scratch;
  float* all_sc = stage;
  unsigned* key = reinterpret_cast<unsigned*>(smem + L.key);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* s_tot = reinterpret_cast<int*>(smem + L.misc);      // [kWarps]
  int* s_sel = s_tot + kWarps;                   // digit, above, count
  int* s_ns = s_sel + 3;                                   // survivors
  unsigned* cand_key = reinterpret_cast<unsigned*>(smem + L.perk);
  int* cand_idx = reinterpret_cast<int*>(cand_key + K);
  float* s_top = reinterpret_cast<float*>(cand_idx + K);   // sorted scores
  float* s_kept = s_top + K;                               // after NMS
  float* s_box = s_kept + K;                               // [K, 4]
  float* s_vbox = s_box + 4 * K;                           // [K, 4] voted
  int* s_ord = reinterpret_cast<int*>(s_vbox + 4 * K);     // survivors
  float* l_score = reinterpret_cast<float*>(s_ord + K);    // merge order
  int* l_j = reinterpret_cast<int*>(l_score + K);

  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.x, n = blockIdx.y, C1 = C + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // no CTA writes into another before all of the cluster have started
  cluster_arrive_relaxed();

  // 1. this CTA's slice of the image's anchors, [a_lo, a_hi), its logits
  // into shared memory: element i of the slice at st[i], so that 16-byte
  // aligned global chunks land on aligned words
  const int per = (A + C - 1) / C;
  const int a_lo = min(A, c * per), a_hi = min(A, a_lo + per);
  const float* lg = logits + ((size_t)n * A + a_lo) * C1;
  const int total = (a_hi - a_lo) * C1;
  const int shift = (int)((reinterpret_cast<uintptr_t>(lg) >> 2) & 3);
  const int head = min((4 - shift) & 3, total);
  const int chunks = (total - head) >> 2;
  float* st = stage + shift;
  for (int i = tid; i < chunks; i += kThreads)
    cp_async16(st + head + 4 * i, lg + head + 4 * i);
  for (int i = head + 4 * chunks + tid; i < total; i += kThreads)
    st[i] = lg[i];
  if (tid < head) st[tid] = lg[tid];
  for (int i = tid; i < 2 * 256; i += kThreads) hist[i] = 0;
  cp_async_wait_all();
  __syncthreads();
  cluster_wait();

  // 2. softmax over all C + 1 logits of each anchor of the slice,
  // sequential sum, then the score floor; the score bits of class cc go
  // to CTA cc's key array
  for (int a = a_lo + tid; a < a_hi; a += kThreads) {
    float* l = st + (a - a_lo) * C1;
    float m = l[0];
    for (int j = 1; j < C1; ++j) m = fmaxf(m, l[j]);
    float s = 0.f;
    for (int j = 0; j < C1; ++j) {
      const float e = expf(__fsub_rn(l[j], m));
      s = __fadd_rn(s, e);
      l[j] = e;
    }
    for (int cc = 0; cc < C; ++cc) {
      const float p = __fdiv_rn(l[cc], s);
      cluster.map_shared_rank(key, cc)[a] =
          __float_as_uint(p > prm.score_thr ? p : 0.f);
    }
  }
  cluster.sync();

  // 3. the K-th largest score bits T by radix select, most significant
  // digit first; kk is the rank still sought inside the current bucket.
  // Scores lie in [0, 1], so bits 31 and 30 are 0 and the digits are
  // bits 29-22, 21-14, 13-6 and 5-0.  A bucket that holds exactly the kk
  // still sought is taken whole, which ends the select early: T is then
  // one below the bucket's least key and kk 0.
  unsigned prefix = 0u, pmask = 0u;
  int kk = K;
  for (int pass = 0; pass < 4; ++pass) {
    const int sh = pass < 3 ? 22 - 8 * pass : 0;
    const unsigned dmask = pass < 3 ? 255u : 63u;
    int* h = hist + 256 * (pass & 1);
    for (int a = tid; a < A; a += kThreads) {
      const unsigned v = key[a];
      if ((v & pmask) == prefix) atomicAdd(&h[(v >> sh) & dmask], 1);
    }
    __syncthreads();
    // thread t holds digit 255 - t, so the scan counts the larger digits
    const int cnt = h[255 - tid];
    const int above = block_scan_excl(cnt, s_tot);
    if (above < kk && kk <= above + cnt) {
      s_sel[0] = 255 - tid;
      s_sel[1] = above;
      s_sel[2] = cnt;
    }
    hist[256 * ((pass + 1) & 1) + tid] = 0;
    __syncthreads();
    prefix |= (unsigned)s_sel[0] << sh;
    pmask |= dmask << sh;
    kk -= s_sel[1];
    if (s_sel[2] == kk && prefix != 0u) {
      prefix -= 1u;
      kk = 0;
      break;
    }
  }

  // 4. lax.top_k's picks in index order: every score above T and the kk
  // lowest-index scores equal to T.  Thread t scans a contiguous range.
  const unsigned T = prefix;
  const int span = (A + kThreads - 1) / kThreads;
  const int r0 = min(A, tid * span), r1 = min(A, r0 + span);
  int gt = 0, eq = 0;
  for (int a = r0; a < r1; ++a) {
    const unsigned v = key[a];
    gt += v > T;
    eq += v == T;
  }
  const int pre = block_scan_excl(gt | (eq << 16), s_tot);
  int pg = pre & 0xffff, pe = pre >> 16;
  for (int a = r0; a < r1; ++a) {
    const unsigned v = key[a];
    int pos = -1;
    if (v > T) {
      pos = pg++;
    } else if (v == T) {
      if (pe < kk) pos = K - kk + pe;
      ++pe;
    }
    if (pos >= 0) {
      cand_key[pos] = v;
      cand_idx[pos] = a;
    }
  }
  __syncthreads();

  // 5. rank sort of the picks by (score desc, index asc), and the delta
  // decode of each pick into its sorted place (coder.decode_boxes,
  // DEFAULT_STDS)
  for (int t = tid; t < K; t += kThreads) {
    const unsigned v = cand_key[t];
    const int ia = cand_idx[t];
    // the pick's anchor and deltas, loaded before the rank loop
    const float* pa = anchors + (size_t)ia * 4;
    const float* pd = deltas + ((size_t)n * A + ia) * 4;
    const float an[4] = {pa[0], pa[1], pa[2], pa[3]};
    const float d[4] = {pd[0], pd[1], pd[2], pd[3]};
    int r = 0;
    for (int j = 0; j < K; ++j) {
      const unsigned u = cand_key[j];
      r += u > v || (u == v && cand_idx[j] < ia);
    }
    s_top[r] = __uint_as_float(v);
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
    float* b = s_box + 4 * r;
    b[0] = __fsub_rn(cx, __fmul_rn(bw, 0.5f));
    b[1] = __fsub_rn(cy, __fmul_rn(bh, 0.5f));
    b[2] = __fadd_rn(cx, __fmul_rn(bw, 0.5f));
    b[3] = __fadd_rn(cy, __fmul_rn(bh, 0.5f));
  }
  __syncthreads();

  // 6. by the whole block: soft-NMS's decay factors exp(-iou^2 / sigma),
  // 0 above the duplicate cutoff; greedy NMS's suppression rows, bit j of
  // row i set when j > i overlaps i above iou_thr
  if (soft) {
    if (full) {
      for (int p = tid; p < K * K; p += kThreads) {
        const int i = p / K, j = p - i * K;
        const float o = iou(s_box + 4 * i, s_box + 4 * j);
        decay_m[p] = o > prm.dup_iou
                         ? 0.f
                         : expf(__fmul_rn(-__fmul_rn(o, o), prm.inv_sigma));
      }
      __syncthreads();
    }
  } else {
    for (int task = warp; task < K * W; task += kWarps) {
      const int i = task / W, j = 32 * (task - i * W) + lane;
      // a word wholly left of the diagonal holds no bit
      if (kLarge && j - lane + 31 <= i) {
        if (lane == 0) mask[task] = 0u;
        continue;
      }
      const bool b = j > i && j < K &&
                     iou(s_box + 4 * i, s_box + 4 * j) > prm.iou_thr;
      const unsigned word = __ballot_sync(0xffffffffu, b);
      if (lane == 0) mask[task] = word;
    }
    __syncthreads();
  }

  // 7. the NMS chain; s_ord lists the survivors in the order they were
  // kept, which is (score desc, index asc)
  if constexpr (kLarge) {
    if (warp == 0) {
      if (!soft)
        greedy_chain_large(s_top, mask, s_kept, s_ord, s_ns, K, W, lane);
      else
        soft_nms_large(s_top, s_box, s_kept, s_ord, s_ns, K, W, lane, prm);
    }
  } else if (!soft) {
    if (warp == 0) {
      // word by word: lane w2 holds word w2 of the removed bits; lane 0
      // runs the chain over the word's 32 boxes with their rows in
      // registers (zero scores start removed: they are never kept), then
      // the kept boxes' rows are ORed into the later words
      unsigned rem = 0u;
      int ns = 0;
      for (int w = 0; w < W; ++w) {
        const int i = 32 * w + lane;
        const bool pos = i < K && s_top[i] > 0.f;
        unsigned cur = __shfl_sync(0xffffffffu, rem, w) |
                       ~__ballot_sync(0xffffffffu, pos);
        if (lane == 0) {
          unsigned rows[32];
#pragma unroll
          for (int b = 0; b < 32; ++b)
            rows[b] = 32 * w + b < K ? mask[(32 * w + b) * W + w] : 0u;
#pragma unroll
          for (int b = 0; b < 32; ++b)
            cur |= rows[b] & (((cur >> b) & 1u) - 1u);
        }
        const unsigned kept = ~__shfl_sync(0xffffffffu, cur, 0);
        const bool kept_i = (kept >> lane) & 1u;
        if (kept_i) s_ord[ns + __popc(kept & ((1u << lane) - 1u))] = i;
        if (i < K) s_kept[i] = kept_i ? s_top[i] : 0.f;
        ns += __popc(kept);
        for (int w2 = w + 1; w2 < W; ++w2) {
          const unsigned o =
              __reduce_or_sync(0xffffffffu, kept_i ? mask[i * W + w2] : 0u);
          if (lane == w2) rem |= o;
        }
      }
      if (lane == 0) *s_ns = ns;
    }
  } else if (warp == 0) {
    // lane holds scores j = lane + 32 r; bit r of done: processed.  Each
    // round: the highest unprocessed score (lowest index among equals)
    // by two warp reductions, then one decay per held score.
    int ns = 0;
    float sv[kSlots];
    unsigned done = 0u;
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      const int j = 32 * r + lane;
      sv[r] = j < K ? s_top[j] : 0.f;
      if (j >= K) done |= 1u << r;
    }
    const float stop = fmaxf(prm.score_thr, 0.f);
    for (int round = 0; round < K; ++round) {
      unsigned best = 0u;
      int bj = 0x7fffffff;
#pragma unroll
      for (int r = 0; r < kSlots; ++r)
        if (r < W && !((done >> r) & 1u) &&
            __float_as_uint(sv[r]) > best) {
          best = __float_as_uint(sv[r]);
          bj = 32 * r + lane;
        }
      const unsigned top = __reduce_max_sync(0xffffffffu, best);
      // later rounds only decay scores at or below the floor
      if (!(__uint_as_float(top) > stop)) break;
      const int bi = (int)__reduce_min_sync(
          0xffffffffu, best == top ? (unsigned)bj : 0xffffffffu);
      if (lane == 0) s_ord[ns] = bi;
      ++ns;
      const float* bb = s_box + 4 * bi;
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int j = 32 * r + lane;
        if (r >= W) break;
        if ((done >> r) & 1u || j == bi) continue;
        float dcy;
        if (full) {
          dcy = decay_m[bi * K + j];
        } else {
          const float o = iou(bb, s_box + 4 * j);
          dcy = o > prm.dup_iou
                    ? 0.f
                    : expf(__fmul_rn(-__fmul_rn(o, o), prm.inv_sigma));
        }
        sv[r] = __fmul_rn(sv[r], dcy);
      }
      if ((bi & 31) == lane) done |= 1u << (bi >> 5);
    }
    // the processed scores are the survivors, all above the floor
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      const int j = 32 * r + lane;
      if (j < K) s_kept[j] = (done >> r) & 1u ? sv[r] : 0.f;
    }
    if (lane == 0) *s_ns = ns;
  }
  __syncthreads();
  const int ns = *s_ns;

  // 8. box voting: a warp per survivor, over all K candidates
  if (vote) {
    for (int q = warp; q < ns; q += kWarps) {
      const int i = s_ord[q];
      const float* bi = s_box + 4 * i;
      float ws = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = lane; j < K; j += 32) {
        const float* bj = s_box + 4 * j;
        const float wgt = iou(bi, bj) > prm.vote_iou ? s_top[j] : 0.f;
        ws += wgt;
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[t] += wgt * bj[t];
      }
      ws = warp_sum(ws);
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] = warp_sum(acc[t]);
      const float den = fmaxf(ws, 1e-9f);
      if (lane == 0)
        for (int t = 0; t < 4; ++t) s_vbox[4 * i + t] = acc[t] / den;
    }
  }

  // 9. the class's list in merge order: the survivors in s_ord order,
  // then the other candidates with score 0 in index order, kThreads
  // candidates per scan
  for (int base = 0, zeros = 0; base < (kLarge ? K : 1); base += kThreads) {
    const int t = base + tid;
    const bool zero = t < K && !(s_kept[t] > 0.f);
    const int zpos = zeros + block_scan_excl(zero, s_tot);
    if (zero) {
      l_score[ns + zpos] = 0.f;
      l_j[ns + zpos] = t;
    }
    if (kLarge) {
      for (int w = 0; w < kWarps; ++w) zeros += s_tot[w];
      __syncthreads();   // before the next scan writes s_tot
    }
  }
  for (int t = tid; t < ns; t += kThreads) {
    l_score[t] = s_kept[s_ord[t]];
    l_j[t] = s_ord[t];
  }
  cluster.sync();

  // 10. the first M scores of every class's list, read from the other
  // CTAs' shared memory; no CTA leaves before all have read
  for (int i = tid; i < C * M; i += kThreads) {
    const int cc = i / M;
    const float* remote = cluster.map_shared_rank(l_score, cc);
    all_sc[i] = remote[i - cc * M];
  }
  cluster.sync();

  // 11. global rank of each of this class's first M entries: its place
  // in its own list plus the entries of other classes that beat it
  // (higher score, or equal score and a lower class: the flat index
  // order of the plain version's stable sort)
  for (int t = tid; t < M; t += kThreads) {
    const float s = l_score[t];
    int rank = t;
    for (int cc = 0; cc < C; ++cc) {
      if (cc == c) continue;
      const float* lst = all_sc + cc * M;
      int lo = 0, hi = M;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float v = lst[mid];
        if (v > s || (v == s && cc < c))
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank < max_det) {
      const int j = l_j[t];
      const float* b =
          prm.vote_iou > 0.f && s > 0.f ? s_vbox + 4 * j : s_box + 4 * j;
      float* o = out + ((size_t)n * max_det + rank) * 6;
      o[0] = b[0];
      o[1] = b[1];
      o[2] = b[2];
      o[3] = b[3];
      o[4] = s;
      o[5] = (float)c;
    }
  }
}


template <bool kLarge>
int launch(const float* logits, const float* deltas, const float* anchors,
           float* out, unsigned* scratch, int n, int a, int c, int k,
           int max_det, const Params& prm, const Layout& l, int device,
           cudaStream_t stream) {
  // the dynamic shared memory opted into so far, per device
  static int opted[64] = {};
  cudaError_t err;
  if (l.bytes > opted[device]) {
    err = cudaFuncSetAttribute(decode_nms_kernel<kLarge>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               l.bytes);
    if (err != cudaSuccess) return (int)err;
    // clusters of more than 8 CTAs (9 classes) are not portable
    err = cudaFuncSetAttribute(decode_nms_kernel<kLarge>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
    opted[device] = l.bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = l.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_nms_kernel<kLarge>, logits, deltas,
                           anchors, out, scratch, a, c, k, max_det, prm, l);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// smem_bytes and scratch_words (per CTA) come from detect/nms.py
// decode_nms_plan; the entry refuses a mismatch with its own layout and
// any shape the kernel does not take.  scratch holds n * c *
// scratch_words words when scratch_words is not 0.
extern "C" int tpd_decode_nms(const void* logits, const void* deltas,
                              const void* anchors, void* out, void* scratch,
                              int n, int a, int c, int k, int max_det,
                              float score_thr, float iou_thr, float inv_sigma,
                              float dup_iou, float vote_iou, float log_clip,
                              int smem_bytes, int scratch_words, int device,
                              void* stream) {
  if (n < 1 || a < 1 || a >= 65536 || c < 1 || c > kMaxCluster || k < 1 ||
      k > kMaxK || k > a || max_det < 1 || max_det > c * k)
    return (int)cudaErrorInvalidValue;
  const Layout l = make_layout(a, c, k, max_det);
  if (l.bytes != smem_bytes || l.bytes > kMaxSmem ||
      l.scratch != scratch_words || (l.scratch && !scratch))
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params prm = {score_thr, iou_thr, inv_sigma, dup_iou, vote_iou,
                      log_clip};
  const float* lg = static_cast<const float*>(logits);
  const float* dl = static_cast<const float*>(deltas);
  const float* an = static_cast<const float*>(anchors);
  float* o = static_cast<float*>(out);
  unsigned* sc = static_cast<unsigned*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kSmallK)
    return launch<true>(lg, dl, an, o, sc, n, a, c, k, max_det, prm, l,
                        device, s);
  return launch<false>(lg, dl, an, o, sc, n, a, c, k, max_det, prm, l,
                       device, s);
}
