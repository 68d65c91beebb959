// One-thread host copy of the staged upload (tpudet3d_torch/infer/upload.py):
// a chunk of frames from the caller's memory into the pinned staging buffer,
// from which the card's copy of that chunk is enqueued.
//
// ATen's CPU copy (what pin_memory() runs) stores through the cache: every
// destination line is first read from DRAM (read-for-ownership), so three
// streams of DRAM traffic move for each byte.  Here the stores are
// non-temporal (written to DRAM without that read), and the loads walk
// kPages pages in turn, a line of each, with the next block prefetched, as
// glibc's large-copy path does, so that several DRAM pages stream at once.
// The rate holds at a chunk of a few frames (glibc leaves its
// non-temporal path for copies that size).  The copy ends with a store
// fence, so the chunk is in memory before its card copy is enqueued.
// No thread is started.  Off x86-64 it is memcpy.
//
// Built with g++ into a shared library at first use and called through
// ctypes (tpudet3d_torch/native.py build_library), which releases the GIL.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>

namespace {

constexpr size_t kLine = 64;
constexpr size_t kPage = 4096;
constexpr size_t kPages = 4;
constexpr size_t kBlock = kPage * kPages;

// one 64-byte line: unaligned loads, aligned non-temporal stores (SSE2, so
// any x86-64 host runs it)
inline void line(uint8_t* d, const uint8_t* s) {
  const __m128i* in = reinterpret_cast<const __m128i*>(s);
  __m128i* out = reinterpret_cast<__m128i*>(d);
  __m128i a = _mm_loadu_si128(in);
  __m128i b = _mm_loadu_si128(in + 1);
  __m128i c = _mm_loadu_si128(in + 2);
  __m128i e = _mm_loadu_si128(in + 3);
  _mm_stream_si128(out, a);
  _mm_stream_si128(out + 1, b);
  _mm_stream_si128(out + 2, c);
  _mm_stream_si128(out + 3, e);
}

}  // namespace

extern "C" void host_stage_copy(void* dst, const void* src, size_t n) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  // head: up to the destination's next line, so that every store below is
  // to an aligned line
  size_t head = (kLine - (reinterpret_cast<uintptr_t>(d) & (kLine - 1)))
                & (kLine - 1);
  if (head > n) head = n;
  std::memcpy(d, s, head);
  d += head;
  s += head;
  n -= head;
  for (; n >= kBlock; d += kBlock, s += kBlock, n -= kBlock) {
    const bool next = n >= 2 * kBlock;
    for (size_t o = 0; o < kPage; o += kLine) {
      for (size_t p = 0; p < kPages; ++p) {
        if (next)
          _mm_prefetch(
              reinterpret_cast<const char*>(s + kBlock + p * kPage + o),
              _MM_HINT_T0);
        line(d + p * kPage + o, s + p * kPage + o);
      }
    }
  }
  for (; n >= kLine; d += kLine, s += kLine, n -= kLine) line(d, s);
  std::memcpy(d, s, n);
  _mm_sfence();
}

#else

extern "C" void host_stage_copy(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}

#endif
