// ALC3 segment word-rANS encode and decode for Hopper (sm_90a).
//
// Replaces the TPU kernels of alice_codec_tpu/ops/pallas/rans3_kernels.py:
//   * encode_words_pallas (_encode_kernel)
//   * decode_words_pallas (_decode_kernel, _decode_slot_body)
// and computes, word for word, the NumPy spec alice_codec_tpu/ops/rans_word.py
// (encode_segment_words / _decode_segment_core, with all-zero segments
// elided as count 0).
//
// What bounds it on the H100: the serial state chain.  Each segment is
// s_seg steps (2048 on the main path) that depend on one another through
// the per-lane rANS state and the segment's single word cursor.  One warp
// takes ~400 cycles a step, so a launch is never shorter than ~0.4 ms;
// with 12 segments an SM the encoder's stores (the zero tail is 1.6 GB at
// full width) and both kernels' instruction issue set the time.  So the
// design keeps the step short and lets many chains run at once:
//
//   * One warp per segment, four lanes a thread: thread t owns lanes
//     4t..4t+3, so one 32-bit load (or store) moves its four symbols of a
//     step, 128 B a warp.  A lane's rank among the emitting (encode) or
//     refilling (decode) lanes is four __ballot_sync + __popc and one
//     shuffle, so no barrier and no shared-memory prefix sits in the
//     chain.  A block is one warp with its table in shared memory at fixed
//     addresses (256 16-byte symbol entries for encode; for decode the
//     2048-entry fused slot LUT the wrapper builds as the JAX package builds
//     it in XLA, laid out again on load); 1536 segments are one wave on
//     132 SMs.
//   * Each segment names its table (`table`, one int32 per segment), so one
//     launch codes every plane of a chunk, whatever their tables.
//   * No global load in the chain.  The encoder loads its symbols
//     kSymAhead steps ahead into registers (double-buffered).  The decoder
//     reads its stream back to front, at most 128 words a step, through a
//     shared-memory ring of the words below its cursor that cp.async keeps
//     kAhead 128-word chunks ahead of use.
//   * The encoder divides by its frequency with a multiply-high by a
//     per-symbol reciprocal and one correction (put_symbol), and zeroes its
//     stream's tail during the chain, the rows of 128 words the steps left
//     can no longer reach.  It reads its symbols once: whether a segment is
//     all zero (elided, count 0) is known at the end of its chain.
//
// Words are stored one per int32 in the wire layout of the JAX package:
// stream i is a stream_rows(s_seg) x 128 block, words in emission order,
// zero past the count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NG = 128;
constexpr int PROB_BITS = 11;
constexpr int PROB_SCALE = 1 << PROB_BITS;
constexpr unsigned WORD_L = 1u << 16;
constexpr int EMIT_SHIFT = 32 - PROB_BITS;
constexpr unsigned FULL = 0xffffffffu;

constexpr int kSymAhead = 16;  // steps of symbols the encoder loads ahead
constexpr int kChunk = 128;    // words one cp.async round brings (16 B a thread)
constexpr int kRing = 1024;    // words of the decoder's ring (8 chunks)
constexpr int kAhead = 4;      // chunks in flight below the lowest a step reads

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Rank of the thread's first lane among the flagged lanes of the warp's
// 128 (ascending lane order), and their total k.  flag[i]: sub-lane i;
// lane 4t+i comes after every flagged lane of threads < t and after the
// thread's own flagged sub-lanes < i.  The total is the last thread's
// rank plus its count, one shuffle instead of four more popcounts.
__device__ __forceinline__ int rank_base(const bool (&flag)[4], int* total) {
  const unsigned lt = lanes_below();
  int r = 0, own = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r += __popc(__ballot_sync(FULL, flag[i]) & lt);
    own += flag[i];
  }
  *total = __shfl_sync(FULL, r + own, 31);
  return r;
}

// A symbol's encode entry: the reciprocal m = floor((2^32 - 1) / f), the
// emit threshold f 2^21 - 1 (x above it emits; f = 2048 gives 2^32 - 1,
// which no x is above), g = 2048 - f and the cumulative frequency c.
__device__ __forceinline__ uint4 enc_entry(unsigned f, unsigned c) {
  return make_uint4(FULL / f, (f << EMIT_SHIFT) - 1u, PROB_SCALE - f, c);
}

// The encoder's state update x' = (x / f) << PROB_BITS | x % f, plus c,
// for x < 2^32 and e = enc_entry(f, c).  With q0 = floor(x m / 2^32):
// since 2^32/f - 1 <= m < 2^32/f,
//   x/f - 1 < x/f - x/2^32 <= x m / 2^32 < x/f,
// so q0 is floor(x/f) or one less, and r0 = x - q0 f lies in [0, 2f).
// Then q = q0 + p and r = r0 - p f with p = (r0 >= f) = (r0 + g >= 2048),
// and x' = 2048 q + r + c = x + q g + c = t + c + p g with t = x + q0 g,
// r0 = t - 2048 q0.  (f = 1: m = 2^32 - 1, q0 = x - 1 for x >= 1, p = 1.)
__device__ __forceinline__ unsigned put_symbol(unsigned x, const uint4& e) {
  const unsigned q0 = __umulhi(x, e.x);
  const unsigned t = x + q0 * e.z;
  const unsigned r0 = t - (q0 << PROB_BITS);
  return t + e.w + (r0 + e.z >= (unsigned)PROB_SCALE ? e.z : 0u);
}

// The same update by hardware division: rcp_mismatches' reference.
__device__ __forceinline__ unsigned put_symbol_div(unsigned x, const uint4& e) {
  const unsigned f = PROB_SCALE - e.z;
  const unsigned q = x / f;
  return (q << PROB_BITS) + (x - q * f) + e.w;
}

// grid n, block 32: the warp of block seg codes segment seg with table
// table[seg] (rows of freqs / cums).  A block is one warp, so its shared
// arrays are the warp's own and sit at fixed addresses.
__global__ void __launch_bounds__(32)
    encode_words(const uint8_t* __restrict__ sym, const int32_t* __restrict__ freqs,
                 const int32_t* __restrict__ cums, const int32_t* __restrict__ table,
                 int32_t* __restrict__ streams, int32_t* __restrict__ counts,
                 int s_seg, int w_words) {
  __shared__ uint4 tab[256];
  const int lane = threadIdx.x, seg = blockIdx.x;
  const int32_t* fr = freqs + (size_t)table[seg] * 256;
  const int32_t* cu = cums + (size_t)table[seg] * 256;
  for (int i = lane; i < 256; i += 32)
    // the 11-bit fields of the TPU kernel's packed (f-1) << 11 | cum
    // entry: a frequency-0 symbol (which a valid plane never holds, wire
    // v7) reads as 2048, never as a division by zero
    tab[i] = enc_entry(((unsigned)(fr[i] - 1) & (PROB_SCALE - 1)) + 1u,
                       (unsigned)cu[i] & (PROB_SCALE - 1));
  const uint8_t* s = sym + (size_t)seg * s_seg * NG;
  int32_t* out = streams + (size_t)seg * w_words;
  int4* out4 = reinterpret_cast<int4*>(out);
  const int4 zero4 = make_int4(0, 0, 0, 0);

  __syncwarp();  // the table

  // Words [zlo, w_words) are zero.  Before step j (j steps and the two
  // flush rows left) the cursor can still grow by at most 128 (j + 2), so
  // the rows above that are final: they are zeroed as the bound falls,
  // after every kSymAhead steps, instead of all at the end.
  int zlo = w_words;
  auto zero_above = [&](int bound) {
    const int lo = (bound + NG - 1) & ~(NG - 1);
    for (; zlo - NG >= lo; zlo -= NG) out4[(zlo - NG) / 4 + lane] = zero4;
  };
  int cur = 0;
  zero_above(NG * (s_seg + 2));

  unsigned x[4] = {WORD_L, WORD_L, WORD_L, WORD_L};
  unsigned any = 0;  // whether the segment holds a nonzero symbol
  const unsigned* sw = reinterpret_cast<const unsigned*>(s) + lane;  // step j: sw[32 j]
  unsigned buf[kSymAhead], nxt[kSymAhead];
#pragma unroll
  for (int b = 0; b < kSymAhead; ++b) {
    const int j = s_seg - 1 - b;
    buf[b] = j >= 0 ? __ldg(sw + (size_t)j * 32) : 0u;
  }
  for (int j0 = s_seg - 1; j0 >= 0; j0 -= kSymAhead) {  // LIFO: last step first
#pragma unroll
    for (int b = 0; b < kSymAhead; ++b) {
      const int j = j0 - kSymAhead - b;
      nxt[b] = j >= 0 ? __ldg(sw + (size_t)j * 32) : 0u;
    }
#pragma unroll
    for (int b = 0; b < kSymAhead; ++b) {
      if (j0 - b < 0) break;
      uint4 e[4];
      bool emit[4];
      any |= buf[b];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = tab[(buf[b] >> (8 * i)) & 255u];
        emit[i] = x[i] > e[i].y;
      }
      int k;
      int32_t* o = out + cur;
      int r = rank_base(emit, &k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (emit[i]) o[r] = (int32_t)(x[i] & 0xFFFFu);
        r += emit[i];
        x[i] = put_symbol(emit[i] ? x[i] >> 16 : x[i], e[i]);
      }
      cur += k;
    }
    zero_above(cur + NG * (max(j0 - kSymAhead + 1, 0) + 2));
#pragma unroll
    for (int b = 0; b < kSymAhead; ++b) buf[b] = nxt[b];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[cur + 4 * lane + i] = (int32_t)(x[i] >> 16);           // state flush: hi row
    out[cur + NG + 4 * lane + i] = (int32_t)(x[i] & 0xFFFFu);  // then lo row
  }
  cur += 2 * NG;
  if (!__any_sync(FULL, any != 0)) {
    // an all-zero segment is elided: count 0, every word zero.  Its chain
    // ran all the same (deciding first would read the symbols twice).
    __syncwarp();  // the words written above come before their zeros
    cur = 0;
  }
  for (int i = cur + lane; i < zlo; i += 32) out[i] = 0;
  if (lane == 0) counts[seg] = cur;
}

// A word of the segment's stream, or 0 outside [0, w_words) (only a
// corrupt count can point there).
__device__ __forceinline__ unsigned word_at(const int32_t* st, int i,
                                            int w_words) {
  return (i >= 0 && i < w_words) ? (unsigned)st[i] : 0u;
}

// cp.async of 16 bytes to the shared-memory address dst; the bytes past
// src_bytes (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The lowest 128-word chunk a step at cursor `cur` may read: it reads
// [max(cur - k, 0), ...) with k <= 128.
__device__ __forceinline__ int chunk_needed(int cur) {
  return max(cur - NG, 0) / kChunk;
}

// grid n, block 32: the warp of block seg decodes segment seg with the
// slot LUT table[seg] (rows of lut).  A block is one warp, so its shared
// arrays are the warp's own and sit at fixed addresses.
__global__ void __launch_bounds__(32)
    decode_words(const int32_t* __restrict__ streams,
                 const int32_t* __restrict__ counts, const int32_t* __restrict__ lut,
                 const int32_t* __restrict__ table, uint8_t* __restrict__ sym,
                 int s_seg, int w_words) {
  __shared__ unsigned lut_s[PROB_SCALE];
  // the last 4 words mirror the first 4, so a step's reads never wrap
  __shared__ __align__(16) unsigned ring[kRing + 4];
  const int lane = threadIdx.x, seg = blockIdx.x;
  uint8_t* o = sym + (size_t)seg * s_seg * NG;
  const int cnt = counts[seg];
  if (cnt == 0) {  // elided all-zero segment
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int i = lane; i < s_seg * (NG / 16); i += 32) o4[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  // The fused entries  sym | (f-1) << 8 | bias << 19  laid out again as
  // bias | f << 11 | sym << 24: a step takes bias with one mask, f with a
  // shift and a mask, and the symbol byte with a byte permute.
  const int* l = lut + (size_t)table[seg] * PROB_SCALE;
  for (int i = lane; i < PROB_SCALE; i += 32) {
    const unsigned e = (unsigned)__ldg(l + i);
    const unsigned f = ((e >> 8) & (PROB_SCALE - 1)) + 1u;
    lut_s[i] = ((e >> (8 + PROB_BITS)) & (PROB_SCALE - 1)) | f << PROB_BITS |
               (e & 255u) << 24;
  }
  const int32_t* st = streams + (size_t)seg * w_words;
  int cur = cnt > 2 * NG ? cnt - 2 * NG : 0;
  unsigned x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = (word_at(st, cur + 4 * lane + i, w_words) << 16) |
           word_at(st, cur + NG + 4 * lane + i, w_words);

  // The ring holds chunk c's words at ring[(c kChunk) % kRing ...].  Chunks
  // are fetched top down, one commit group each (an empty group below
  // chunk 0), down to kAhead chunks below the lowest one the next step may
  // read, so waiting until at most kAhead groups are pending leaves every
  // chunk a step reads landed.  The slots a fetch overwrites held a chunk
  // at least 2 above any a step still reads.
  int next = max(cur - 1, 0) / kChunk;  // the next chunk to fetch
  const unsigned ring_sa = (unsigned)__cvta_generic_to_shared(ring);
  auto fetch_to = [&](int low) {
    for (; next >= low; --next) {
      if (next >= 0) {
        const size_t g = (size_t)next * kChunk + 4 * lane;
        const bool in = g < (size_t)w_words;
        const int32_t* src = st + (in ? g : 0);
        const unsigned slot = g & (kRing - 1);
        cp_async16(ring_sa + 4 * slot, src, in ? 16 : 0);
        if (slot == 0) cp_async16(ring_sa + 4 * kRing, src, in ? 16 : 0);
      }
      cp_async_commit();
    }
  };
  fetch_to(chunk_needed(cur) - kAhead);
  __syncwarp();  // the LUT
  unsigned* ow = reinterpret_cast<unsigned*>(o) + lane;  // step j: ow[32 j]
  for (int j = 0; j < s_seg; ++j) {
    fetch_to(chunk_needed(cur) - kAhead);
    unsigned e[4];
    bool need[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = lut_s[x[i] & (PROB_SCALE - 1)];
      const unsigned f = (e[i] >> PROB_BITS) & (2 * PROB_SCALE - 1);
      x[i] = f * (x[i] >> PROB_BITS) + (e[i] & (PROB_SCALE - 1));
      need[i] = x[i] < WORD_L;
    }
    ow[(size_t)j * 32] = __byte_perm(__byte_perm(e[0], e[1], 0x73),
                                     __byte_perm(e[2], e[3], 0x73), 0x5410);
    int k;
    const int rank = rank_base(need, &k);
    // this thread's refill words: the next ones up from its first lane's
    // rank above the step's base, read at once whether needed or not
    int p = ((cur - k > 0 ? cur - k : 0) + rank) & (kRing - 1);
    cp_async_wait<kAhead>();
    __syncwarp();  // every lane's part of the chunks read below has landed
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned w = ring[p];
      x[i] = need[i] ? (x[i] << 16) | w : x[i];
      p += need[i];
    }
    cur -= k;
  }
  cp_async_wait<0>();
}

// grid-stride over (f, q) with q f < 2^32, f in 1..2048: counts the x in
// {q f - 1, q f}, and 64 xorshift samples of x a thread and f, where
// put_symbol differs from put_symbol_div; adds the count to *bad.
__global__ void rcp_mismatches(unsigned long long* __restrict__ bad,
                               unsigned seed) {
  unsigned long long miss = 0;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned f = 1; f <= PROB_SCALE; ++f) {
    const uint4 e = enc_entry(f, f & (PROB_SCALE - 1));
    for (unsigned long long q = tid; q * f <= FULL; q += stride) {
      const unsigned x0 = (unsigned)(q * f);
      miss += put_symbol(x0, e) != put_symbol_div(x0, e);
      const unsigned x1 = x0 - 1u;  // q = 0: x1 = 2^32 - 1
      miss += put_symbol(x1, e) != put_symbol_div(x1, e);
    }
    unsigned r = seed ^ (tid * 2654435761u) ^ (f * 40503u);
    for (int i = 0; i < 64; ++i) {  // xorshift sample of the whole range
      r ^= r << 13;
      r ^= r >> 17;
      r ^= r << 5;
      miss += put_symbol(r, e) != put_symbol_div(r, e);
    }
  }
  if (miss) atomicAdd(bad, miss);
}

}  // namespace

// symbols: (n, s_seg, 128) u8, 16-byte aligned; freqs / cums: (n_tables,
// 256) i32; table: (n,) i32 table of each segment; streams: (n, w_words)
// i32 (w_words a multiple of 128); counts: (n,) i32.
extern "C" int alc_encode_words(const void* symbols, const void* freqs,
                                const void* cums, const void* table,
                                void* streams, void* counts, int n, int s_seg,
                                int w_words, void* stream) {
  if (n <= 0) return 0;
  encode_words<<<n, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)symbols, (const int32_t*)freqs, (const int32_t*)cums,
      (const int32_t*)table, (int32_t*)streams, (int32_t*)counts, s_seg,
      w_words);
  return cudaGetLastError();
}

// streams: (n, w_words) i32 (w_words a multiple of 128, 16-byte aligned);
// counts: (n,) i32; lut: (n_tables, 2048) i32 fused slot LUTs; table: (n,)
// i32 table of each segment; symbols: (n, s_seg, 128) u8, 16-byte aligned.
extern "C" int alc_decode_words(const void* streams, const void* counts,
                                const void* lut, const void* table,
                                void* symbols, int n, int s_seg, int w_words,
                                void* stream) {
  if (n <= 0) return 0;
  decode_words<<<n, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)streams, (const int32_t*)counts, (const int32_t*)lut,
      (const int32_t*)table, (uint8_t*)symbols, s_seg, w_words);
  return cudaGetLastError();
}

// Counts where the encoder's reciprocal division differs from hardware
// division: every f in 1..2048 at x = q f - 1 and q f for every q with
// q f < 2^32, plus 64 xorshift samples a thread and f; total to *bad
// (device, u64).
extern "C" int alc_rcp_mismatches(void* bad, unsigned seed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = cudaMemsetAsync(bad, 0, sizeof(unsigned long long), s))) return e;
  rcp_mismatches<<<132 * 8, 256, 0, s>>>((unsigned long long*)bad, seed);
  return cudaGetLastError();
}
