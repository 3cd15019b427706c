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
// the per-lane rANS state and the segment's single word cursor; the bytes
// moved (one u8 symbol in or out per lane-step, at most one 16-bit word)
// would take a fraction of a millisecond at the card's memory rate.
//
// Design.  One block of 128 threads per segment: thread = lane.  The TPU
// kernel batches v_seg segments per grid slot to hide op latency and
// resolves ranks with a 128x128 one-hot matmul; here the hardware runs
// many independent segments per SM at once (1536 blocks over 132 SMs),
// and a lane's rank among the emitting (encode) or refilling (decode)
// lanes is a warp ballot + popcount plus a 4-warp prefix kept in shared
// memory (double-buffered, so one __syncthreads per step).  Tables live in
// shared memory: 256 (freq, cum) pairs for encode, the 2048-entry fused
// slot LUT  sym | (f-1) << 8 | (slot - cum) << 19  for decode (built by the
// wrapper, as the JAX package builds it in XLA).  Words are stored one per
// int32 in the wire layout of the JAX package: stream i is a
// stream_rows(s_seg) x 128 block, words in emission order, zero past the
// count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NG = 128;
constexpr int PROB_BITS = 11;
constexpr int PROB_SCALE = 1 << PROB_BITS;
constexpr unsigned WORD_L = 1u << 16;
constexpr int EMIT_SHIFT = 32 - PROB_BITS;

// Exclusive rank of this lane among the lanes whose flag is set, and the
// total count, over the 128 lanes of the block.  `tot` is a 2x4 shared
// array; `b` alternates between steps so one barrier per step suffices.
__device__ __forceinline__ int block_rank(bool flag, int (*tot)[4], int b,
                                          int* k) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) tot[b][warp] = __popc(bal);
  __syncthreads();
  int t0 = tot[b][0], t1 = tot[b][1], t2 = tot[b][2], t3 = tot[b][3];
  *k = t0 + t1 + t2 + t3;
  int before = (warp > 0 ? t0 : 0) + (warp > 1 ? t1 : 0) + (warp > 2 ? t2 : 0);
  return before + __popc(bal & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(NG)
encode_words(const uint8_t* __restrict__ sym, const int32_t* __restrict__ freqs,
             const int32_t* __restrict__ cums, int32_t* __restrict__ streams,
             int32_t* __restrict__ counts, int s_seg, int w_words,
             int seg_per_table) {
  __shared__ unsigned f_s[256], c_s[256];
  __shared__ int tot[2][4];
  const int seg = blockIdx.x, lane = threadIdx.x;
  const int tbl = seg / seg_per_table;
  const uint8_t* s = sym + (size_t)seg * s_seg * NG;
  int32_t* out = streams + (size_t)seg * w_words;
  for (int i = lane; i < 256; i += NG) {
    // the 11-bit fields of the TPU kernel's packed (f-1) << 11 | cum
    // entry: a frequency-0 symbol (which a valid plane never holds, wire
    // v7) reads as 2048, never as a division by zero
    f_s[i] = ((unsigned)(freqs[tbl * 256 + i] - 1) & (PROB_SCALE - 1)) + 1u;
    c_s[i] = (unsigned)cums[tbl * 256 + i] & (PROB_SCALE - 1);
  }
  unsigned any = 0;
  for (int j = 0; j < s_seg; ++j) any |= s[j * NG + lane];
  if (!__syncthreads_or(any)) {  // all-zero segment: elided, count 0
    for (int i = lane; i < w_words; i += NG) out[i] = 0;
    if (lane == 0) counts[seg] = 0;
    return;
  }
  unsigned x = WORD_L;
  int cur = 0;
  for (int j = s_seg - 1; j >= 0; --j) {  // LIFO: last decode step first
    unsigned sy = s[j * NG + lane];
    unsigned f = f_s[sy], c = c_s[sy];
    bool emit = (x >> EMIT_SHIFT) >= f;
    int k;
    int rank = block_rank(emit, tot, j & 1, &k);
    if (emit) {
      out[cur + rank] = (int32_t)(x & 0xFFFFu);
      x >>= 16;
    }
    cur += k;
    unsigned q = x / f;
    x = (q << PROB_BITS) + (x - q * f) + c;
  }
  out[cur + lane] = (int32_t)(x >> 16);          // state flush: hi row
  out[cur + NG + lane] = (int32_t)(x & 0xFFFFu); // then lo row
  cur += 2 * NG;
  for (int i = cur + lane; i < w_words; i += NG) out[i] = 0;
  if (lane == 0) counts[seg] = cur;
}

// A word of the segment's stream, or 0 outside [0, w_words) (only a
// corrupt count can point there).
__device__ __forceinline__ unsigned word_at(const int32_t* st, int i,
                                            int w_words) {
  return (i >= 0 && i < w_words) ? (unsigned)st[i] : 0u;
}

__global__ void __launch_bounds__(NG)
decode_words(const int32_t* __restrict__ streams,
             const int32_t* __restrict__ counts, const int32_t* __restrict__ lut,
             uint8_t* __restrict__ sym, int s_seg, int w_words,
             int seg_per_table) {
  __shared__ int lut_s[PROB_SCALE];
  __shared__ int tot[2][4];
  const int seg = blockIdx.x, lane = threadIdx.x;
  uint8_t* o = sym + (size_t)seg * s_seg * NG;
  const int cnt = counts[seg];
  if (cnt == 0) {  // elided all-zero segment
    for (int j = 0; j < s_seg; ++j) o[j * NG + lane] = 0;
    return;
  }
  const int32_t* l = lut + (size_t)(seg / seg_per_table) * PROB_SCALE;
  for (int i = lane; i < PROB_SCALE; i += NG) lut_s[i] = l[i];
  __syncthreads();
  const int32_t* st = streams + (size_t)seg * w_words;
  int cur = cnt - 2 * NG > 0 ? cnt - 2 * NG : 0;
  unsigned x = (word_at(st, cur + lane, w_words) << 16) |
               word_at(st, cur + NG + lane, w_words);
  for (int j = 0; j < s_seg; ++j) {
    int e = lut_s[x & (PROB_SCALE - 1)];
    o[j * NG + lane] = (uint8_t)(e & 255);
    unsigned f = (unsigned)((e >> 8) & (PROB_SCALE - 1)) + 1u;
    unsigned bias = (unsigned)((e >> (8 + PROB_BITS)) & (PROB_SCALE - 1));
    x = f * (x >> PROB_BITS) + bias;
    bool need = x < WORD_L;
    int k;
    int rank = block_rank(need, tot, j & 1, &k);
    if (need) {
      int base = cur - k > 0 ? cur - k : 0;
      x = (x << 16) | word_at(st, base + rank, w_words);
    }
    cur -= k;
  }
}

}  // namespace

// symbols: (n, s_seg, 128) u8; freqs / cums: (n / seg_per_table, 256) i32;
// streams: (n, w_words) i32; counts: (n,) i32.
extern "C" int alc_encode_words(const void* symbols, const void* freqs,
                                const void* cums, void* streams, void* counts,
                                int n, int s_seg, int w_words,
                                int seg_per_table, void* stream) {
  encode_words<<<n, NG, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)symbols, (const int32_t*)freqs, (const int32_t*)cums,
      (int32_t*)streams, (int32_t*)counts, s_seg, w_words, seg_per_table);
  return cudaGetLastError();
}

// streams: (n, w_words) i32; counts: (n,) i32; lut: (n / seg_per_table,
// 2048) i32; symbols: (n, s_seg, 128) u8.
extern "C" int alc_decode_words(const void* streams, const void* counts,
                                const void* lut, void* symbols, int n,
                                int s_seg, int w_words, int seg_per_table,
                                void* stream) {
  decode_words<<<n, NG, 0, (cudaStream_t)stream>>>(
      (const int32_t*)streams, (const int32_t*)counts, (const int32_t*)lut,
      (uint8_t*)symbols, s_seg, w_words, seg_per_table);
  return cudaGetLastError();
}
