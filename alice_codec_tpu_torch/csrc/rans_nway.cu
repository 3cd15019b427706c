// N-lane byte-rANS encode and decode for Hopper (sm_90a): the ALC2 wire's
// device entropy coder.
//
// Replaces the TPU kernels
//   * alice_codec_tpu/ops/pallas/rans_kernel.py encode_nway_pallas
//     (_encode_kernel)
//   * alice_codec_tpu/ops/pallas/rans_decode_kernel.py decode_nway_pallas
//     (_decode_kernel)
// and computes what their scan forms in alice_codec_tpu/ops/rans_device.py
// compute: lane k of a stream owns symbols k, k+N, k+2N, ... and is an
// independent reference 32-bit rANS stream (PROB_BITS 12, RANS32_L 2^23,
// byte renormalisation, at most two renorm bytes per step).
//
// What bounds it on the H100: the serial state chain.  A lane walks all of
// its steps (32,400 on the main path) one after another, and one thread
// holds one lane, so a launch over every (chunk, channel) stream of an ALC2
// batch has 12 x 4096 threads: about 370 per SM, under a fifth of what an
// SM can hold.  Each step is a table lookup, a compare-and-shift or two and
// a 32-bit division on the critical path; the bytes moved (one symbol in,
// two byte slots and a count out) would take a fraction of that time at the
// card's memory rate.
//
// Design.  One thread per lane per stream, grid (lanes / 128, streams).
// The 256-entry freq / cum tables (and, for decode, the 4096-entry
// slot -> symbol LUT of the sanitized table, equal to the TPU kernel's
// two-level search over its strictly increasing cums) live in shared
// memory; the TPU's hi/lo-byte split of the table matmul has no counterpart,
// since it exists only because its bf16 matmul rounds.  Symbols are
// (steps, lanes) rows per stream, so a warp reads 32 neighbouring bytes per
// step; encode loads eight steps' symbols ahead of the chain.  The encoder
// writes the layout of its plain version: per step two byte slots (a u16,
// unemitted slots 0) and a u8 count, then the final states.  The decoder
// reads each lane straight from the flat payload at its start offset, with
// the `pos < len` guard, so a corrupt stream never reads past its lane;
// these reads do not coalesce (the lanes' cursors differ) and are served
// mostly from L1, since a lane's next bytes share its cache line.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned PROB_BITS = 12;
constexpr unsigned PROB_SCALE = 1u << PROB_BITS;
constexpr unsigned RANS32_L = 1u << 23;
constexpr unsigned X_MAX_UNIT = (RANS32_L >> PROB_BITS) << 8;  // 2^19
constexpr int kThreads = 128;
constexpr int kAhead = 8;

// One encode step of one lane: renormalise (0-2 bytes), then
// x' = (x / f) << 12 + x % f + cum.  The threshold 2^19 f fits 32 bits for
// every frequency of a 12-bit table.
__device__ __forceinline__ void encode_step(unsigned sy, unsigned& x,
                                            const unsigned* f_s,
                                            const unsigned* c_s,
                                            uint16_t* __restrict__ bp,
                                            uint8_t* __restrict__ cp) {
  unsigned f = f_s[sy], c = c_s[sy];
  unsigned x_max = X_MAX_UNIT * f;
  unsigned b = 0, n = 0;
  if (x >= x_max) {
    b = x & 0xFFu;
    x >>= 8;
    n = 1;
    if (x >= x_max) {
      b |= (x & 0xFFu) << 8;
      x >>= 8;
      n = 2;
    }
  }
  unsigned q = x / f;
  x = (q << PROB_BITS) + (x - q * f) + c;
  *bp = (uint16_t)b;
  *cp = (uint8_t)n;
}

__global__ void __launch_bounds__(kThreads)
encode_nway(const uint8_t* __restrict__ sym, const int32_t* __restrict__ freqs,
            const int32_t* __restrict__ cums, uint16_t* __restrict__ bytes2,
            uint8_t* __restrict__ counts, uint64_t* __restrict__ states,
            int steps, int lanes) {
  __shared__ unsigned f_s[256], c_s[256];
  const int s = blockIdx.y;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    f_s[i] = (unsigned)freqs[s * 256 + i];
    c_s[i] = (unsigned)cums[s * 256 + i];
  }
  __syncthreads();
  if (lane >= lanes) return;
  const size_t base = (size_t)s * steps * lanes + lane;
  const uint8_t* sp = sym + base;
  uint16_t* bp = bytes2 + base;
  uint8_t* cp = counts + base;
  unsigned x = RANS32_L;
  int j = steps - 1;  // LIFO: the last row first
  for (; j >= kAhead - 1; j -= kAhead) {
    unsigned sy[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) sy[k] = sp[(size_t)(j - k) * lanes];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      size_t o = (size_t)(j - k) * lanes;
      encode_step(sy[k], x, f_s, c_s, bp + o, cp + o);
    }
  }
  for (; j >= 0; --j) {
    size_t o = (size_t)j * lanes;
    encode_step(sp[o], x, f_s, c_s, bp + o, cp + o);
  }
  states[(size_t)s * lanes + lane] = x;
}

__global__ void __launch_bounds__(kThreads)
decode_nway(const uint8_t* __restrict__ payload,
            const int64_t* __restrict__ starts, const int32_t* __restrict__ lens,
            const int32_t* __restrict__ freqs, const int32_t* __restrict__ cums,
            const uint8_t* __restrict__ luts, uint8_t* __restrict__ out,
            int steps, int lanes) {
  __shared__ uint8_t lut_s[PROB_SCALE];
  __shared__ unsigned f_s[256], c_s[256];
  const int s = blockIdx.y;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < (int)PROB_SCALE; i += kThreads)
    lut_s[i] = luts[(size_t)s * PROB_SCALE + i];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    f_s[i] = (unsigned)freqs[s * 256 + i];
    c_s[i] = (unsigned)cums[s * 256 + i];
  }
  __syncthreads();
  if (lane >= lanes) return;
  const size_t li = (size_t)s * lanes + lane;
  const uint8_t* src = payload + starts[li];
  const int len = lens[li];
  // the state: the lane's first four bytes, big-endian (0 past its end)
  unsigned x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) x = (x << 8) | (b < len ? (unsigned)src[b] : 0u);
  int pos = 4;
  uint8_t* o = out + (size_t)s * steps * lanes + lane;
  for (int j = 0; j < steps; ++j) {
    unsigned slot = x & (PROB_SCALE - 1);
    unsigned sy = lut_s[slot];
    x = f_s[sy] * (x >> PROB_BITS) + slot - c_s[sy];
    // two refills always suffice: the updated state is >= 2^11
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (x < RANS32_L && pos < len) {
        x = (x << 8) | src[pos];
        ++pos;
      }
    }
    o[(size_t)j * lanes] = (uint8_t)sy;
  }
}

}  // namespace

// sym: (n_streams, steps, lanes) u8; freqs / cums: (n_streams, 256) i32;
// bytes2: (n_streams, steps, lanes) u16 (slot 0 in the low byte);
// counts: (n_streams, steps, lanes) u8; states: (n_streams, lanes) u64.
extern "C" int alc_encode_nway(const void* sym, const void* freqs,
                               const void* cums, void* bytes2, void* counts,
                               void* states, int n_streams, int steps,
                               int lanes, void* stream) {
  dim3 grid((lanes + kThreads - 1) / kThreads, n_streams);
  encode_nway<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sym, (const int32_t*)freqs, (const int32_t*)cums,
      (uint16_t*)bytes2, (uint8_t*)counts, (uint64_t*)states, steps, lanes);
  return cudaGetLastError();
}

// payload: flat u8; starts: (n_streams, lanes) i64 byte offsets into it;
// lens: (n_streams, lanes) i32; freqs / cums: (n_streams, 256) i32;
// luts: (n_streams, 4096) u8; out: (n_streams, steps, lanes) u8.
extern "C" int alc_decode_nway(const void* payload, const void* starts,
                               const void* lens, const void* freqs,
                               const void* cums, const void* luts, void* out,
                               int n_streams, int steps, int lanes,
                               void* stream) {
  dim3 grid((lanes + kThreads - 1) / kThreads, n_streams);
  decode_nway<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int64_t*)starts, (const int32_t*)lens,
      (const int32_t*)freqs, (const int32_t*)cums, (const uint8_t*)luts,
      (uint8_t*)out, steps, lanes);
  return cudaGetLastError();
}
