// N-lane byte-rANS encode and decode for Hopper (sm_90a): the ALC2 wire's
// device entropy coder.
//
// Replaces the TPU kernels
//   * alice_codec_tpu/ops/pallas/rans_kernel.py encode_nway_pallas
//     (_encode_kernel)
//   * alice_codec_tpu/ops/pallas/rans_decode_kernel.py decode_nway_pallas
//     (_decode_kernel)
// and computes what alice_codec_tpu/ops/rans_device.py computes with them:
// lane k of a stream owns symbols k, k+N, k+2N, ... and is an independent
// reference 32-bit rANS stream (PROB_BITS 12, RANS32_L 2^23, byte
// renormalisation, at most two renorm bytes per step).  Three routes:
//
//   * encode_slabs + compact_lanes (alc_encode_slabs, alc_compact_lanes):
//     what encode_pack_device computes, and the concatenation of the
//     streams' payloads: symbols in, the packed wire payload out;
//   * encode_nway (alc_encode_nway): the TPU kernel's own per-step layout
//     (two byte slots and a count a step, then the final states);
//   * decode_nway (alc_decode_nway): every lane straight out of the flat
//     payload.
//
// What bounds them on the H100: the serial state chain, and with it the
// instructions a step issues.  A lane walks all of its steps (32,400 on the
// main path) one after another and one thread holds one lane, so the ALC2
// batch's 12 x 4096 lanes are about three warps a scheduler: too few to
// hide a long latency on the chain, and once the chain is short, three
// warps' instructions a step are the time.  The bytes (1.6 GB of symbols,
// 0.25 GB of payload) would take a fraction of it at the card's memory rate.
//
// Design.  One thread per lane per stream, grid (lanes / 128, streams); the
// stream's table in shared memory; no global load on the chain.
//   * encode_slabs loads its symbols 16 steps ahead (double-buffered) and
//     with each symbol its 16-byte entry: a reciprocal, the emit threshold,
//     4096 - f and cum, so the division is a multiply-high and one
//     correction (put_symbol, as in rans3.cu).  Renormalisation is
//     branch-free (0-2 bytes).  The bytes gather in a 64-bit register and
//     leave as aligned 4-byte stores, written backward into the lane's own
//     slab of a scratch buffer (2 steps + 4 bytes, rounded up to 16); the
//     4 state bytes close the lane at its front, so the lane's wire bytes
//     end its slab.  compact_lanes (one warp a lane) then moves every lane
//     to its place in the payload, at offsets the wrapper scans from the
//     lane lengths.  No per-step byte slots or counts are written.
//   * decode_nway reads one 32-bit word per slot of the stream's 12-bit
//     table (symbol, f - 1, slot - cum; built by the wrapper), so a step is
//     one dependent shared load, a multiply-add and a refill from
//     registers: a count (0-2 bytes, capped by the bytes left in the lane)
//     and a funnel shift of the lane's next three words.  The words come
//     from a ring of 16-byte chunks of the lane's stream in shared memory,
//     which cp.async keeps three refills ahead of use; the warp refills
//     every 8 steps as a whole, and the window moves on by selects, not a
//     branch.  Measured slower on the card (PERF.md): the lane's chunks
//     loaded into registers (the compiler's copies of them waited for the
//     loads), cp.async groups waited for lane by lane (the hardware counts
//     a warp's groups), a byte swap at the shared load and a branch to move
//     the window (both sat on the chain).  Nothing outside the payload
//     tensor is read (cp.async zero-fills past its end).
//   * encode_nway keeps the per-step layout's design: the freq / cum tables
//     in shared memory, symbols eight steps ahead, hardware division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned PROB_BITS = 12;
constexpr unsigned PROB_SCALE = 1u << PROB_BITS;
constexpr unsigned RANS32_L = 1u << 23;
constexpr unsigned X_MAX_SHIFT = 23 - PROB_BITS + 8;  // x_max = f << 19
constexpr unsigned X_MAX_UNIT = 1u << X_MAX_SHIFT;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kAhead = 8;      // encode_nway: steps of symbols loaded ahead
constexpr int kSymAhead = 16;  // encode_slabs: the same, double-buffered
constexpr int kLanesPerBlock = 8;  // compact_lanes: a warp a lane

// ── the per-step layout (encode_nway) ──────────────────────────────

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

// ── the packed route (encode_slabs + compact_lanes) ────────────────

// A symbol's encode entry: the reciprocal m = floor((2^32 - 1) / f), the
// emit threshold f 2^19, g = 4096 - f and the cumulative frequency c.
__device__ __forceinline__ uint4 enc_entry(unsigned f, unsigned c) {
  return make_uint4(FULL / f, f << X_MAX_SHIFT, PROB_SCALE - f, c);
}

// The encoder's state update x' = (x / f) << 12 | x % f, plus c, for
// x < 2^32 and e = enc_entry(f, c).  With q0 = floor(x m / 2^32): since
// 2^32/f - 1 <= m < 2^32/f, q0 is floor(x/f) or one less, and
// r0 = x - q0 f lies in [0, 2f).  Then q = q0 + p with p = (r0 >= f) =
// (r0 + g) >> 12 (r0 + g < f + 4096), and x' = 4096 q + r + c =
// x + q g + c = t + c + p g with t = x + q0 g, r0 = t - 4096 q0 (rans3.cu
// put_symbol at 12 bits, the correction without a compare).
__device__ __forceinline__ unsigned put_symbol(unsigned x, const uint4& e) {
  const unsigned q0 = __umulhi(x, e.x);
  const unsigned t = x + q0 * e.z;
  const unsigned p = (t - (q0 << PROB_BITS) + e.z) >> PROB_BITS;
  return t + e.w + p * e.z;
}

// One step of one lane: renormalise (s = 0, 8 or 16 bits, the low byte
// emitted first), gather the bytes into acc (its low cnt bits pending, the
// oldest highest), encode, and store the oldest four pending bytes at word
// wi (counted back from the slab's end) once there are four.  x >= y (the
// threshold e.y) is the sign bit of y - 1 - x, as x < 2^31 and y <= 2^31:
// no compare sits on the chain.
__device__ __forceinline__ void put_step(unsigned& x, const uint4& e,
                                         unsigned long long& acc,
                                         unsigned& cnt, unsigned* end, int& wi) {
  const unsigned s =
      (((e.y - 1u - x) >> 31) + ((e.y - 1u - (x >> 8)) >> 31)) << 3;
  // the low two bytes, the first emitted one high: b0 << 8 | b1
  const unsigned v = __byte_perm(x, 0, 0x4401);
  acc = (acc << s) | (v >> (16 - s));
  cnt += s;
  x = put_symbol(x >> s, e);
  if (cnt >= 32) {
    cnt -= 32;
    end[--wi] = (unsigned)(acc >> cnt);
  }
}

// grid (lanes / 128, streams): lane k of stream s codes its steps LIFO and
// writes its wire bytes (4 state bytes big-endian, then its renorm bytes in
// reverse emission order) to the end of slab s * lanes + k of `slabs`
// (each `slab` bytes, a multiple of 16), and its length to lane_lens.
__global__ void __launch_bounds__(kThreads)
encode_slabs(const uint8_t* __restrict__ sym, const int32_t* __restrict__ freqs,
             const int32_t* __restrict__ cums, uint8_t* __restrict__ slabs,
             int32_t* __restrict__ lane_lens, int steps, int lanes,
             long long slab) {
  __shared__ uint4 tab[256];
  const int s = blockIdx.y;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  // a frequency of 0 (which a sanitized table never holds) reads as 4096,
  // never as a division by zero
  for (int i = threadIdx.x; i < 256; i += kThreads)
    tab[i] = enc_entry(((unsigned)(freqs[s * 256 + i] - 1) & (PROB_SCALE - 1)) + 1u,
                       (unsigned)cums[s * 256 + i]);
  __syncthreads();
  if (lane >= lanes) return;
  const size_t li = (size_t)s * lanes + lane;
  const size_t row = (size_t)lanes;
  const uint8_t* sp = sym + (size_t)s * steps * row + lane;
  uint8_t* const end = slabs + (li + 1) * (size_t)slab;
  unsigned* const endw = reinterpret_cast<unsigned*>(end);
  int wi = 0;  // words stored, as a negative index from the slab's end
  unsigned x = RANS32_L, cnt = 0;
  unsigned long long acc = 0;

  // rows steps-1 ... 0, in groups of kSymAhead whose symbols are loaded
  // while the group before them is coded
  const int groups = steps / kSymAhead;
  unsigned a[kSymAhead], b[kSymAhead];
  auto load = [&](unsigned (&buf)[kSymAhead], int g) {
    const uint8_t* p = sp + (size_t)(steps - 1 - g * kSymAhead) * row;
#pragma unroll
    for (int k = 0; k < kSymAhead; ++k) buf[k] = *(p - (size_t)k * row);
  };
  auto code = [&](const unsigned (&buf)[kSymAhead]) {
#pragma unroll
    for (int k = 0; k < kSymAhead; ++k) put_step(x, tab[buf[k]], acc, cnt, endw, wi);
  };
  if (groups > 0) load(a, 0);
  for (int g = 0; g < groups; g += 2) {
    if (g + 1 < groups) load(b, g + 1);
    code(a);
    if (g + 1 < groups) {
      if (g + 2 < groups) load(a, g + 2);
      code(b);
    }
  }
  for (int j = steps - groups * kSymAhead - 1; j >= 0; --j)
    put_step(x, tab[sp[(size_t)j * row]], acc, cnt, endw, wi);

  // the flush: the state's 4 bytes, emitted low byte first, then the
  // 0-3 bytes still pending, bytewise
  acc = (acc << 32) | __byte_perm(x, 0, 0x0123);
  endw[--wi] = (unsigned)(acc >> cnt);
  uint8_t* bp = reinterpret_cast<uint8_t*>(endw + wi);
  for (; cnt; cnt -= 8) *--bp = (uint8_t)(acc >> (cnt - 8));
  lane_lens[li] = (int32_t)(end - bp);
}

// grid n / 8, block 256: warp w moves lane w (streams one after another)
// from the end of its slab to out + offs[w]: aligned 4-byte stores of
// funnel-shifted aligned loads, the ragged ends bytewise.  The last slab
// needs 4 readable bytes past its end.
__global__ void __launch_bounds__(kLanesPerBlock * 32)
compact_lanes(const uint8_t* __restrict__ slabs, const int32_t* __restrict__ lens,
              const int64_t* __restrict__ offs, uint8_t* __restrict__ out,
              long long n, long long slab) {
  const long long w = (long long)blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (w >= n) return;
  const int len = lens[w];
  const uint8_t* src = slabs + (w + 1) * slab - len;
  uint8_t* dst = out + offs[w];
  const int head = min(len, (int)((4 - ((uintptr_t)dst & 3)) & 3));
  if (t < head) dst[t] = src[t];
  const uint8_t* s0 = src + head;
  const int words = (len - head) >> 2;
  const unsigned* sa =
      reinterpret_cast<const unsigned*>((uintptr_t)s0 & ~(uintptr_t)3);
  const unsigned sh = ((unsigned)(uintptr_t)s0 & 3u) * 8u;
  unsigned* d = reinterpret_cast<unsigned*>(dst + head);
  for (int i = t; i < words; i += 32) d[i] = __funnelshift_r(sa[i], sa[i + 1], sh);
  const int tail = (len - head) & 3;
  if (t < tail) dst[head + 4 * words + t] = s0[4 * words + t];
}

// ── decode ─────────────────────────────────────────────────────────

constexpr int kRing = 8;    // 16-byte chunks of a lane's stream in shared memory
constexpr int kRefill = 8;  // steps between refills: a lane reads <= 16 bytes
constexpr int kLag = 3;     // refills a chunk's copy may stay in flight

// Start copying the 16-byte chunk c of the payload (zeros past its end,
// nothing read there) to shared memory at dst.
__device__ __forceinline__ void chunk_async(unsigned dst, const uint8_t* base,
                                            long long nbytes, long long c) {
  const long long a = c * 16, left = nbytes - a;
  const int sz = (a < 0 || left <= 0) ? 0 : (left >= 16 ? 16 : (int)left);
  const uint8_t* src = sz ? base + a : base;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(sz)
               : "memory");
}

__device__ __forceinline__ void commit_chunks() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_chunks() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// grid (lanes / 128, streams).  table: (streams, 4096) words, slot ->
// sym | (slot - cum) << 8 | (f - 1) << 20.
//
// Each lane's stream reaches it through a ring of kRing 16-byte chunks in
// shared memory, filled by cp.async.  The copies are committed and waited
// for by the whole warp at once, every kRefill steps (a lane that has no
// free slot commits an empty group), since the hardware counts a warp's
// groups, not a lane's: a refill starts one chunk per lane and waits for
// the groups of all but the kLag latest refills.  A lane reads at most 16
// bytes between refills and starts its next chunk as soon as the slot's
// chunk is taken, so the chunks it reads have had kLag refills to arrive.
// The next three words sit in registers (hi, lo, nx): the word after the
// window is read from the ring every step and kept when the window moves
// on, at least two steps before it is used.
__global__ void __launch_bounds__(kThreads)
decode_nway(const uint8_t* __restrict__ payload, long long nbytes,
            const int64_t* __restrict__ starts, const int32_t* __restrict__ lens,
            const uint32_t* __restrict__ table, uint8_t* __restrict__ out,
            int steps, int lanes) {
  __shared__ unsigned tab[PROB_SCALE];
  __shared__ __align__(16) unsigned ring[kRing * kThreads * 4];
  const int s = blockIdx.y;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < (int)PROB_SCALE; i += kThreads)
    tab[i] = table[(size_t)s * PROB_SCALE + i];
  __syncthreads();
  if (lane >= lanes) return;
  const size_t li = (size_t)s * lanes + lane;
  const long long start = starts[li];
  const int len = lens[li];
  const long long c0 = start >> 4;
  // chunk r (relative to c0) sits in slot r % kRing: word w of it at
  // mine[(r % kRing) * kThreads * 4 + w]
  unsigned* const mine = ring + threadIdx.x * 4;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(mine);
  unsigned ic = kRing - 1;  // chunks started
#pragma unroll
  for (unsigned r = 0; r < kRing - 1; ++r)
    chunk_async(sbase + r * kThreads * 16, payload, nbytes, c0 + r);
  commit_chunks();
  wait_chunks<0>();
  unsigned rw = (unsigned)(start >> 2) & 3u;  // the next word to take
  // word rw as stored (little-endian)
  auto word = [&]() { return mine[(((rw >> 2) & (kRing - 1)) * kThreads * 4) | (rw & 3u)]; };
  auto take = [&]() {
    const unsigned w = word();
    ++rw;
    return w;
  };
  auto bswap = [](unsigned w) { return __byte_perm(w, 0, 0x0123); };
  auto refill = [&]() {
    if (ic < (rw >> 2) + kRing) {  // chunk ic - kRing is taken
      chunk_async(sbase + (ic & (kRing - 1)) * kThreads * 16, payload, nbytes,
                  c0 + ic);
      ++ic;
    }
    commit_chunks();
    wait_chunks<kLag>();
  };
  // the window: bytes p8 / 8 .. p8 / 8 + 7 of hi:lo (big-endian) are the
  // lane's next; nx, the word after them, is swapped only when it enters
  // the window, so that nothing waits for its load before then
  unsigned hi = bswap(take()), lo = bswap(take()), nx = take();
  unsigned p8 = (unsigned)(start & 3) * 8u;
  // the state: the lane's first four bytes, big-endian (0 past its end)
  unsigned x = __funnelshift_l(lo, hi, p8);
  if (len < 4) x = len <= 0 ? 0u : x & ~(FULL >> (8 * len));
  hi = lo;
  lo = bswap(nx);
  nx = take();
  int rem = len > 4 ? len - 4 : 0;  // bytes left to refill from
  uint8_t* o = out + (size_t)s * steps * lanes + lane;
  const size_t row = (size_t)lanes;
  auto step = [&]() {
    const unsigned e = tab[x & (PROB_SCALE - 1)];
    const unsigned h = x >> PROB_BITS;
    x = (e >> 20) * h + h + ((e >> 8) & (PROB_SCALE - 1));
    // two refills always suffice (the updated state is >= 2^11), each
    // only while the lane has bytes left
    const int n = min((int)(x < RANS32_L) + (int)(x < (1u << 15)), rem);
    rem -= n;
    const unsigned sft = 8u * (unsigned)n;
    x = __funnelshift_lc(__funnelshift_l(lo, hi, p8), x, sft);
    p8 += sft;
    *o = (uint8_t)e;
    o += row;
    // past a word: move the window on by one, branch-free (the next word
    // is read every step and kept only then), so that the compiler can
    // overlap it with the next step's table lookup
    const bool adv = p8 >= 32;
    const unsigned w = word();
    p8 -= adv ? 32u : 0u;
    hi = adv ? lo : hi;
    lo = adv ? bswap(nx) : lo;
    nx = adv ? w : nx;
    rw += adv;
  };
  int j = 0;
  for (; j + kRefill <= steps; j += kRefill) {
    refill();
#pragma unroll
    for (int k = 0; k < kRefill; ++k) step();
  }
  refill();
  for (; j < steps; ++j) step();
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

// sym: (n_streams, steps, lanes) u8; freqs / cums: (n_streams, 256) i32;
// slabs: n_streams * lanes slabs of `slab` bytes (a multiple of 16, at
// least 2 steps + 4) and 16 more, 16-byte aligned; lane_lens:
// (n_streams, lanes) i32.
extern "C" int alc_encode_slabs(const void* sym, const void* freqs,
                                const void* cums, void* slabs, void* lane_lens,
                                int n_streams, int steps, int lanes,
                                long long slab, void* stream) {
  dim3 grid((lanes + kThreads - 1) / kThreads, n_streams);
  encode_slabs<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sym, (const int32_t*)freqs, (const int32_t*)cums,
      (uint8_t*)slabs, (int32_t*)lane_lens, steps, lanes, slab);
  return cudaGetLastError();
}

// slabs, lens as written by alc_encode_slabs (n lanes in all); offs: (n,)
// i64 byte offsets of the lanes in out.
extern "C" int alc_compact_lanes(const void* slabs, const void* lens,
                                 const void* offs, void* out, long long n,
                                 long long slab, void* stream) {
  const long long blocks = (n + kLanesPerBlock - 1) / kLanesPerBlock;
  compact_lanes<<<(unsigned)blocks, kLanesPerBlock * 32, 0,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)slabs, (const int32_t*)lens, (const int64_t*)offs,
      (uint8_t*)out, n, slab);
  return cudaGetLastError();
}

// payload: nbytes u8, 16-byte aligned; starts: (n_streams, lanes) i64 byte
// offsets into it; lens: (n_streams, lanes) i32; table: (n_streams, 4096)
// u32 slot words; out: (n_streams, steps, lanes) u8.
extern "C" int alc_decode_nway(const void* payload, long long nbytes,
                               const void* starts, const void* lens,
                               const void* table, void* out, int n_streams,
                               int steps, int lanes, void* stream) {
  dim3 grid((lanes + kThreads - 1) / kThreads, n_streams);
  decode_nway<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, nbytes, (const int64_t*)starts,
      (const int32_t*)lens, (const uint32_t*)table, (uint8_t*)out, steps,
      lanes);
  return cudaGetLastError();
}
