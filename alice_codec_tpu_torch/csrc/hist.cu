// Plane statistics for Hopper (sm_90a): the 256-bin histograms the entropy
// tables are built from, and each plane's symbol maximum, in one pass.
//
// Replaces no TPU kernel.  The JAX package builds its histograms with jnp
// (alice_codec_tpu/ops/quant.py build_histogram: a one-hot product on the
// MXU) and takes the maximum with jnp.max; the port ran torch.bincount over
// an int64 copy of each plane's sampled rows and a separate amax.  This
// kernel was added because that bincount was the largest device operation
// of every benchmark cell: its global atomics pile onto one bin when, as
// here, most symbols are 0 (or, in a dense plane's bitmap, 255).
//
// What it counts (ops/kernels/hist.py `sampled`, a wire rule: the sampled
// histograms ride the ALC3 wire).  A plane of n uint8 symbols is read as
// 128-symbol rows.  With stride s > 1 and nb = n / (s * 128) > 0 whole
// blocks, only the first row of each block of s rows counts, and nothing
// after the last whole block; otherwise (s <= 1, or a plane shorter than
// one block) every symbol counts.  The maximum is over the whole plane.
//
// What bounds it on the H100: bytes.  Every call reads each byte of its
// planes once, for the maximum (the ALC2 batch: 12 planes, 1.593 GB, 0.48
// ms at 3.35 TB/s); a sampled histogram counts 1 row in s of them.  The
// arithmetic is one shared-memory add a counted byte.
//
// Design.  A block of 256 threads walks one plane with a grid stride of
// 16-byte loads (BATCH of them in flight a thread).  Each thread owns a
// private column of 256 byte-wide counters, packed four bins to a word:
// bin b of thread t is byte b & 3 of word (b >> 2) * 256 + t of the
// block's 64 KB of dynamic shared memory.  So every lane of a warp adds
// into its own bank whatever the data, and a plane that is all one value
// costs no more than a uniform one: no two threads ever share a counter
// (so no atomics: a byte load, an add and a byte store, whose word no
// other thread touches), and a 16-byte load of one repeated byte is one
// add of 16.  (Shared-memory atomics in place of the loads and stores
// took 1.28 ms over the ALC2 batch's 12 planes on an H100 80GB HBM3 at
// 700 W, 1.20 ms on uniform bytes; PERF.md.)  A byte counter overflows
// after 255, so every ROUND = 15 counted loads (240 bytes) the block
// flushes (a sampled plane: every 15 x 16 loads, see the loop): a thread
// sums one counter row over a quarter of the block's columns (64 words
// in 16-byte reads, bank-rotated, two bins a 32-bit lane), zeroes them,
// and keeps the four bins' sums in registers.  At the end each thread
// adds its four sums into the plane's int64 bins in device memory (4 x
// 256 atomics a block) and each warp its maximum.
//
// A plane may start at any address and have any length: the bytes before
// its first 16-byte boundary and after its last whole vector are counted
// one a thread by the plane's first block.  A vector that straddles two
// rows (a plane that is not 16-byte aligned) counts each byte by its own
// row.
//
// One launch covers up to MAX_PLANES planes of any lengths: a grid of
// (blocks a plane, planes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NG = 128;                  // symbols a row
constexpr int THREADS = 256;
constexpr int ROWS = 64;                 // counter words a thread: 4 bins a word
constexpr int ROUND = 15;                // counted loads a thread between flushes (15 x 16 <= 255)
constexpr int BATCH = 5;                 // loads in flight a thread
constexpr int MAX_PLANES = 64;
constexpr size_t SMEM = (size_t)ROWS * THREADS * sizeof(unsigned);

struct Planes {
  const uint8_t* ptr[MAX_PLANES];
  long long n[MAX_PLANES];
};

// The sampling rule of one plane: row r counts where r % per == 0 and
// r < lim (per = 1, lim = ~0: every row).
struct Rule {
  unsigned per;
  unsigned long long lim;
  __device__ bool counts(unsigned long long row) const {
    return row < lim && (per == 1 || (unsigned)row % per == 0);  // row < 2^32
  }
};

// Bit i set where byte off + i of a 16-byte vector counts.
__device__ unsigned vector_mask(const Rule& rule, long long off) {
  if (rule.per == 1) return 0xFFFFu;
  const unsigned long long ra = (unsigned long long)off >> 7;
  const unsigned long long rb = (unsigned long long)(off + 15) >> 7;
  const bool ca = rule.counts(ra);
  if (ra == rb) return ca ? 0xFFFFu : 0u;
  const unsigned lo = (1u << (NG - (unsigned)(off & (NG - 1)))) - 1u;  // bytes in row ra
  return (ca ? lo : 0u) | (rule.counts(rb) ? (0xFFFFu & ~lo) : 0u);
}

// Add `by` to thread t's counter of bin b: byte (b & 0xFC) << 8 | 4 t |
// (b & 3) of the counters.  key holds b at bits 0-7 and 8-15 (b * 257),
// t4 is 4 t (bits 2-9), so the byte's offset is one LOP3.
__device__ __forceinline__ void bump(uint8_t* cnt8, unsigned t4, unsigned key,
                                     unsigned by) {
  uint8_t* p = cnt8 + ((key & 0xFC03u) | t4);
  *p = (uint8_t)(*p + by);
}

// key of byte i of x
__device__ __forceinline__ unsigned key_of(const uint4& x, int i) {
  const unsigned w = i < 4 ? x.x : i < 8 ? x.y : i < 12 ? x.z : x.w;
  return __byte_perm(w, 0, 0x4400 | (i & 3) * 0x11);
}

// Count the bytes of x whose bit is set in mask into thread t's counters.
__device__ __forceinline__ void count16(uint8_t* cnt8, unsigned t4, const uint4& x,
                                        unsigned mask) {
  if (mask == 0xFFFFu) {
    if (x.x == x.y && x.x == x.z && x.x == x.w && x.x == __byte_perm(x.x, 0, 0)) {
      bump(cnt8, t4, key_of(x, 0), 16);  // one repeated byte
      return;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) bump(cnt8, t4, key_of(x, i), 1);
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (mask >> i & 1) bump(cnt8, t4, key_of(x, i), 1);
}

// Sum counter row t % 64 over columns [64 q, 64 q + 64), q = t / 64,
// zeroing them; acc[j] gains bin 4 (t % 64) + j.  16-byte accesses, the
// 8 lanes of a phase on 8 distinct 4-bank groups.
__device__ __forceinline__ void flush(unsigned* cnt, int t, unsigned long long acc[4]) {
  constexpr unsigned M = 0x00FF00FFu;
  const int r = t & (ROWS - 1), q = t >> 6;
  uint4* row = reinterpret_cast<uint4*>(cnt + r * THREADS + q * 64);
  unsigned even = 0, odd = 0;  // bins 4r, 4r+2 / 4r+1, 4r+3 in 16-bit lanes
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint4* p = row + ((k + t) & 15);
    const uint4 w = *p;
    *p = make_uint4(0, 0, 0, 0);
    even += (w.x & M) + (w.y & M) + (w.z & M) + (w.w & M);
    odd += ((w.x >> 8) & M) + ((w.y >> 8) & M) + ((w.z >> 8) & M) + ((w.w >> 8) & M);
  }
  acc[0] += even & 0xFFFFu;
  acc[1] += odd & 0xFFFFu;
  acc[2] += even >> 16;
  acc[3] += odd >> 16;
}

__global__ void __launch_bounds__(THREADS, 3)
plane_stats(Planes pl, int stride, unsigned long long* hist,
            unsigned long long* maxima) {
  extern __shared__ unsigned cnt[];
  const int c = blockIdx.y, t = threadIdx.x;
  const uint8_t* base = pl.ptr[c];
  const long long n = pl.n[c];
  uint8_t* cnt8 = reinterpret_cast<uint8_t*>(cnt);
  const unsigned t4 = 4u * t;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) cnt[r * THREADS + t] = 0;

  Rule rule{1u, ~0ull};
  if (stride > 1) {
    const long long nb = n / ((long long)stride * NG);
    if (nb > 0) rule = Rule{(unsigned)stride, (unsigned long long)(nb * stride)};
  }
  const long long head =
      min(n, (long long)((16 - ((unsigned long long)base & 15)) & 15));
  const long long nvec = (n - head) / 16;
  const long long tail = head + nvec * 16;  // first byte after the vectors
  const uint4* vec = reinterpret_cast<const uint4*>(base + head);
  unsigned mx = 0;  // four bytes' running maxima

  // the edge bytes, one a thread of the plane's first block (< 16 + 16)
  if (blockIdx.x == 0) {
    long long e = -1;
    if (t < head) e = t;
    else if (tail + (t - head) < n) e = tail + (t - head);
    if (e >= 0) {
      const unsigned b = base[e];
      mx = b;
      if (rule.counts((unsigned long long)e >> 7)) bump(cnt8, t4, b * 257, 1);
    }
  }

  // Load k of thread t is vector first + k * step + ((t + 8 k) % 256):
  // a grid stride whose 256 vectors a block rotate by one row (8 vectors)
  // a step, so that a thread's loads walk the rows one by one.  Where one
  // row in per counts (per dividing 32, so a step of rows is 1 mod per),
  // each per loads of a thread then count at most 16 bytes, and the block
  // flushes every ROUND * per loads instead of every ROUND.
  unsigned long long acc[4] = {0, 0, 0, 0};
  const int round =
      rule.per > 1 && 32 % rule.per == 0 ? ROUND * (int)min(rule.per, 16u) : ROUND;
  const long long step = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS;
  for (long long k0 = 0; first + k0 * step < nvec; k0 += round) {
    for (int k1 = 0; k1 < round; k1 += BATCH) {
      uint4 x[BATCH];
      unsigned m[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const long long k = k0 + k1 + j;
        const long long v = first + k * step + ((t + 8 * k) & (THREADS - 1));
        x[j] = make_uint4(0, 0, 0, 0);
        m[j] = 0;
        if (v < nvec) {
          m[j] = vector_mask(rule, head + v * 16);
          x[j] = __ldg(vec + v);
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        mx = __vmaxu4(mx, __vmaxu4(__vmaxu4(x[j].x, x[j].y), __vmaxu4(x[j].z, x[j].w)));
        if (m[j]) count16(cnt8, t4, x[j], m[j]);
      }
    }
    __syncthreads();
    flush(cnt, t, acc);
    __syncthreads();
  }
  // the edge bytes where no round ran (the last round's flush left zeros)
  __syncthreads();
  flush(cnt, t, acc);

  const int r = t & (ROWS - 1);
  unsigned long long* h = hist + (long long)c * 256 + 4 * r;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (acc[j]) atomicAdd(h + j, acc[j]);
  mx = max(max(mx & 0xFF, (mx >> 8) & 0xFF), max((mx >> 16) & 0xFF, mx >> 24));
  mx = __reduce_max_sync(0xFFFFFFFFu, mx);
  if ((t & 31) == 0 && mx) atomicMax(maxima + c, (unsigned long long)mx);
}

}  // namespace

// Histograms and maxima of np planes in one launch.  ptr / n: host arrays
// of np device addresses (any alignment) and lengths; stride: the sampling
// stride (<= 1: every symbol); hist: np x 256 int64 and maxima: np int64,
// both zeroed by the caller; blocks: blocks a plane.
extern "C" int alc_plane_stats(int np, const long long* ptr, const long long* n,
                               int stride, int blocks, void* hist, void* maxima,
                               void* stream) {
  if (np < 1 || np > MAX_PLANES || blocks < 1 || !hist || !maxima)
    return (int)cudaErrorInvalidValue;
  Planes pl{};
  for (int c = 0; c < np; ++c) {
    if (n[c] < 0 || (n[c] && !ptr[c]) || n[c] / NG >= (1ll << 32))
      return (int)cudaErrorInvalidValue;
    pl.ptr[c] = reinterpret_cast<const uint8_t*>(ptr[c]);
    pl.n[c] = n[c];
  }
  if (cudaError_t err = cudaFuncSetAttribute(
          plane_stats, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM))
    return (int)err;
  plane_stats<<<dim3((unsigned)blocks, (unsigned)np), THREADS, SMEM,
                (cudaStream_t)stream>>>(pl, stride,
                                        static_cast<unsigned long long*>(hist),
                                        static_cast<unsigned long long*>(maxima));
  return (int)cudaGetLastError();
}
