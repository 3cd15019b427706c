// Sparse significance coding for Hopper (sm_90a): compact and expand.
//
// Replaces the TPU kernels of alice_codec_tpu/ops/pallas/sparse_kernels.py:
//   * compact_pallas (_compact_kernel, _compact_slot)
//   * expand_pallas (_expand_kernel, _expand_slot)
// together with the XLA prepass the JAX package runs around them
// (value_row_bases, tile_row_bases_from_symbols / _from_bitmaps), and
// computes the NumPy spec alice_codec_tpu/ops/sparse_spec.py
// (pack_bitmap, compact_values, expand_values).
//
// Layout (wire v5).  A plane of P symbols is P / 1024 tiles of 8 pixel
// rows x 128 lanes.  Bitmap byte (tile, l) has bit j set where
// sym[tile*1024 + j*128 + l] != 0.  A tile's nonzero symbols, in pixel
// order, start at value row base[tile] of its plane (128 symbols a row)
// and are zero-padded to whole rows; base is the exclusive prefix of the
// tiles' row counts ceil(nonzeros / 128).  A plane holds kr value rows.
//
// What bounds it on the H100: bytes.  Compact reads each symbol once and
// writes the bitmap (1/8 of the symbols) and the used value rows; expand
// the reverse.  The arithmetic is a few hundred integer operations per
// 128 symbols.
//
// Design.  The tile bases come from a reduce-then-scan over groups of
// GROUP = 32 tiles, run before the main kernel with no torch op between:
// group_rows (a warp a group) sums each group's tile rows, taken from the
// per-tile counts the codec's phase 1 made (compact) or counted from the
// bitmap (expand, 1/8 of the bytes), and scan_groups (one block) turns
// them into each group's first row and each plane's used rows.  The main
// kernel then never waits on another block.  A single pass with a chained
// scan (decoupled look-back over per-group status words) was measured
// first on the H100: a block can write only once its predecessors have
// published their counts, and its kernels were no faster than the
// one-tile-a-block kernels before them (compact 0.186 ms against 0.104
// here; PERF.md, PR 9).
//
// Main kernels: a block of 256 threads takes one group, a thread a
// 16-lane strip of one tile over its 8 rows (8 x 16-byte loads, or one
// 16-byte bitmap load; the 8 strips of a tile are 8 lanes of one warp,
// neighbours on neighbouring addresses).  A strip's bitmap bytes are the
// nonzero flags of its rows ORed in place (SWAR); its rows' 16-bit masks
// are an 8x8 bit transpose of them; ranks are a segmented scan of the
// masks' popcounts over the tile's 8 lanes, and the tiles' bases inside
// the group a warp scan of their row counts.
//
// Compact stages each tile's values in shared memory (the zero padding of
// its last row included) and writes them as whole rows of aligned 16-byte
// stores; rows at or past the plane's capacity are dropped.  Tail blocks
// zero a bitmap segment's bytes past the bitmap and the value rows from
// the plane's used rows to its capacity, so the caller hands in
// uninitialised buffers.  Expand stages each tile's value rows below the
// capacity in shared memory (rows at or past it read as zero, so a
// hostile bitmap whose popcount exceeds the capacity decodes as the JAX
// package decodes it, whose block bases are clamped to the capacity with
// a zero margin behind, sparse_kernels.py:173, and never reads out of its
// buffer) and writes the first n_out symbols of each plane as 16-byte
// stores.  Each plane has its own source and destination pointers, so the
// codec hands in its wire buffers and reads and writes them in place.
//
// The JAX kernels batch 512-row blocks, V of them a grid step, and leave
// a BLOCK_ROWS margin after each plane; none of that exists here.  Those
// constants stay wire-visible only through alc3._sparse_pp, which pads a
// plane to whole DEFAULT_V_BLK blocks of BLOCK_ROWS rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NG = 128;
constexpr int TILE_ROWS = 8;
constexpr int TILE = TILE_ROWS * NG;
constexpr int MAX_PLANES = 64;  // planes a launch (21 chunks of a batch)
constexpr int GROUP = 32;                // tiles a group (a warp's scan)
constexpr int THREADS = GROUP * 8;       // a thread per (tile, 16-lane strip)
constexpr long long TAIL_BYTES = 32768;  // bytes one tail block zeroes
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;            // groups a scan thread takes a round

struct CompactPlanes {
  const uint8_t* src[MAX_PLANES];  // tiles * 1024 symbols
  uint8_t* bitmap[MAX_PLANES];     // bm_len bytes: the bitmap, then zeros
  uint8_t* vals[MAX_PLANES];       // kr * 128 bytes
  long long bm_len[MAX_PLANES];
  long long kr[MAX_PLANES];
};

struct ExpandPlanes {
  const uint8_t* bitmap[MAX_PLANES];  // tiles * 128 bytes
  const uint8_t* vals[MAX_PLANES];    // kr * 128 bytes
  uint8_t* out[MAX_PLANES];           // n_out symbols
  long long kr[MAX_PLANES];
};

struct GroupSrc {
  const int32_t* trows[MAX_PLANES];   // per-tile value rows, or else
  const uint8_t* bitmap[MAX_PLANES];  // the bitmap to count them from
};

// A warp a group: the group's value rows, agg[c * ng + grp], summed from
// the plane's tile rows or counted from its bitmap.
__global__ void __launch_bounds__(256)
group_rows(GroupSrc src, int nc, long long tiles, int ng, unsigned* agg) {
  const long long gw = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (gw >= (long long)nc * ng) return;
  const int lane = threadIdx.x & 31;
  const int c = (int)(gw / ng), grp = (int)(gw % ng);
  const long long t0 = (long long)grp * GROUP;
  unsigned rows = 0;
  if (src.trows[c]) {
    if (t0 + lane < tiles) rows = (unsigned)src.trows[c][t0 + lane];
  } else {
    // 16-byte word q = lane + 32 k of the group's bitmap belongs to tile
    // q / 8: 8 neighbouring lanes hold one tile's 128 bytes
    const uint4* b = reinterpret_cast<const uint4*>(src.bitmap[c] + t0 * NG);
    const long long nq = min((long long)GROUP, tiles - t0) * (NG / 16);
#pragma unroll
    for (int k = 0; k < GROUP / 4; ++k) {
      const long long q = lane + 32 * k;
      unsigned n = 0;
      if (q < nq) {
        const uint4 v = b[q];
        n = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
      n += __shfl_xor_sync(~0u, n, 1);
      n += __shfl_xor_sync(~0u, n, 2);
      n += __shfl_xor_sync(~0u, n, 4);
      if ((lane & 7) == 0) rows += (n + NG - 1) / NG;
    }
  }
  rows = __reduce_add_sync(~0u, rows);
  if (lane == 0) agg[gw] = rows;
}

// One block: each plane's group rows agg[c * ng ..] → their exclusive
// prefix gbase[c * ng ..], then each plane's used rows gbase[nc * ng + c].
__global__ void __launch_bounds__(SCAN_THREADS)
scan_groups(const unsigned* agg, int nc, int ng, unsigned* gbase) {
  __shared__ unsigned warp_s[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < nc; ++c) {
    const unsigned* a = agg + (long long)c * ng;
    unsigned* out = gbase + (long long)c * ng;
    unsigned carry = 0;
    for (int g0 = 0; g0 < ng; g0 += SCAN_THREADS * SCAN_ITEMS) {
      const int gt = g0 + threadIdx.x * SCAN_ITEMS;
      unsigned v[SCAN_ITEMS], sum = 0;
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        v[k] = gt + k < ng ? a[gt + k] : 0u;
        sum += v[k];
      }
      unsigned inc = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned u = __shfl_up_sync(~0u, inc, d);
        if (lane >= d) inc += u;
      }
      if (lane == 31) warp_s[warp] = inc;
      __syncthreads();
      if (warp == 0) {
        const unsigned w = warp_s[lane];
        unsigned wi = w;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned u = __shfl_up_sync(~0u, wi, d);
          if (lane >= d) wi += u;
        }
        warp_s[lane] = wi - w;
      }
      __syncthreads();
      unsigned run = carry + warp_s[warp] + inc - sum;
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (gt + k < ng) out[gt + k] = run;
        run += v[k];
      }
      __syncthreads();
      if (threadIdx.x == SCAN_THREADS - 1) warp_s[0] = run;
      __syncthreads();
      carry = warp_s[0];
      __syncthreads();
    }
    if (threadIdx.x == 0) gbase[(long long)nc * ng + c] = carry;
  }
}

// Warp 0 of a main block: the group's tile rows (rows_s) → each tile's
// first value row in its plane (base_s), from the group's (gbase).
__device__ __forceinline__ void tile_bases(const unsigned* rows_s,
                                           long long* base_s, unsigned gbase) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned v = rows_s[lane];
    unsigned inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(~0u, inc, d);
      if (lane >= d) inc += u;
    }
    base_s[lane] = (long long)gbase + (inc - v);
  }
  __syncthreads();
}

// Bit 7 of each byte of the result: that byte of x is nonzero.
__device__ __forceinline__ unsigned nonzero_bits(unsigned x) {
  return (x | ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu)) & 0x80808080u;
}

// 8x8 bit transpose: bit j of byte i ↔ bit i of byte j.
__device__ __forceinline__ unsigned long long transpose8(unsigned long long x) {
  x = (x & 0xAA55AA55AA55AA55ull) | ((x & 0x00AA00AA00AA00AAull) << 7) |
      ((x >> 7) & 0x00AA00AA00AA00AAull);
  x = (x & 0xCCCC3333CCCC3333ull) | ((x & 0x0000CCCC0000CCCCull) << 14) |
      ((x >> 14) & 0x0000CCCC0000CCCCull);
  x = (x & 0xF0F0F0F00F0F0F0Full) | ((x & 0x00000000F0F0F0F0ull) << 28) |
      ((x >> 28) & 0x00000000F0F0F0F0ull);
  return x;
}

// A strip's 16 bitmap bytes (bm[w] byte b: lane 4w + b) → its rows'
// 16-bit masks (m[j] bit i: lane i of the strip is set in row j), and the
// pixel-order rank of each row's first set bit in the tile (pos[j]) and
// the tile's set bits (nnz), by a scan over the tile's 8 strips (8
// neighbouring lanes, strip g = lane & 7).
__device__ __forceinline__ void strip_ranks(const unsigned (&bm)[4], int g,
                                            unsigned (&m)[TILE_ROWS],
                                            unsigned (&pos)[TILE_ROWS],
                                            unsigned& nnz) {
  const unsigned long long lo = transpose8(bm[0] | (unsigned long long)bm[1] << 32);
  const unsigned long long hi = transpose8(bm[2] | (unsigned long long)bm[3] << 32);
  unsigned cnt[2] = {0, 0};  // 8-bit fields: rows 0-3, rows 4-7
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j) {
    m[j] = ((unsigned)(lo >> (8 * j)) & 0xFF) | (((unsigned)(hi >> (8 * j)) & 0xFF) << 8);
    cnt[j >> 2] |= __popc(m[j]) << (8 * (j & 3));
  }
  unsigned inc[2] = {cnt[0], cnt[1]};  // fields stay below 129
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned u = __shfl_up_sync(~0u, inc[h], d, 8);
      if (g >= d) inc[h] += u;
    }
  }
  unsigned row_pre = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned tot = __shfl_sync(~0u, inc[h], 7, 8);
    const unsigned exc = inc[h] - cnt[h];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pos[4 * h + k] = row_pre + ((exc >> (8 * k)) & 0xFF);
      row_pre += (tot >> (8 * k)) & 0xFF;
    }
  }
  nnz = row_pre;
}

__device__ __forceinline__ unsigned byte_of(const uint4& v, int i) {
  const unsigned w = (i & 8) ? ((i & 4) ? v.w : v.z) : ((i & 4) ? v.y : v.x);
  return (w >> (8 * (i & 3))) & 0xFF;
}

// Tail block zi of plane c: zero a TAIL_BYTES slice of its bitmap
// segment past its bitmap and of its value rows from its used rows to
// its capacity.
__device__ void zero_tail(const CompactPlanes& pl, int c, long long zi,
                          long long tiles, unsigned used) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  {
    const long long lo = tiles * NG + zi * TAIL_BYTES;
    const long long hi = min(pl.bm_len[c], lo + TAIL_BYTES);
    for (long long o = lo + 16 * threadIdx.x; o < hi; o += 16 * THREADS)
      *reinterpret_cast<uint4*>(pl.bitmap[c] + o) = zero;
  }
  const long long lo = max(zi * TAIL_BYTES, (long long)used * NG);
  const long long hi = min(pl.kr[c] * NG, (zi + 1) * TAIL_BYTES);
  for (long long o = lo + 16 * threadIdx.x; o < hi; o += 16 * THREADS)
    *reinterpret_cast<uint4*>(pl.vals[c] + o) = zero;
}

__global__ void __launch_bounds__(THREADS)
compact(CompactPlanes pl, int nc, long long tiles, int ng, int nz,
        const unsigned* gbase) {
  __shared__ __align__(16) uint8_t vbuf[GROUP * TILE];
  __shared__ unsigned rows_s[GROUP];
  __shared__ long long base_s[GROUP];
  const unsigned block = blockIdx.x;
  if (block >= (unsigned)(nc * ng)) {
    const unsigned z = block - nc * ng;
    zero_tail(pl, z / nz, z % nz, tiles, gbase[nc * ng + z / nz]);
    return;
  }
  const int c = block / ng, grp = block % ng;
  const int lt = threadIdx.x >> 3, g = threadIdx.x & 7;
  const long long tile = (long long)grp * GROUP + lt;
  const bool live = tile < tiles;
  uint4 x[TILE_ROWS];
  const uint4* src = reinterpret_cast<const uint4*>(pl.src[c] + tile * TILE) + g;
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j)
    x[j] = live ? __ldcs(src + j * (NG / 16)) : make_uint4(0, 0, 0, 0);
  unsigned bm[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j) {
    bm[0] |= nonzero_bits(x[j].x) >> (7 - j);
    bm[1] |= nonzero_bits(x[j].y) >> (7 - j);
    bm[2] |= nonzero_bits(x[j].z) >> (7 - j);
    bm[3] |= nonzero_bits(x[j].w) >> (7 - j);
  }
  if (live)
    *reinterpret_cast<uint4*>(pl.bitmap[c] + tile * NG + 16 * g) =
        make_uint4(bm[0], bm[1], bm[2], bm[3]);
  unsigned m[TILE_ROWS], pos[TILE_ROWS], nnz;
  strip_ranks(bm, g, m, pos, nnz);
  const unsigned rows = (nnz + NG - 1) / NG;
  if (g == 0) rows_s[lt] = rows;
  __syncthreads();
  tile_bases(rows_s, base_s, gbase[block]);
  // the tile's values in shared memory: its last row's padding zeroed
  // first, then each nonzero at its rank
  uint8_t* vb = vbuf + lt * TILE;
  if (rows) reinterpret_cast<uint4*>(vb + (rows - 1) * NG)[g] = make_uint4(0, 0, 0, 0);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j) {
    unsigned mm = m[j], p = pos[j];
    while (mm) {
      const int i = __ffs(mm) - 1;
      mm &= mm - 1;
      vb[p++] = (uint8_t)byte_of(x[j], i);
    }
  }
  __syncwarp();
  const long long base = base_s[lt], kr = pl.kr[c];
  uint4* dst = reinterpret_cast<uint4*>(pl.vals[c]);
  for (unsigned r = 0; r < rows && base + r < kr; ++r)
    dst[(base + r) * (NG / 16) + g] = reinterpret_cast<const uint4*>(vb + r * NG)[g];
}

// Symbols [off, off + 16) of a plane of n_out, a 16-byte store where
// they are whole and aligned.
__device__ __forceinline__ void store16(uint8_t* out, long long off,
                                        long long n_out, const unsigned (&o)[4]) {
  if (off >= n_out) return;
  uint8_t* d = out + off;
  if (off + 16 <= n_out && !(reinterpret_cast<uintptr_t>(d) & 15)) {
    *reinterpret_cast<uint4*>(d) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (off + k < n_out) d[k] = (uint8_t)(o[k >> 2] >> (8 * (k & 3)));
  }
}

__global__ void __launch_bounds__(THREADS)
expand(ExpandPlanes pl, int nc, long long tiles, int ng, long long n_out,
       const unsigned* gbase) {
  __shared__ __align__(16) uint8_t vbuf[GROUP * TILE];
  __shared__ unsigned rows_s[GROUP];
  __shared__ long long base_s[GROUP];
  const unsigned block = blockIdx.x;
  const int c = block / ng, grp = block % ng;
  const int lt = threadIdx.x >> 3, g = threadIdx.x & 7;
  const long long tile = (long long)grp * GROUP + lt;
  const bool live = tile < tiles;
  const uint4 b = live ? *reinterpret_cast<const uint4*>(pl.bitmap[c] + tile * NG + 16 * g)
                       : make_uint4(0, 0, 0, 0);
  const unsigned bm[4] = {b.x, b.y, b.z, b.w};
  unsigned m[TILE_ROWS], pos[TILE_ROWS], nnz;
  strip_ranks(bm, g, m, pos, nnz);
  const unsigned rows = (nnz + NG - 1) / NG;
  if (g == 0) rows_s[lt] = rows;
  __syncthreads();
  tile_bases(rows_s, base_s, gbase[block]);
  // the tile's value rows in shared memory, zeros at or past the capacity
  const long long base = base_s[lt], kr = pl.kr[c];
  const uint4* src = reinterpret_cast<const uint4*>(pl.vals[c]);
  uint8_t* vb = vbuf + lt * TILE;
  for (unsigned r = 0; r < rows; ++r)
    reinterpret_cast<uint4*>(vb + r * NG)[g] =
        base + r < kr ? src[(base + r) * (NG / 16) + g] : make_uint4(0, 0, 0, 0);
  __syncwarp();
  if (!live) return;
  uint8_t* out = pl.out[c];
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j) {
    unsigned o[4] = {0, 0, 0, 0};
    unsigned mm = m[j], p = pos[j];
    while (mm) {
      const int i = __ffs(mm) - 1;
      mm &= mm - 1;
      const unsigned v = (unsigned)vb[p++] << (8 * (i & 3));
      const int w = i >> 2;
      o[0] |= w == 0 ? v : 0u;
      o[1] |= w == 1 ? v : 0u;
      o[2] |= w == 2 ? v : 0u;
      o[3] |= w == 3 ? v : 0u;
    }
    store16(out, tile * TILE + j * NG + 16 * g, n_out, o);
  }
}

bool aligned16(long long p) { return (p & 15) == 0; }

// group_rows, then scan_groups: scratch takes agg (nc * ng words), then
// gbase (nc * ng + nc words).
int group_bases(const GroupSrc& src, int nc, long long tiles, int ng,
                unsigned* scratch, cudaStream_t stream) {
  const long long warps = (long long)nc * ng;
  group_rows<<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(src, nc, tiles, ng,
                                                              scratch);
  if (int err = (int)cudaGetLastError()) return err;
  scan_groups<<<1, SCAN_THREADS, 0, stream>>>(scratch, nc, ng, scratch + warps);
  return (int)cudaGetLastError();
}

bool bad_grid(int nc, long long tiles, int ng, long long blocks) {
  return nc < 1 || nc > MAX_PLANES || tiles < 1 ||
         ng != (tiles + GROUP - 1) / GROUP || blocks >= (1ll << 31) ||
         tiles * TILE_ROWS >= (1ll << 32);
}

}  // namespace

// Compact nc planes of tiles * 1024 uint8 symbols: three launches
// (group_rows, scan_groups, compact).  Per plane (host arrays of nc):
// src, bitmap and vals are 16-byte aligned device addresses, trows the
// device address of the plane's per-tile value rows (int32, the symbols'
// own); bm_len the bitmap segment's bytes (≥ tiles * 128, a multiple of
// 16; zeroed past the bitmap); kr its value capacity rows (vals holds
// kr * 128 bytes, rows past the used ones zeroed).  ng = ceil(tiles /
// 32) groups and nz tail blocks a plane; scratch: 2 * nc * ng + nc words.
extern "C" int alc_sparse_compact(int nc, long long tiles, int ng, int nz,
                                  const long long* src, const long long* trows,
                                  const long long* bitmap,
                                  const long long* bm_len, const long long* vals,
                                  const long long* kr, void* scratch,
                                  void* stream) {
  if (bad_grid(nc, tiles, ng, (long long)nc * (ng + nz)) || nz < 0)
    return (int)cudaErrorInvalidValue;
  CompactPlanes pl{};
  GroupSrc gs{};
  for (int c = 0; c < nc; ++c) {
    if (!aligned16(src[c]) || !aligned16(bitmap[c]) || !aligned16(vals[c]) ||
        !aligned16(bm_len[c]) || bm_len[c] < tiles * NG || kr[c] < 0 || !trows[c])
      return (int)cudaErrorInvalidValue;
    pl.src[c] = reinterpret_cast<const uint8_t*>(src[c]);
    pl.bitmap[c] = reinterpret_cast<uint8_t*>(bitmap[c]);
    pl.vals[c] = reinterpret_cast<uint8_t*>(vals[c]);
    pl.bm_len[c] = bm_len[c];
    pl.kr[c] = kr[c];
    gs.trows[c] = reinterpret_cast<const int32_t*>(trows[c]);
  }
  unsigned* words = static_cast<unsigned*>(scratch);
  if (int err = group_bases(gs, nc, tiles, ng, words, (cudaStream_t)stream))
    return err;
  compact<<<(unsigned)(nc * (ng + nz)), THREADS, 0, (cudaStream_t)stream>>>(
      pl, nc, tiles, ng, nz, words + (long long)nc * ng);
  return (int)cudaGetLastError();
}

// Expand nc planes of tiles * 1024 symbols: three launches (group_rows
// on the bitmaps, scan_groups, expand).  Per plane, bitmap (tiles * 128
// bytes) and vals (kr * 128 bytes) 16-byte aligned device addresses, out
// the device address that receives the plane's first n_out ≤ tiles *
// 1024 symbols.  ng and scratch as for compact.
extern "C" int alc_sparse_expand(int nc, long long tiles, int ng,
                                 long long n_out, const long long* bitmap,
                                 const long long* vals, const long long* out,
                                 const long long* kr, void* scratch,
                                 void* stream) {
  if (bad_grid(nc, tiles, ng, (long long)nc * ng) || n_out < 0 ||
      n_out > tiles * TILE)
    return (int)cudaErrorInvalidValue;
  ExpandPlanes pl{};
  GroupSrc gs{};
  for (int c = 0; c < nc; ++c) {
    if (!aligned16(bitmap[c]) || !aligned16(vals[c]) || kr[c] < 0)
      return (int)cudaErrorInvalidValue;
    pl.bitmap[c] = reinterpret_cast<const uint8_t*>(bitmap[c]);
    pl.vals[c] = reinterpret_cast<const uint8_t*>(vals[c]);
    pl.out[c] = reinterpret_cast<uint8_t*>(out[c]);
    pl.kr[c] = kr[c];
    gs.bitmap[c] = pl.bitmap[c];
  }
  unsigned* words = static_cast<unsigned*>(scratch);
  if (int err = group_bases(gs, nc, tiles, ng, words, (cudaStream_t)stream))
    return err;
  expand<<<(unsigned)(nc * ng), THREADS, 0, (cudaStream_t)stream>>>(
      pl, nc, tiles, ng, n_out, words + (long long)nc * ng);
  return (int)cudaGetLastError();
}
