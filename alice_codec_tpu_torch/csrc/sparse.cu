// Sparse significance coding for Hopper (sm_90a): compact and expand.
//
// Replaces the TPU kernels of alice_codec_tpu/ops/pallas/sparse_kernels.py:
//   * compact_pallas (_compact_kernel, _compact_slot)
//   * expand_pallas (_expand_kernel, _expand_slot)
// and computes the NumPy spec alice_codec_tpu/ops/sparse_spec.py
// (pack_bitmap, compact_values, expand_values).
//
// Layout (wire v5).  A plane of pp symbols is pp / 1024 tiles of 8 pixel
// rows x 128 lanes.  Bitmap byte (tile, l) has bit j set where
// sym[tile*1024 + j*128 + l] != 0.  A tile's nonzero symbols, in pixel
// order, start at value row base[tile] of its plane (128 symbols a row)
// and are padded to whole rows; base is the prefix of the tiles' ceil row
// counts, computed by the wrapper (the JAX package computes it in XLA
// outside its kernels too).  Plane c's rows start at row row0[c] of the
// values buffer and it holds kr[c] rows.
//
// What bounds it on the H100: bytes.  Compact reads each symbol once and
// writes the bitmap (1/8 of the symbols) and the nonzeros; expand the
// reverse.  There is no arithmetic to speak of.
//
// Design.  One block of 128 threads per tile, thread = lane.  Each thread
// holds its lane's 8 symbols (or bits) in registers and ORs them into its
// bitmap byte, one coalesced 128-byte store per tile.  A nonzero's rank
// inside the tile is a warp ballot + popcount per row plus the exclusive
// prefix of the 32 (row, warp) counts, scanned by one warp in shared
// memory: this takes the place of the TPU kernels' one-hot matmul ranks
// and in-register row placement, and needs no V-batching of blocks — the
// card runs thousands of tile blocks at once.  An empty tile writes its
// zero bitmap (compact) or zero symbols (expand) and skips the rest, as
// the JAX kernels' pl.when(trows > 0) does.
//
// Compact writes only the nonzeros: the wrapper hands it a zeroed values
// buffer, so every padding symbol and every row past a plane's used rows
// is 0.  A value that would land at or past its plane's capacity is
// dropped.  Expand reads a row only below its plane's capacity and gives
// 0 otherwise, so a hostile bitmap whose popcount exceeds the capacity
// decodes as the JAX package decodes it (its block bases are clamped to
// the capacity, sparse_kernels.py:173, and the reads past it land in a
// zero margin) and never reads out of its buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NG = 128;
constexpr int TILE_ROWS = 8;
constexpr int MAX_PLANES = 16;

struct Planes {
  long long kr[MAX_PLANES];    // value capacity rows of each plane
  long long row0[MAX_PLANES];  // first row of each plane in the values
};

// The exclusive prefix, in pixel order, of the per-(row, warp) counts of
// the tile's set bits: pre_s[j*4 + w] is the number of set bits before
// warp w's 32 lanes of row j.  bal[j] is this warp's ballot of row j.
__device__ __forceinline__ void tile_prefix(const unsigned (&bal)[TILE_ROWS],
                                            int* cnt_s, int* pre_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < TILE_ROWS; ++j) cnt_s[j * 4 + warp] = __popc(bal[j]);
  }
  __syncthreads();
  if (warp == 0) {
    const int v = cnt_s[lane];
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += u;
    }
    pre_s[lane] = inc - v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NG)
compact(const uint8_t* __restrict__ sym, const int32_t* __restrict__ base,
        uint8_t* __restrict__ bitmap, uint8_t* __restrict__ vals,
        long long tiles_per_plane, Planes planes) {
  __shared__ int cnt_s[32];
  __shared__ int pre_s[32];
  const long long tile = blockIdx.x;
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  const uint8_t* src = sym + tile * (TILE_ROWS * NG);
  uint8_t s[TILE_ROWS];
  int byte = 0;
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j) {
    s[j] = src[j * NG + l];
    byte |= (s[j] != 0) << j;
  }
  bitmap[tile * NG + l] = (uint8_t)byte;
  if (!__syncthreads_or(byte)) return;  // empty tile: no values
  unsigned bal[TILE_ROWS];
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j)
    bal[j] = __ballot_sync(0xffffffffu, s[j] != 0);
  tile_prefix(bal, cnt_s, pre_s);
  const int c = (int)(tile / tiles_per_plane);
  const long long cap = planes.kr[c] * NG;
  const long long dst0 = (long long)base[tile] * NG;
  uint8_t* out = vals + planes.row0[c] * NG;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j) {
    if (s[j]) {
      const long long d = dst0 + pre_s[j * 4 + warp] + __popc(bal[j] & lt);
      if (d < cap) out[d] = s[j];
    }
  }
}

__global__ void __launch_bounds__(NG)
expand(const uint8_t* __restrict__ bitmap, const uint8_t* __restrict__ vals,
       const int32_t* __restrict__ base, uint8_t* __restrict__ sym,
       long long tiles_per_plane, Planes planes) {
  __shared__ int cnt_s[32];
  __shared__ int pre_s[32];
  const long long tile = blockIdx.x;
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  uint8_t* dst = sym + tile * (TILE_ROWS * NG);
  const int byte = bitmap[tile * NG + l];
  if (!__syncthreads_or(byte)) {  // empty tile: zeros
#pragma unroll
    for (int j = 0; j < TILE_ROWS; ++j) dst[j * NG + l] = 0;
    return;
  }
  unsigned bal[TILE_ROWS];
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j)
    bal[j] = __ballot_sync(0xffffffffu, (byte >> j) & 1);
  tile_prefix(bal, cnt_s, pre_s);
  const int c = (int)(tile / tiles_per_plane);
  const long long kr = planes.kr[c];
  const uint8_t* src = vals + planes.row0[c] * NG;
  const long long b = base[tile];
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < TILE_ROWS; ++j) {
    uint8_t v = 0;
    if ((byte >> j) & 1) {
      const int pos = pre_s[j * 4 + warp] + __popc(bal[j] & lt);
      const long long row = b + (pos >> 7);
      if (row < kr) v = src[row * NG + (pos & (NG - 1))];
    }
    dst[j * NG + l] = v;
  }
}

int planes_of(int nc, const long long* kr, const long long* row0,
              Planes* out) {
  if (nc < 1 || nc > MAX_PLANES) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < MAX_PLANES; ++c) {
    out->kr[c] = c < nc ? kr[c] : 0;
    out->row0[c] = c < nc ? row0[c] : 0;
  }
  return 0;
}

}  // namespace

// symbols: (nc, tiles_per_plane * 1024) u8; base: (nc * tiles_per_plane,)
// i32 plane-relative value row of each tile; bitmap: (nc,
// tiles_per_plane * 128) u8; vals: (sum kr, 128) u8, zeroed by the caller;
// kr / row0: nc host values.
extern "C" int alc_sparse_compact(const void* symbols, const void* base,
                                  void* bitmap, void* vals, int nc,
                                  long long tiles_per_plane,
                                  const long long* kr, const long long* row0,
                                  void* stream) {
  Planes planes;
  if (int err = planes_of(nc, kr, row0, &planes)) return err;
  compact<<<(unsigned)(nc * tiles_per_plane), NG, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)symbols, (const int32_t*)base, (uint8_t*)bitmap,
      (uint8_t*)vals, tiles_per_plane, planes);
  return cudaGetLastError();
}

// bitmap: (nc, tiles_per_plane * 128) u8; vals: (sum kr, 128) u8; base:
// (nc * tiles_per_plane,) i32 (block bases clamped to the capacity, plus
// the tile's offset in its block); symbols: (nc, tiles_per_plane * 1024) u8.
extern "C" int alc_sparse_expand(const void* bitmap, const void* vals,
                                 const void* base, void* symbols, int nc,
                                 long long tiles_per_plane,
                                 const long long* kr, const long long* row0,
                                 void* stream) {
  Planes planes;
  if (int err = planes_of(nc, kr, row0, &planes)) return err;
  expand<<<(unsigned)(nc * tiles_per_plane), NG, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bitmap, (const uint8_t*)vals, (const int32_t*)base,
      (uint8_t*)symbols, tiles_per_plane, planes);
  return cudaGetLastError();
}
