// Level-0 interleaved 3D lifting for Hopper (sm_90a): fused with
// quantization (forward) and dequantization (inverse), or plain (int32 in
// and out).
//
// Replaces the TPU kernels of alice_codec_tpu/ops/pallas/lift_kernels.py:
//   * forward_quant_pallas  (_spatial_kernel + _temporal_quant_kernel)
//   * inverse_dequant_pallas (_temporal_dequant_kernel + _spatial_kernel)
//     -- and, on frames too large for one VMEM block (4K), their split
//     spatial _axis_kernel: spatial_tiles stores int16 between its axes;
//   * forward_3d_pallas / inverse_3d_pallas (_spatial_kernel +
//     _temporal_kernel), int32 throughout, and their split _axis_kernel
//     (K7b): spatial_tiles at int32, whose store between the axes is
//     int32 as the TPU's is at the input's dtype.
//
// What bounds it on the H100: memory traffic.  Every step is a handful of
// integer operations per coefficient, against 2-8 bytes moved per
// coefficient per pass (a 64x1080x1920 chunk holds 398 M coefficients).
//
// Every lift here is two passes, one spatial and one temporal.  The fused
// kernels (K1 forward_quant, K4 inverse_dequant) store one int16 volume
// between them, the TPU kernels' own store (o_ref.astype at
// lift_kernels.py:135 and :193); the plain 3D lift (K7) stores int32.
//   * spatial_tiles: one 256-thread block per (plane, tile).  A 1080p
//     frame does not fit shared memory, so a block lifts a halo window of
//     64 rows x 256 columns held in registers: warp g owns rows 8g..8g+7,
//     lane l columns 8l..8l+7 (one 16-byte load per row at int16, two at
//     int32; the storage type is a template argument).  Lifting is
//     local: a step reads only its two neighbours, so a window whose cut
//     edges lie `halo` (= the number of steps) or more positions from the
//     stored tile gives the tile the full-frame values.  The stored tile is
//     (64 - 2 halo) x 240; windows are clamped into the frame, so on frames
//     of at least 64 x 256 (W a multiple of 8) the frame edges fall on a
//     warp's first or last row and a lane's first or last column, where
//     the neighbour comes from another thread anyway (a warp shuffle along
//     W, a shared-memory row exchange between warps along H).  Smaller or
//     ragged frames take the checked form (element loads, edge tests at
//     every target).  The filter is a template argument, so every delta is
//     folded to its shift or multiply form at compile time.
//   * temporal_*_t64: T = 64 (the codec's chunk) in registers, two
//     neighbouring columns a thread (4-byte int16 and 2-byte uint8
//     accesses, coalesced across the warp); other T take the shared-memory
//     column kernels temporal_quant / temporal_dequant (whole columns where
//     T x 128 ints fit, else windows of 64 frames with a halo, see
//     axis_span).  The forward pass
//     quantizes with a per-channel multiply-high reciprocal computed on the
//     host (exact floor division for every numerator below 2^31) and
//     zigzags; the inverse pass un-zigzags and dequantizes on the way in.
//     K7's temporal_lift_t64 holds two int32 columns a thread (8-byte
//     accesses; 2-3 % faster than one column a thread on the H100); other
//     T take the shared-memory temporal_lift.
//
// Storage points follow the TPU kernels exactly: int32 inside a pass,
// int16 where the Pallas kernels store.  An out-of-range inverse
// intermediate therefore WRAPS at the temporal -> spatial boundary, and,
// on frames the TPU splits (split = 1), between the two spatial axes
// (lift_kernels.py:144), as on the TPU.  The plain 3D lift (K7) stores
// int32 everywhere (its o_ref is int32; split = 0).  Its forward runs the
// tiles from the input into the output and the temporal pass in place
// there (T windowed: through a scratch volume); its inverse runs the
// temporal pass into a scratch volume and the tiles from it into the
// output, since overlapping windows cannot be lifted in place.  Arithmetic
// that can overflow runs in unsigned int (two's-complement wrap, no
// undefined behaviour); right shifts of negative values are arithmetic.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

struct Steps {
  int n;          // number of lifting steps (2 or 4)
  int coeff[4];   // coefficient x 2^12, already negated for compat inverse
  int predict[4]; // 1: targets odd indices; 0: targets even indices
  int sub;        // 1: exact inverse (subtract the delta)
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// Exact int32 (avg * coeff + 4096) >> 13, the decomposition of
// alice_codec_tpu/ops/wavelet.py _delta (shift forms for powers of two).
__device__ __forceinline__ int delta(int avg, int coeff) {
  switch (coeff) {
    case -4096: return wsub(1, avg) >> 1;
    case 4096: return wadd(avg, 1) >> 1;
    case 2048: return wadd(avg, 2) >> 2;
    case -2048: return wsub(2, avg) >> 2;
    case 1024: return wadd(avg, 4) >> 3;
    case -1024: return wsub(4, avg) >> 3;
    default: break;
  }
  int hi = avg >> 13;
  int lo = avg & 8191;
  return wadd(wmul(coeff, hi), wadd(wmul(coeff, lo), 4096) >> 13);
}

// One step's update of target i of a line a[0..n) with element stride s.
// Targets read only non-targets, so all targets of a step may update in
// parallel.  Edge rules of lift_kernels.py:106-117 (n even): predict
// mirrors its right neighbour at n-1, update its left neighbour at 0.
__device__ __forceinline__ void lift_one(int* a, int i, int n, int s,
                                         int coeff, int predict, int sub) {
  int nbr;
  if (predict) {
    int nl = a[(i - 1) * s];
    nbr = wadd(nl, i == n - 1 ? nl : a[(i + 1) * s]);
  } else {
    int nr = a[(i + 1) * s];
    nbr = wadd(i == 0 ? nr : a[(i - 1) * s], nr);
  }
  int d = delta(nbr, coeff);
  a[i * s] = sub ? wsub(a[i * s], d) : wadd(a[i * s], d);
}

// ---- windows along one axis -----------------------------------------------

// Lifting is local: a step reads only its two neighbours, so after the n
// steps of a filter a value depends on positions at most n away.  A line
// too long for shared memory is therefore lifted in windows of `win`
// positions: window k stores [r0, r1), a span of win - 2 halo positions,
// and lifts [w0, w0 + win) around it as if its cut ends were the line's
// ends (halo >= n keeps the wrong values those ends give out of the
// stored span).  The windows are clamped into the line when `clamp`, so
// only the line's own ends are left to clip.  With halo and win even,
// every window starts on an even position and keeps the line's parity.
struct Span {
  int r0, r1, w0;
};

__host__ __device__ inline Span line_window(int k, int n, int win, int halo,
                                            bool clamp) {
  const int tile = win - 2 * halo;
  Span s;
  s.r0 = k * tile;
  s.r1 = s.r0 + tile < n ? s.r0 + tile : n;
  s.w0 = s.r0 - halo;
  if (clamp) s.w0 = s.w0 < 0 ? 0 : (s.w0 > n - win ? n - win : s.w0);
  return s;
}

// The shared-memory temporal passes' windows of T = n frames: one window
// [0, n) when n <= win (the host passes win = n where the whole column
// fits shared memory), else clamped line windows.  Window k stores
// [r0, r1) and lifts [lo, hi).
__host__ __device__ inline int axis_windows(int n, int win, int halo) {
  return n <= win ? 1 : (n + win - 2 * halo - 1) / (win - 2 * halo);
}

// WIN = false: the kernels' whole-line form (one window, n <= win),
// compiled without the window arithmetic.
template <bool WIN>
__host__ __device__ __forceinline__ void axis_span(int k, int n, int win, int halo,
                                          int* r0, int* r1, int* lo, int* hi) {
  if (!WIN) {
    *r0 = *lo = 0;
    *r1 = *hi = n;
    return;
  }
  const Span s = line_window(k, n, win, halo, true);
  *r0 = s.r0;
  *r1 = s.r1;
  *lo = s.w0;
  *hi = s.w0 + win;
}

// ---- filters known at compile time ------------------------------------------

// The three filters of alice_codec_tpu/ops/wavelet.py (coefficients x 2^12;
// every filter alternates predict, update): 0 Haar, 1 CDF 5/3, 2 CDF 9/7.
__host__ __device__ constexpr int base_n(int b) { return b == 2 ? 4 : 2; }
__host__ __device__ constexpr int base_coeff(int b, int k) {
  return b == 0   ? (k == 0 ? -4096 : 2048)
         : b == 1 ? (k == 0 ? -4096 : 1024)
                  : (k == 0 ? -6497 : k == 1 ? -217 : k == 2 ? 3616 : 1817);
}

enum Mode { kForward = 0, kInverseCompat = 1, kInverseExact = 2 };

// Step k of filter B applied in mode M: forward steps in order; inverse
// steps in reverse, with negated coefficients (compat) or subtracted
// deltas (exact), as lift_steps in ops/wavelet.py orders them.
template <int B, int M>
struct Filter {
  static constexpr int n = base_n(B);
  static constexpr bool sub = M == kInverseExact;
  __host__ __device__ static constexpr int src(int k) {
    return M == kForward ? k : n - 1 - k;
  }
  __host__ __device__ static constexpr int coeff(int k) {
    return M == kInverseCompat ? -base_coeff(B, src(k)) : base_coeff(B, src(k));
  }
  __host__ __device__ static constexpr bool predict(int k) {
    return (src(k) & 1) == 0;
  }
};

// Step K of filter F on target x; the coefficient is a constant, so
// delta()'s switch folds to one form.
template <class F, int K>
__device__ __forceinline__ int lift_target(int x, int left, int right) {
  int d = delta(wadd(left, right), F::coeff(K));
  return F::sub ? wsub(x, d) : wadd(x, d);
}

// Calls fn(std::integral_constant<int, K>) for K = 0 .. F::n - 1.
template <class F, int K = 0, class Fn>
__device__ __forceinline__ void for_steps(Fn&& fn) {
  if constexpr (K < F::n) {
    fn(std::integral_constant<int, K>{});
    for_steps<F, K + 1>(fn);
  }
}

// ---- spatial pass (K1 / K4 / K7): halo tiles in registers -------------------

constexpr int kSeg = 8;                   // columns a lane holds
constexpr int kWinW = 32 * kSeg;          // window columns (one warp)
constexpr int kHaloW = 8;                 // column halo, >= any filter's steps
constexpr int kTileW = kWinW - 2 * kHaloW;  // stored columns: 240
constexpr int kRows = 8;                  // rows a warp holds
constexpr int kWarps = 8;                 // warps a block
constexpr int kWinH = kWarps * kRows;     // window rows: 64
constexpr int kTileThreads = 32 * kWarps;

using Tile = int[kRows][kSeg];

// Whether an (h, w) frame takes the clamped-window form (FAST below; the
// launchers also need 16-byte aligned volumes).
__host__ __device__ constexpr bool fast_frame(int h, int w) {
  return h >= kWinH && w >= kWinW && w % kSeg == 0;
}

// Tile (bx, by) of the spatial pass: the rows [r0, r1) and columns [c0, c1)
// it stores, and the frame row and column (wr0, wc0) where its kWinH x kWinW
// window starts (clamped into the frame when fast).  spatial_tiles and
// alc_tile_windows both take the geometry from here.
struct TileWindow {
  int r0, r1, c0, c1, wr0, wc0;
};

__host__ __device__ inline TileWindow tile_window(int bx, int by, int h, int w,
                                                  int halo, bool fast) {
  const Span r = line_window(by, h, kWinH, halo, fast);
  const Span c = line_window(bx, w, kWinW, kHaloW, fast);
  return TileWindow{r.r0, r.r1, c.r0, c.r1, r.w0, c.w0};
}

// All steps along W over the thread's rows.  gc: frame column of v[.][0].
// FAST: the window lies inside the frame, so the frame's first column can
// only be a lane's first one (gc == 0) and its last a lane's last one.
template <class F, bool FAST>
__device__ __forceinline__ void lift_w(Tile& v, int gc, int w) {
  for_steps<F>([&](auto kc) {
    constexpr int K = decltype(kc)::value;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if constexpr (F::predict(K)) {
        int next = __shfl_down_sync(0xffffffffu, v[i][0], 1);
#pragma unroll
        for (int j = 1; j < kSeg; j += 2) {
          int l = v[i][j - 1];
          int r = j + 1 < kSeg ? v[i][j + 1] : next;
          if (FAST ? (j == kSeg - 1 && gc + kSeg == w) : (gc + j == w - 1)) r = l;
          v[i][j] = lift_target<F, K>(v[i][j], l, r);
        }
      } else {
        int prev = __shfl_up_sync(0xffffffffu, v[i][kSeg - 1], 1);
#pragma unroll
        for (int j = 0; j < kSeg; j += 2) {
          int r = v[i][j + 1];
          int l = j > 0 ? v[i][j - 1] : prev;
          if (FAST ? (j == 0 && gc == 0) : (gc + j == 0)) l = r;
          v[i][j] = lift_target<F, K>(v[i][j], l, r);
        }
      }
    }
  });
}

// All steps along H over the window.  gr0: frame row of v[0]; g: warp.
// The row a step needs from the warp below (predict) or above (update)
// goes through shared memory, double-buffered by step parity, so one
// barrier a step suffices.
template <class F, bool FAST>
__device__ __forceinline__ void lift_h(Tile& v, int gr0, int h, int g, int lane,
                                       int (*xch)[kWarps][kSeg][32]) {
  for_steps<F>([&](auto kc) {
    constexpr int K = decltype(kc)::value;
    constexpr bool P = F::predict(K);
    int(*buf)[kSeg][32] = xch[K & 1];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) buf[g][j][lane] = P ? v[0][j] : v[kRows - 1][j];
    __syncthreads();
    const int gn = P ? min(g + 1, kWarps - 1) : max(g - 1, 0);
    int edge[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) edge[j] = buf[gn][j][lane];
    if constexpr (P) {
#pragma unroll
      for (int i = 1; i < kRows; i += 2) {
        const bool mirror =
            FAST ? (i == kRows - 1 && gr0 + kRows == h) : (gr0 + i == h - 1);
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          int up = v[i - 1][j];
          int dn = i + 1 < kRows ? v[i + 1][j] : edge[j];
          v[i][j] = lift_target<F, K>(v[i][j], up, mirror ? up : dn);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRows; i += 2) {
        const bool mirror = FAST ? (i == 0 && gr0 == 0) : (gr0 + i == 0);
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          int dn = v[i + 1][j];
          int up = i > 0 ? v[i - 1][j] : edge[j];
          v[i][j] = lift_target<F, K>(v[i][j], mirror ? dn : up, dn);
        }
      }
    }
  });
}

__device__ __forceinline__ void store_int16(Tile& v) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kSeg; ++j) v[i][j] = (int16_t)v[i][j];
}

// grid (ceil(w / kTileW), ceil(h / (kWinH - 2 halo)), planes): the W and H
// lifts of one tile (forward: W then H; inverse: H then W), S (int16_t:
// K1 / K4; int32_t: K7) in and out, int16 between the axes when split.
// FAST: h >= kWinH, w >= kWinW, w % 8 == 0 and 16-byte aligned volumes;
// the window is clamped into the frame and needs no bounds tests.
template <class S, class F, bool FWD, bool FAST>
__global__ void __launch_bounds__(kTileThreads, 2)
    spatial_tiles(const S* __restrict__ in, S* __restrict__ out,
                  int h, int w, int halo, int split) {
  static_assert(std::is_same_v<S, int16_t> || std::is_same_v<S, int32_t>);
  __shared__ int xch[2][kWarps][kSeg][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const TileWindow tw = tile_window(blockIdx.x, blockIdx.y, h, w, halo, FAST);
  const int gr0 = tw.wr0 + g * kRows, gc = tw.wc0 + lane * kSeg;
  const size_t plane = (size_t)blockIdx.z * h * w;
  Tile v;
  constexpr bool kI16 = std::is_same_v<S, int16_t>;
  if constexpr (FAST && kI16) {
    const S* src = in + plane + (size_t)gr0 * w + gc;
    int4 q[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      q[i] = __ldg(reinterpret_cast<const int4*>(src + (size_t)i * w));
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int word[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[i][2 * k] = (int16_t)(word[k] & 0xffff);
        v[i][2 * k + 1] = word[k] >> 16;
      }
    }
  } else if constexpr (FAST) {
    const int4* src = reinterpret_cast<const int4*>(in + plane + (size_t)gr0 * w + gc);
    const size_t row = w / 4;  // int4 a frame row
    int4 q[2 * kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      q[2 * i] = __ldg(src + i * row);
      q[2 * i + 1] = __ldg(src + i * row + 1);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int word[8] = {q[2 * i].x,     q[2 * i].y,     q[2 * i].z,     q[2 * i].w,
                           q[2 * i + 1].x, q[2 * i + 1].y, q[2 * i + 1].z, q[2 * i + 1].w};
#pragma unroll
      for (int j = 0; j < kSeg; ++j) v[i][j] = word[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = gr0 + i;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const int c = gc + j;
        v[i][j] = (r >= 0 && r < h && c >= 0 && c < w)
                      ? (int)in[plane + (size_t)r * w + c] : 0;
      }
    }
  }
  if (FWD) {
    lift_w<F, FAST>(v, gc, w);
    if (split) store_int16(v);
    lift_h<F, FAST>(v, gr0, h, g, lane, xch);
  } else {
    lift_h<F, FAST>(v, gr0, h, g, lane, xch);
    if (split) store_int16(v);
    lift_w<F, FAST>(v, gc, w);
  }
  const int r0 = tw.r0, r1 = tw.r1, c0 = tw.c0, c1 = tw.c1;
  if constexpr (FAST) {
    if (gc < c0 || gc >= c1) return;  // a lane's 8 columns are all in or out
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = gr0 + i;
      if (r < r0 || r >= r1) continue;
      if constexpr (kI16) {
        int4 q;
        q.x = (int)__byte_perm(v[i][0], v[i][1], 0x5410);
        q.y = (int)__byte_perm(v[i][2], v[i][3], 0x5410);
        q.z = (int)__byte_perm(v[i][4], v[i][5], 0x5410);
        q.w = (int)__byte_perm(v[i][6], v[i][7], 0x5410);
        *reinterpret_cast<int4*>(out + plane + (size_t)r * w + gc) = q;
      } else {
        int4* dst = reinterpret_cast<int4*>(out + plane + (size_t)r * w + gc);
        dst[0] = make_int4(v[i][0], v[i][1], v[i][2], v[i][3]);
        dst[1] = make_int4(v[i][4], v[i][5], v[i][6], v[i][7]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = gr0 + i;
      if (r < r0 || r >= r1) continue;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const int c = gc + j;
        if (c >= c0 && c < c1) out[plane + (size_t)r * w + c] = (S)v[i][j];
      }
    }
  }
}

// ---- temporal pass at T = 64: columns in registers ---------------------------

// Per-channel quantizer: step, dead zone, and the reciprocal of the step
// (m = ceil(2^(31+l) / step), l = ceil(log2 step), made on the host).
struct QuantParams {
  int step, dead_zone;
  unsigned m;
  int l;
};

// floor(n / step) for 0 <= n < 2^31: floor(m n / 2^(31+l)).
__device__ __forceinline__ unsigned quotient(unsigned n, unsigned m, int l) {
  return __umulhi(m, n << 1) >> l;
}

// Dead-zone quantize + zigzag of one coefficient (the low byte is the
// symbol: the reference's `as u8` wrap).  dead_zone >= 0, so the numerator
// |x| - dead_zone / 2 of a coefficient outside the dead zone is >= 0.
__device__ __forceinline__ unsigned quant_symbol(int x, const QuantParams& p) {
  int av = x < 0 ? wsub(0, x) : x;
  unsigned q = quotient((unsigned)(av - (p.dead_zone >> 1)), p.m, p.l);
  q = av >= p.dead_zone ? q : 0u;
  // sign(x) q zigzagged: -n -> 2n, n -> 2n - 1, 0 -> 0
  return 2u * q - ((x >= 0 && q != 0u) ? 1u : 0u);
}

__device__ __forceinline__ int dequant(unsigned s, int step) {
  int q = (s & 1u) ? (int)((s + 1u) >> 1) : -(int)(s >> 1);
  return wmul(q, step);
}

// All steps along a column of T values in registers (T even).
template <class F, int T>
__device__ __forceinline__ void lift_col(int (&x)[T]) {
  for_steps<F>([&](auto kc) {
    constexpr int K = decltype(kc)::value;
#pragma unroll
    for (int i = F::predict(K) ? 1 : 0; i < T; i += 2) {
      int l = i > 0 ? x[i - 1] : x[i + 1];
      int r = i + 1 < T ? x[i + 1] : x[i - 1];
      x[i] = lift_target<F, K>(x[i], l, r);
    }
  });
}

constexpr int kT64 = 64;
constexpr int kPairThreads = 128;

// grid (ceil(hw / 2 / 128), c): forward T lift + quantize + zigzag of two
// neighbouring columns a thread (hw even; 4-byte aligned in, 2-byte out).
template <class F>
__global__ void __launch_bounds__(kPairThreads)
    temporal_quant_t64(const int16_t* __restrict__ in, uint8_t* __restrict__ out,
                       const QuantParams* __restrict__ qp, int hw) {
  const int pair = blockIdx.x * kPairThreads + threadIdx.x;
  if (2 * pair >= hw) return;
  const size_t base = (size_t)blockIdx.y * kT64 * hw + 2 * (size_t)pair;
  int a[kT64], b[kT64];
#pragma unroll
  for (int i = 0; i < kT64; ++i) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(in + base + (size_t)i * hw));
    a[i] = (int16_t)(u & 0xffffu);
    b[i] = (int)u >> 16;
  }
  lift_col<F, kT64>(a);
  lift_col<F, kT64>(b);
  const QuantParams p = qp[blockIdx.y];
#pragma unroll
  for (int i = 0; i < kT64; ++i) {
    const unsigned s = (quant_symbol(a[i], p) & 0xffu) | ((quant_symbol(b[i], p) & 0xffu) << 8);
    *reinterpret_cast<uint16_t*>(out + base + (size_t)i * hw) = (uint16_t)s;
  }
}

// grid (ceil(hw / 2 / 128), c): un-zigzag + dequantize + inverse T lift of
// two neighbouring columns a thread -> int16 (2-byte aligned in, 4-byte out).
template <class F>
__global__ void __launch_bounds__(kPairThreads)
    temporal_dequant_t64(const uint8_t* __restrict__ in, int16_t* __restrict__ out,
                         const int32_t* __restrict__ step, int hw) {
  const int pair = blockIdx.x * kPairThreads + threadIdx.x;
  if (2 * pair >= hw) return;
  const size_t base = (size_t)blockIdx.y * kT64 * hw + 2 * (size_t)pair;
  const int q_step = step[blockIdx.y];
  int a[kT64], b[kT64];
#pragma unroll
  for (int i = 0; i < kT64; ++i) {
    const unsigned u = __ldg(reinterpret_cast<const uint16_t*>(in + base + (size_t)i * hw));
    a[i] = dequant(u & 0xffu, q_step);
    b[i] = dequant(u >> 8, q_step);
  }
  lift_col<F, kT64>(a);
  lift_col<F, kT64>(b);
#pragma unroll
  for (int i = 0; i < kT64; ++i)
    *reinterpret_cast<unsigned*>(out + base + (size_t)i * hw) = __byte_perm(a[i], b[i], 0x5410);
}

// grid (ceil(hw / 2 / 128), c): plain T lift (forward or inverse, by F) of
// two neighbouring int32 columns a thread (hw even; 8-byte accesses and
// aligned volumes).  Each thread reads its columns whole before it writes
// them and no two threads share one, so in may equal out.
template <class F>
__global__ void __launch_bounds__(kPairThreads)
    temporal_lift_t64(const int32_t* in, int32_t* out, int hw) {
  const int pair = blockIdx.x * kPairThreads + threadIdx.x;
  if (2 * pair >= hw) return;
  const size_t base = (size_t)blockIdx.y * kT64 * hw + 2 * (size_t)pair;
  int a[kT64], b[kT64];
#pragma unroll
  for (int i = 0; i < kT64; ++i) {
    const int2 u = *reinterpret_cast<const int2*>(in + base + (size_t)i * hw);
    a[i] = u.x;
    b[i] = u.y;
  }
  lift_col<F, kT64>(a);
  lift_col<F, kT64>(b);
#pragma unroll
  for (int i = 0; i < kT64; ++i)
    *reinterpret_cast<int2*>(out + base + (size_t)i * hw) = make_int2(a[i], b[i]);
}

// ---- temporal passes for any T (shared-memory columns) ----------------------

constexpr int kTemporalThreads = 128;

// Each thread lifts its own column of t values, held in shared memory
// at stride kTemporalThreads (no bank conflicts, no block-wide syncs).
__device__ __forceinline__ void lift_column(int* col, int t, const Steps& st) {
  for (int k = 0; k < st.n; ++k) {
    int p = st.predict[k];
    for (int i = p; i < t; i += 2)
      lift_one(col, i, t, kTemporalThreads, st.coeff[k], p, st.sub);
  }
}

// The column kernels below: grid (ceil(hw / 128), c, windows of T).  A
// block holds `win` frames of 128 columns (win = t where t frames fit
// shared memory, else kTWin frames with `halo` frames of halo, see
// axis_span) and stores the frames [r0, r1) of its window.

// Forward T lift, dead-zone quantize, zigzag.
template <bool WIN>
__global__ void temporal_quant(const int16_t* __restrict__ in,
                               uint8_t* __restrict__ out,
                               const QuantParams* __restrict__ qp, int t,
                               int hw, int win, int halo, Steps st) {
  extern __shared__ int buf[];
  int pos = blockIdx.x * kTemporalThreads + threadIdx.x;
  if (pos >= hw) return;
  int r0, r1, lo, hi;
  axis_span<WIN>(blockIdx.z, t, win, halo, &r0, &r1, &lo, &hi);
  size_t base = ((size_t)blockIdx.y * t + lo) * hw + pos;
  int* col = buf + threadIdx.x;
  for (int i = 0; i < hi - lo; ++i)
    col[i * kTemporalThreads] = in[base + (size_t)i * hw];
  lift_column(col, hi - lo, st);
  const QuantParams p = qp[blockIdx.y];
  for (int i = r0 - lo; i < r1 - lo; ++i)
    out[base + (size_t)i * hw] = (uint8_t)(quant_symbol(col[i * kTemporalThreads], p) & 0xFFu);
}

// Un-zigzag, dequantize, inverse T lift -> i16.
template <bool WIN>
__global__ void temporal_dequant(const uint8_t* __restrict__ in,
                                 int16_t* __restrict__ out,
                                 const int32_t* __restrict__ step, int t,
                                 int hw, int win, int halo, Steps st) {
  extern __shared__ int buf[];
  int pos = blockIdx.x * kTemporalThreads + threadIdx.x;
  if (pos >= hw) return;
  int r0, r1, lo, hi;
  axis_span<WIN>(blockIdx.z, t, win, halo, &r0, &r1, &lo, &hi);
  size_t base = ((size_t)blockIdx.y * t + lo) * hw + pos;
  int* col = buf + threadIdx.x;
  int q_step = step[blockIdx.y];
  for (int i = 0; i < hi - lo; ++i)
    col[i * kTemporalThreads] = dequant(in[base + (size_t)i * hw], q_step);
  lift_column(col, hi - lo, st);
  for (int i = r0 - lo; i < r1 - lo; ++i)
    out[base + (size_t)i * hw] = (int16_t)col[i * kTemporalThreads];
}

// Plain T lift, int32 -> int32 (forward or inverse, by the steps).  in
// may equal out when the column is one window: each thread then reads its
// whole column before it writes it, and no two threads share a column.
template <bool WIN>
__global__ void temporal_lift(const int32_t* in, int32_t* out, int t, int hw,
                              int win, int halo, Steps st) {
  extern __shared__ int buf[];
  int pos = blockIdx.x * kTemporalThreads + threadIdx.x;
  if (pos >= hw) return;
  int r0, r1, lo, hi;
  axis_span<WIN>(blockIdx.z, t, win, halo, &r0, &r1, &lo, &hi);
  size_t base = ((size_t)blockIdx.y * t + lo) * hw + pos;
  int* col = buf + threadIdx.x;
  for (int i = 0; i < hi - lo; ++i)
    col[i * kTemporalThreads] = in[base + (size_t)i * hw];
  lift_column(col, hi - lo, st);
  for (int i = r0 - lo; i < r1 - lo; ++i)
    out[base + (size_t)i * hw] = col[i * kTemporalThreads];
}

// grid-stride over n in [0, 2^31) for each of `count` quantizers: counts
// the n whose quotient() differs from floor(n / step).
__global__ void reciprocal_mismatches(const QuantParams* __restrict__ qp,
                                      int count,
                                      unsigned long long* __restrict__ bad) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (int k = 0; k < count; ++k) {
    const QuantParams p = qp[k];
    const unsigned long long d = (unsigned)p.step;
    unsigned long long miss = 0;
    for (unsigned n = blockIdx.x * blockDim.x + threadIdx.x; n < 0x80000000u;
         n += stride) {
      const unsigned long long q = quotient(n, p.m, p.l);
      miss += (q * d > n || (q + 1) * d <= n) ? 1 : 0;
    }
    if (miss) atomicAdd(bad, miss);
  }
}

Steps make_steps(int n, const int* coeff, const int* predict, int sub) {
  Steps st{};
  st.n = n;
  for (int k = 0; k < n && k < 4; ++k) {
    st.coeff[k] = coeff[k];
    st.predict[k] = predict[k];
  }
  st.sub = sub;
  return st;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

unsigned cdiv(size_t a, size_t b) { return (unsigned)((a + b - 1) / b); }

// Shared memory a block may use, and the window of the temporal column
// kernels where a whole column does not fit it (see axis_span): 64 frames
// (32 KB for 128 columns).
constexpr size_t kSmemLimit = 232448;
constexpr int kTWin = 64;

// A pass's window along an axis of n positions of `bytes` of shared
// memory each: the whole axis where it fits, else `win`.
int pass_win(int n, size_t bytes, int win) {
  return (size_t)n * bytes <= kSmemLimit ? n : win;
}

// The launch of a temporal column kernel (whole: its whole-column form,
// windowed: its windowed one) with leading arguments `args`: windows of T
// in grid.z.
template <typename K, typename... A>
cudaError_t temporal_launch(K whole, K windowed, int c, int t, size_t hw,
                            int halo, const Steps& st, cudaStream_t s,
                            A... args) {
  const int win = pass_win(t, kTemporalThreads * sizeof(int), kTWin);
  const K kernel = t > win ? windowed : whole;
  const size_t smem = (size_t)win * kTemporalThreads * sizeof(int);
  cudaError_t e;
  if ((e = allow_smem(kernel, smem))) return e;
  kernel<<<dim3(cdiv(hw, kTemporalThreads), c, axis_windows(t, win, halo)),
           kTemporalThreads, smem, s>>>(args..., t, (int)hw, win, halo, st);
  return cudaGetLastError();
}

// Whether a temporal column kernel lifts T = t in windows (then it reads
// one volume and writes another).
bool t_windowed(int t) {
  return t > pass_win(t, kTemporalThreads * sizeof(int), kTWin);
}

// spatial_tiles' grid: one block per tile of each of `planes` frames.
dim3 tile_grid(int h, int w, int halo, int planes) {
  return dim3(cdiv(w, kTileW), cdiv(h, kWinH - 2 * halo), (unsigned)planes);
}

bool aligned(const void* p, size_t bytes) { return (uintptr_t)p % bytes == 0; }

// The spatial pass of filter F on `planes` frames of S: its FAST form
// where the frame and the volumes' alignment allow it.
template <class S, class F, bool FWD>
cudaError_t spatial_launch(const S* in, S* out, int planes, int h, int w,
                           int halo, int split, cudaStream_t s) {
  const dim3 grid = tile_grid(h, w, halo, planes);
  if (fast_frame(h, w) && aligned(in, 16) && aligned(out, 16))
    spatial_tiles<S, F, FWD, true><<<grid, kTileThreads, 0, s>>>(in, out, h, w, halo, split);
  else
    spatial_tiles<S, F, FWD, false><<<grid, kTileThreads, 0, s>>>(in, out, h, w, halo, split);
  return cudaGetLastError();
}

// Whether the n steps given equal filter B's in mode M.
template <int B, int M>
bool is_filter(const Steps& st) {
  using F = Filter<B, M>;
  if (st.n != F::n || st.sub != (int)F::sub) return false;
  for (int k = 0; k < F::n; ++k)
    if (st.coeff[k] != F::coeff(k) || st.predict[k] != (int)F::predict(k)) return false;
  return true;
}

// The two passes of K1 with filter F.
template <class F>
cudaError_t forward_quant_run(const int16_t* vol, int16_t* tmp16, uint8_t* out,
                              const QuantParams* qp, int c, int t, int h, int w,
                              int halo, int split, const Steps& st,
                              cudaStream_t s) {
  cudaError_t e;
  if ((e = spatial_launch<int16_t, F, true>(vol, tmp16, c * t, h, w, halo, split, s)))
    return e;
  const size_t hw = (size_t)h * w;
  if (t == kT64 && aligned(out, 2)) {
    temporal_quant_t64<F><<<dim3(cdiv(hw / 2, kPairThreads), c), kPairThreads, 0, s>>>(
        tmp16, out, qp, (int)hw);
  } else {
    return temporal_launch(temporal_quant<false>, temporal_quant<true>, c, t,
                           hw, halo, st, s,
                           (const int16_t*)tmp16, out, qp);
  }
  return cudaGetLastError();
}

// The two passes of K4 with filter F.
template <class F>
cudaError_t inverse_dequant_run(const uint8_t* sym, int16_t* tmp16, int16_t* out,
                                const int32_t* step, int c, int t, int h, int w,
                                int halo, int split, const Steps& st,
                                cudaStream_t s) {
  const size_t hw = (size_t)h * w;
  cudaError_t e = cudaSuccess;
  if (t == kT64 && aligned(sym, 2)) {
    temporal_dequant_t64<F><<<dim3(cdiv(hw / 2, kPairThreads), c), kPairThreads, 0, s>>>(
        sym, tmp16, step, (int)hw);
  } else {
    e = temporal_launch(temporal_dequant<false>, temporal_dequant<true>, c, t,
                        hw, halo, st, s, sym, tmp16, step);
  }
  if (e || (e = cudaGetLastError())) return e;
  return spatial_launch<int16_t, F, false>(tmp16, out, c * t, h, w, halo, split, s);
}

// K7's temporal pass with filter F, in -> out (in may equal out where T is
// not windowed).
template <class F>
cudaError_t temporal_3d(const int32_t* in, int32_t* out, int c, int t, size_t hw,
                        int halo, const Steps& st, cudaStream_t s) {
  if (t == kT64 && aligned(in, 8) && aligned(out, 8)) {
    temporal_lift_t64<F><<<dim3(cdiv(hw / 2, kPairThreads), c), kPairThreads, 0, s>>>(
        in, out, (int)hw);
    return cudaGetLastError();
  }
  return temporal_launch(temporal_lift<false>, temporal_lift<true>, c, t, hw,
                         halo, st, s, in, out);
}

// The two passes of K7's forward with filter F: the tiles from vol into
// out, then T in place; where T is windowed, tiles into tmp and T from it.
template <class F>
cudaError_t forward_3d_run(const int32_t* vol, int32_t* out, int32_t* tmp, int c,
                           int t, int h, int w, int halo, const Steps& st,
                           cudaStream_t s) {
  int32_t* mid = t_windowed(t) ? tmp : out;
  cudaError_t e;
  if ((e = spatial_launch<int32_t, F, true>(vol, mid, c * t, h, w, halo, 0, s))) return e;
  return temporal_3d<F>(mid, out, c, t, (size_t)h * w, halo, st, s);
}

// The two passes of K7's inverse with filter F: T into tmp, then the tiles
// from tmp into out.
template <class F>
cudaError_t inverse_3d_run(const int32_t* coeffs, int32_t* out, int32_t* tmp, int c,
                           int t, int h, int w, int halo, const Steps& st,
                           cudaStream_t s) {
  cudaError_t e;
  if ((e = temporal_3d<F>(coeffs, tmp, c, t, (size_t)h * w, halo, st, s))) return e;
  return spatial_launch<int32_t, F, false>(tmp, out, c * t, h, w, halo, 0, s);
}

bool bad_halo(int halo, int n) {
  return halo < n || halo > kHaloW || halo % 2 != 0;
}

}  // namespace

// Forward (K1): i16 volume (c, t, h, w) -> u8 symbols, through tmp16 (the
// spatially lifted int16 volume).  qparams: (c,) QuantParams on the device
// (step >= 1, dead zone >= 0).  coeff / predict: host arrays of the n
// forward steps, which must be one of the three filters.  halo: rows of
// halo a tile loads above and below (even, n <= halo <= 8).  split = 1
// stores int16 between the W and H lifts (the TPU's split spatial path on
// frames beyond its one-block budget, lift_kernels.py:267-291).  Returns
// the first CUDA error of the launches (cudaErrorInvalidValue for steps or
// a halo the kernels do not take).
extern "C" int alc_forward_quant(const void* vol, void* tmp16, void* out,
                                 const void* qparams, int c, int t, int h,
                                 int w, int n, const int* coeff,
                                 const int* predict, int halo, int split,
                                 void* stream) {
  const Steps st = make_steps(n, coeff, predict, 0);
  if (bad_halo(halo, n)) return cudaErrorInvalidValue;
  const auto* v = (const int16_t*)vol;
  auto* t16 = (int16_t*)tmp16;
  auto* o = (uint8_t*)out;
  const auto* qp = (const QuantParams*)qparams;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_filter<0, kForward>(st))
    return forward_quant_run<Filter<0, kForward>>(v, t16, o, qp, c, t, h, w, halo, split, st, s);
  if (is_filter<1, kForward>(st))
    return forward_quant_run<Filter<1, kForward>>(v, t16, o, qp, c, t, h, w, halo, split, st, s);
  if (is_filter<2, kForward>(st))
    return forward_quant_run<Filter<2, kForward>>(v, t16, o, qp, c, t, h, w, halo, split, st, s);
  return cudaErrorInvalidValue;
}

// Inverse (K4): u8 symbols (c, t, h, w) -> i16 volume, through tmp16 (the
// temporal pass's int16 output).  step: (c,) int32 on the device.  coeff /
// predict: host arrays of the n inverse steps in application order
// (negated coefficients for the compat inverse); sub = 1 for exact undo.
// halo and split as for alc_forward_quant (split stores int16 between the
// H and W lifts).
extern "C" int alc_inverse_dequant(const void* sym, void* tmp16, void* out,
                                   const void* step, int c, int t, int h, int w,
                                   int n, const int* coeff, const int* predict,
                                   int sub, int halo, int split, void* stream) {
  const Steps st = make_steps(n, coeff, predict, sub);
  if (bad_halo(halo, n)) return cudaErrorInvalidValue;
  const auto* in = (const uint8_t*)sym;
  auto* t16 = (int16_t*)tmp16;
  auto* o = (int16_t*)out;
  const auto* q = (const int32_t*)step;
  cudaStream_t s = (cudaStream_t)stream;
#define ALC_INVERSE(B, M)                                                      \
  if (is_filter<B, M>(st))                                                     \
    return inverse_dequant_run<Filter<B, M>>(in, t16, o, q, c, t, h, w, halo, \
                                             split, st, s);
  ALC_INVERSE(0, kInverseCompat)
  ALC_INVERSE(1, kInverseCompat)
  ALC_INVERSE(2, kInverseCompat)
  ALC_INVERSE(0, kInverseExact)
  ALC_INVERSE(1, kInverseExact)
  ALC_INVERSE(2, kInverseExact)
#undef ALC_INVERSE
  return cudaErrorInvalidValue;
}

// Counts, over every n in [0, 2^31) and each of the `count` quantizers in
// qparams (device), the n where the forward kernels' reciprocal quotient
// differs from floor(n / step); writes the total to *bad (device, u64).
extern "C" int alc_reciprocal_mismatches(const void* qparams, int count,
                                         void* bad, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if ((e = cudaMemsetAsync(bad, 0, sizeof(unsigned long long), s))) return e;
  reciprocal_mismatches<<<132 * 8, 256, 0, s>>>((const QuantParams*)qparams, count,
                                                (unsigned long long*)bad);
  return cudaGetLastError();
}

// The tiles spatial_tiles lifts on an (h, w) frame (16-byte aligned
// volumes) with `halo` rows of halo, in block order (rows of tiles outer):
// 8 ints a tile, the stored rows [r0, r1) and columns [c0, c1), then the
// window's rows and columns clipped to the frame.  Writes at most `cap`
// tiles to out (host memory); returns the number of tiles, or -1 for a
// halo the kernels do not take.
extern "C" int alc_tile_windows(int h, int w, int halo, int* out, int cap) {
  if (halo < 0 || halo > kHaloW || halo % 2 != 0) return -1;
  const dim3 grid = tile_grid(h, w, halo, 1);
  const bool fast = fast_frame(h, w);
  int k = 0;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx, ++k) {
      if (k >= cap) continue;
      const TileWindow t = tile_window((int)bx, (int)by, h, w, halo, fast);
      const int row[8] = {t.r0, t.r1, t.c0, t.c1,
                          std::max(t.wr0, 0), std::min(t.wr0 + kWinH, h),
                          std::max(t.wc0, 0), std::min(t.wc0 + kWinW, w)};
      std::copy(row, row + 8, out + 8 * k);
    }
  return k;
}

// Plain forward (K7): i32 volume (c, t, h, w) -> i32 coefficients, W and
// H in halo tiles (spatial_tiles at int32, the halo the filter's step
// count), then T.  tmp: an i32 volume like out, needed only where T is
// windowed (alc_lift3d_scratch; else may be null; cudaErrorInvalidValue if
// it is needed and null).  coeff / predict: host arrays of the n forward
// steps, which must be one of the three filters (else
// cudaErrorInvalidValue).  A grid beyond the card's limits (C·T above
// 65535, more than 65535 tiles down a frame) is reported by its launch.
extern "C" int alc_forward_3d(const void* vol, void* out, void* tmp, int c,
                              int t, int h, int w, int n, const int* coeff,
                              const int* predict, void* stream) {
  const Steps st = make_steps(n, coeff, predict, 0);
  if (t_windowed(t) && tmp == nullptr) return cudaErrorInvalidValue;
  const auto* v = (const int32_t*)vol;
  auto* o = (int32_t*)out;
  auto* x = (int32_t*)tmp;
  const int halo = (n + 1) & ~1;
  cudaStream_t s = (cudaStream_t)stream;
#define ALC_K7(B)                                                                 \
  if (is_filter<B, kForward>(st))                                                 \
    return forward_3d_run<Filter<B, kForward>>(v, o, x, c, t, h, w, halo, st, s);
  ALC_K7(0)
  ALC_K7(1)
  ALC_K7(2)
#undef ALC_K7
  return cudaErrorInvalidValue;
}

// Plain inverse (K7): i32 coefficients -> i32 volume, T into tmp (an i32
// volume like out, always needed), then H and W in halo tiles from tmp
// into out.  coeff / predict: the n inverse steps in application order
// (negated coefficients for the compat inverse); sub = 1 for exact undo;
// errors as for alc_forward_3d.
extern "C" int alc_inverse_3d(const void* coeffs, void* out, void* tmp, int c,
                              int t, int h, int w, int n, const int* coeff,
                              const int* predict, int sub, void* stream) {
  const Steps st = make_steps(n, coeff, predict, sub);
  if (tmp == nullptr) return cudaErrorInvalidValue;
  const auto* in = (const int32_t*)coeffs;
  auto* o = (int32_t*)out;
  auto* x = (int32_t*)tmp;
  const int halo = (n + 1) & ~1;
  cudaStream_t s = (cudaStream_t)stream;
#define ALC_K7(B, M)                                                          \
  if (is_filter<B, M>(st))                                                    \
    return inverse_3d_run<Filter<B, M>>(in, o, x, c, t, h, w, halo, st, s);
  ALC_K7(0, kInverseCompat)
  ALC_K7(1, kInverseCompat)
  ALC_K7(2, kInverseCompat)
  ALC_K7(0, kInverseExact)
  ALC_K7(1, kInverseExact)
  ALC_K7(2, kInverseExact)
#undef ALC_K7
  return cudaErrorInvalidValue;
}

// Whether alc_forward_3d (forward = 1) or alc_inverse_3d needs its tmp
// volume for chunks of t frames: the inverse always (its tile pass cannot
// run in place), the forward where T is windowed (T > 454).
extern "C" int alc_lift3d_scratch(int t, int forward) {
  return !forward || t_windowed(t);
}

// The windows the temporal column kernels lift T = n frames in, given
// the pass's window win (n itself where the whole column fits shared
// memory) and `halo`: 4 ints a window, the stored [r0, r1) and the
// lifted [lo, hi), as axis_span gives them.  Writes at most `cap` windows
// to out (host memory); returns the number of windows.
extern "C" int alc_axis_windows(int n, int win, int halo, int* out, int cap) {
  const int count = axis_windows(n, win, halo);
  for (int k = 0; k < count && k < cap; ++k) {
    int* r = out + 4 * k;
    if (n > win)
      axis_span<true>(k, n, win, halo, r, r + 1, r + 2, r + 3);
    else
      axis_span<false>(k, n, win, halo, r, r + 1, r + 2, r + 3);
  }
  return count;
}
