// Level-0 interleaved 3D lifting for Hopper (sm_90a): plain (int32 in and
// out), or fused with quantization (forward) and dequantization (inverse).
//
// Replaces the TPU kernels of alice_codec_tpu/ops/pallas/lift_kernels.py:
//   * forward_quant_pallas  (_spatial_kernel + _temporal_quant_kernel)
//   * inverse_dequant_pallas (_temporal_dequant_kernel + _spatial_kernel)
//   * forward_3d_pallas / inverse_3d_pallas (_spatial_kernel +
//     _temporal_kernel), int32 throughout
// and, for frames too large for one VMEM block (4K), the split spatial
// _axis_kernel: row_lift is its W-axis form, col_lift its H-axis form.
//
// What bounds it on the H100: memory traffic.  Every step is a handful of
// integer operations per coefficient, against 2-6 bytes moved per
// coefficient per pass (a 64x1080x1920 chunk holds 398 M coefficients).
//
// Design.  The TPU kernel keeps one whole (H, W) frame in VMEM and lifts W
// then H without leaving it.  A 1080p frame does not fit the 227 KB of
// shared memory a block may use, so the spatial pass is split in two:
//   * row_lift: one block per (plane, row) lifts a full row (all steps of
//     the filter) in shared memory;
//   * col_lift: one block per (plane, 16-column strip) lifts full columns
//     (an H x 16 int32 strip: 69 KB at H = 1080, dynamic shared memory).
// Between them the coefficients travel as int32, because the fused TPU
// kernel never rounds between its W and H lifts.  The temporal pass gives
// each thread one (c, h, w) column of T values in shared memory; threads
// of a warp own neighbouring w, so every load and store is coalesced.
// The forward temporal pass quantizes and zigzags on the way out (exact
// integer division: CUDA has one, unlike the TPU); the inverse temporal
// pass un-zigzags and dequantizes on the way in.
//
// Storage points follow the TPU kernels exactly: int32 inside a pass,
// int16 where the Pallas kernels store (o_ref.astype at lift_kernels.py
// :135, :144 and :193).  An out-of-range inverse intermediate therefore
// WRAPS at the temporal -> spatial boundary, and, on frames the TPU
// splits (split = 1), between the two spatial passes, as on the TPU.  The plain
// 3D lift stores int32 everywhere (its o_ref is int32) and runs each pass
// in place after the first, so it needs no scratch volume.  Arithmetic
// that can overflow runs in unsigned int (two's-complement wrap, no
// undefined behaviour); right shifts of negative values are arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

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

// ---- spatial passes -------------------------------------------------------

// One block per row of length w; all steps along the row.
// in may equal out: a block reads its whole row before it writes it.
template <typename InT, typename OutT>
__global__ void row_lift(const InT* in, OutT* out, int w, Steps st) {
  extern __shared__ int line[];
  size_t base = (size_t)blockIdx.x * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) line[i] = (int)in[base + i];
  __syncthreads();
  for (int k = 0; k < st.n; ++k) {
    int p = st.predict[k];
    for (int i = p + 2 * threadIdx.x; i < w; i += 2 * blockDim.x)
      lift_one(line, i, w, 1, st.coeff[k], p, st.sub);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < w; i += blockDim.x)
    out[base + i] = (OutT)line[i];
}

constexpr int kStrip = 16;  // columns per col_lift block (blockDim 16 x 16)

// One block per (plane, strip of kStrip columns); all steps along H.  in
// may equal out: a block reads its whole strip before it writes it.
template <typename InT, typename OutT>
__global__ void col_lift(const InT* in, OutT* out, int h, int w, Steps st) {
  extern __shared__ int strip[];  // [h][kStrip]
  int tx = threadIdx.x, ty = threadIdx.y;
  int col = blockIdx.x * kStrip + tx;
  size_t plane = (size_t)blockIdx.y * h * w;
  bool live = col < w;
  if (live)
    for (int r = ty; r < h; r += blockDim.y)
      strip[r * kStrip + tx] = (int)in[plane + (size_t)r * w + col];
  __syncthreads();
  for (int k = 0; k < st.n; ++k) {
    int p = st.predict[k];
    if (live)
      for (int i = p + 2 * ty; i < h; i += 2 * blockDim.y)
        lift_one(strip + tx, i, h, kStrip, st.coeff[k], p, st.sub);
    __syncthreads();
  }
  if (live)
    for (int r = ty; r < h; r += blockDim.y)
      out[plane + (size_t)r * w + col] = (OutT)strip[r * kStrip + tx];
}

// ---- temporal passes ------------------------------------------------------

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

// grid (ceil(hw / 128), c): forward T lift, dead-zone quantize, zigzag.
__global__ void temporal_quant(const int16_t* __restrict__ in,
                               uint8_t* __restrict__ out,
                               const int32_t* __restrict__ step,
                               const int32_t* __restrict__ dead_zone,
                               int t, int hw, Steps st) {
  extern __shared__ int buf[];
  int pos = blockIdx.x * kTemporalThreads + threadIdx.x;
  if (pos >= hw) return;
  size_t base = (size_t)blockIdx.y * t * hw + pos;
  int* col = buf + threadIdx.x;
  for (int i = 0; i < t; ++i) col[i * kTemporalThreads] = in[base + (size_t)i * hw];
  lift_column(col, t, st);
  int q_step = step[blockIdx.y], dz = dead_zone[blockIdx.y];
  for (int i = 0; i < t; ++i) {
    int x = col[i * kTemporalThreads];
    int av = x < 0 ? wsub(0, x) : x;
    int q = 0;
    if (av >= dz) {
      q = (av - (dz >> 1)) / q_step;  // numerator >= 0: floor == trunc
      if (x < 0) q = -q;
    }
    unsigned s = q > 0 ? 2u * (unsigned)q - 1u : 0u - 2u * (unsigned)q;
    out[base + (size_t)i * hw] = (uint8_t)(s & 0xFFu);
  }
}

// grid (ceil(hw / 128), c): un-zigzag, dequantize, inverse T lift -> i16.
__global__ void temporal_dequant(const uint8_t* __restrict__ in,
                                 int16_t* __restrict__ out,
                                 const int32_t* __restrict__ step,
                                 int t, int hw, Steps st) {
  extern __shared__ int buf[];
  int pos = blockIdx.x * kTemporalThreads + threadIdx.x;
  if (pos >= hw) return;
  size_t base = (size_t)blockIdx.y * t * hw + pos;
  int* col = buf + threadIdx.x;
  int q_step = step[blockIdx.y];
  for (int i = 0; i < t; ++i) {
    int s = in[base + (size_t)i * hw];
    int q = (s & 1) ? (s + 1) >> 1 : -(s >> 1);
    col[i * kTemporalThreads] = wmul(q, q_step);
  }
  lift_column(col, t, st);
  for (int i = 0; i < t; ++i)
    out[base + (size_t)i * hw] = (int16_t)col[i * kTemporalThreads];
}

// grid (ceil(hw / 128), c): plain T lift, int32 -> int32 (forward or
// inverse, by the steps).  in may equal out: each thread reads its whole
// column before it writes it, and no two threads share a column.
__global__ void temporal_lift(const int32_t* in, int32_t* out, int t, int hw,
                              Steps st) {
  extern __shared__ int buf[];
  int pos = blockIdx.x * kTemporalThreads + threadIdx.x;
  if (pos >= hw) return;
  size_t base = (size_t)blockIdx.y * t * hw + pos;
  int* col = buf + threadIdx.x;
  for (int i = 0; i < t; ++i) col[i * kTemporalThreads] = in[base + (size_t)i * hw];
  lift_column(col, t, st);
  for (int i = 0; i < t; ++i) out[base + (size_t)i * hw] = col[i * kTemporalThreads];
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

}  // namespace

// Forward: i16 volume (c, t, h, w) -> u8 symbols.  Scratch: tmp32 holds the
// W-lifted rows (c*t*h*w int32), tmp16 the spatially lifted volume (int16).
// split = 1 follows the TPU kernel's split spatial path (frames beyond its
// one-block budget, lift_kernels.py:267-291), which stores int16 between
// the W and H passes: the row pass then writes tmp16 and the column pass
// lifts tmp16 in place (tmp32 unused).  step / dead_zone: (c,) int32 on
// the device.  coeff / predict: host arrays of n forward steps.  Returns
// the first CUDA error of the launches.
extern "C" int alc_forward_quant(const void* vol, void* tmp32, void* tmp16,
                                 void* out, const void* step,
                                 const void* dead_zone, int c, int t, int h,
                                 int w, int n, const int* coeff,
                                 const int* predict, int split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Steps st = make_steps(n, coeff, predict, 0);
  size_t row_smem = (size_t)w * sizeof(int);
  size_t col_smem = (size_t)h * kStrip * sizeof(int);
  size_t t_smem = (size_t)t * kTemporalThreads * sizeof(int);
  dim3 row_grid((unsigned)((size_t)c * t * h));
  dim3 col_grid(cdiv(w, kStrip), c * t), col_block(kStrip, 16);
  int16_t* t16 = (int16_t*)tmp16;
  cudaError_t e;
  if ((e = allow_smem(temporal_quant, t_smem))) return e;
  if (split) {
    if ((e = allow_smem(row_lift<int16_t, int16_t>, row_smem))) return e;
    if ((e = allow_smem(col_lift<int16_t, int16_t>, col_smem))) return e;
    row_lift<int16_t, int16_t><<<row_grid, 256, row_smem, s>>>(
        (const int16_t*)vol, t16, w, st);
    if ((e = cudaGetLastError())) return e;
    col_lift<int16_t, int16_t><<<col_grid, col_block, col_smem, s>>>(
        t16, t16, h, w, st);
  } else {
    if ((e = allow_smem(row_lift<int16_t, int32_t>, row_smem))) return e;
    if ((e = allow_smem(col_lift<int32_t, int16_t>, col_smem))) return e;
    row_lift<int16_t, int32_t><<<row_grid, 256, row_smem, s>>>(
        (const int16_t*)vol, (int32_t*)tmp32, w, st);
    if ((e = cudaGetLastError())) return e;
    col_lift<int32_t, int16_t><<<col_grid, col_block, col_smem, s>>>(
        (const int32_t*)tmp32, t16, h, w, st);
  }
  if ((e = cudaGetLastError())) return e;
  temporal_quant<<<dim3(cdiv((size_t)h * w, kTemporalThreads), c),
                   kTemporalThreads, t_smem, s>>>(
      t16, (uint8_t*)out, (const int32_t*)step, (const int32_t*)dead_zone, t,
      h * w, st);
  return cudaGetLastError();
}

// Inverse: u8 symbols (c, t, h, w) -> i16 volume.  Scratch: tmp16 holds the
// temporal pass's int16 output, tmp32 the H-lifted columns (int32).  split
// = 1 stores int16 between the H and W passes, as the TPU kernel's split
// spatial path does: the column pass lifts tmp16 in place and the row
// pass reads it (tmp32 unused).  coeff / predict: host arrays of the n
// inverse steps in application order (negated coefficients for the compat
// inverse); sub = 1 for exact undo.
extern "C" int alc_inverse_dequant(const void* sym, void* tmp16, void* tmp32,
                                   void* out, const void* step, int c, int t,
                                   int h, int w, int n, const int* coeff,
                                   const int* predict, int sub, int split,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Steps st = make_steps(n, coeff, predict, sub);
  size_t row_smem = (size_t)w * sizeof(int);
  size_t col_smem = (size_t)h * kStrip * sizeof(int);
  size_t t_smem = (size_t)t * kTemporalThreads * sizeof(int);
  dim3 row_grid((unsigned)((size_t)c * t * h));
  dim3 col_grid(cdiv(w, kStrip), c * t), col_block(kStrip, 16);
  int16_t* t16 = (int16_t*)tmp16;
  cudaError_t e;
  if ((e = allow_smem(temporal_dequant, t_smem))) return e;
  temporal_dequant<<<dim3(cdiv((size_t)h * w, kTemporalThreads), c),
                     kTemporalThreads, t_smem, s>>>(
      (const uint8_t*)sym, t16, (const int32_t*)step, t, h * w, st);
  if ((e = cudaGetLastError())) return e;
  if (split) {
    if ((e = allow_smem(col_lift<int16_t, int16_t>, col_smem))) return e;
    if ((e = allow_smem(row_lift<int16_t, int16_t>, row_smem))) return e;
    col_lift<int16_t, int16_t><<<col_grid, col_block, col_smem, s>>>(
        t16, t16, h, w, st);
    if ((e = cudaGetLastError())) return e;
    row_lift<int16_t, int16_t><<<row_grid, 256, row_smem, s>>>(
        t16, (int16_t*)out, w, st);
  } else {
    if ((e = allow_smem(col_lift<int16_t, int32_t>, col_smem))) return e;
    if ((e = allow_smem(row_lift<int32_t, int16_t>, row_smem))) return e;
    col_lift<int16_t, int32_t><<<col_grid, col_block, col_smem, s>>>(
        t16, (int32_t*)tmp32, h, w, st);
    if ((e = cudaGetLastError())) return e;
    row_lift<int32_t, int16_t><<<row_grid, 256, row_smem, s>>>(
        (const int32_t*)tmp32, (int16_t*)out, w, st);
  }
  return cudaGetLastError();
}

// Plain forward: i32 volume (c, t, h, w) -> i32 coefficients, W then H then
// T.  The row pass writes out; the column and temporal passes lift out in
// place.  coeff / predict: host arrays of the n forward steps.
extern "C" int alc_forward_3d(const void* vol, void* out, int c, int t, int h,
                              int w, int n, const int* coeff,
                              const int* predict, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Steps st = make_steps(n, coeff, predict, 0);
  size_t row_smem = (size_t)w * sizeof(int);
  size_t col_smem = (size_t)h * kStrip * sizeof(int);
  size_t t_smem = (size_t)t * kTemporalThreads * sizeof(int);
  cudaError_t e;
  if ((e = allow_smem(row_lift<int32_t, int32_t>, row_smem))) return e;
  if ((e = allow_smem(col_lift<int32_t, int32_t>, col_smem))) return e;
  if ((e = allow_smem(temporal_lift, t_smem))) return e;
  int32_t* o = (int32_t*)out;
  row_lift<int32_t, int32_t><<<(unsigned)((size_t)c * t * h), 256, row_smem, s>>>(
      (const int32_t*)vol, o, w, st);
  if ((e = cudaGetLastError())) return e;
  col_lift<int32_t, int32_t><<<dim3(cdiv(w, kStrip), c * t), dim3(kStrip, 16),
                               col_smem, s>>>(o, o, h, w, st);
  if ((e = cudaGetLastError())) return e;
  temporal_lift<<<dim3(cdiv((size_t)h * w, kTemporalThreads), c),
                  kTemporalThreads, t_smem, s>>>(o, o, t, h * w, st);
  return cudaGetLastError();
}

// Plain inverse: i32 coefficients -> i32 volume, T then H then W (the
// temporal pass writes out, the others lift it in place).  coeff / predict:
// the n inverse steps in application order (negated coefficients for the
// compat inverse); sub = 1 for exact undo.
extern "C" int alc_inverse_3d(const void* coeffs, void* out, int c, int t,
                              int h, int w, int n, const int* coeff,
                              const int* predict, int sub, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Steps st = make_steps(n, coeff, predict, sub);
  size_t row_smem = (size_t)w * sizeof(int);
  size_t col_smem = (size_t)h * kStrip * sizeof(int);
  size_t t_smem = (size_t)t * kTemporalThreads * sizeof(int);
  cudaError_t e;
  if ((e = allow_smem(temporal_lift, t_smem))) return e;
  if ((e = allow_smem(col_lift<int32_t, int32_t>, col_smem))) return e;
  if ((e = allow_smem(row_lift<int32_t, int32_t>, row_smem))) return e;
  int32_t* o = (int32_t*)out;
  temporal_lift<<<dim3(cdiv((size_t)h * w, kTemporalThreads), c),
                  kTemporalThreads, t_smem, s>>>((const int32_t*)coeffs, o, t,
                                                 h * w, st);
  if ((e = cudaGetLastError())) return e;
  col_lift<int32_t, int32_t><<<dim3(cdiv(w, kStrip), c * t), dim3(kStrip, 16),
                               col_smem, s>>>(o, o, h, w, st);
  if ((e = cudaGetLastError())) return e;
  row_lift<int32_t, int32_t><<<(unsigned)((size_t)c * t * h), 256, row_smem, s>>>(
      o, o, w, st);
  return cudaGetLastError();
}
