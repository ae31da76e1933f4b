// Kernel K1 — the block tally of the block-expansion vote engine.
//
// Replaces the TPU kernel objective_slam_tpu/ops/voting_block.py `_tally`
// (Pallas body at voting_block.py:538-579, pallas_call at :590). That kernel
// builds one-hot int8 operands and contracts them on the MXU because
// scatters are slow on the TPU; this one computes the same histogram
// directly.
//
// What it computes: for every reference row r, the dense Hough tally
// out[r, m, a] (int32, shape (R, n_model, 32)) over the vote rows
// [row_start[r], row_start[r+1]) of the gathered pair words pp (the last
// row runs to the live row count, *total_rows; both ends are clipped to
// [0, min(*total_rows, row_cap)]). Rows past the live count hold only
// sentinels, so skipping them changes nothing; the TPU kernel skips those
// chunks too (voting_block.py:526-531, 547). Each word is
// m << 22 | α_m fixed point; alpha_row holds α_s of each vote row. The α bin
// is ((α_s − α_m + 2^21) mod 2^22) · n_angle >> 22, in int32 arithmetic,
// clipped to [0, 31] — bit-equal to the JAX package's _unpack_bin. Words
// whose m is >= n_model (the 0xFFFFFFFF sentinel decodes to m = 1023) are
// skipped. A row with no vote rows writes zeros.
//
// Design: one thread block per reference row, holding that row's
// n_model × 32 int32 histogram in shared memory (35,840 B at 280 model
// points; at most 1023 × 32 × 4 = 130,944 B, which needs the opt-in above
// 48 KB). The block streams its rows as 16-byte loads, decodes the four
// words of each in registers, adds with shared-memory atomics, and flushes
// the histogram to out[r] once. Integer atomics are order-independent, so
// the result is bit-equal to the plain torch version.
//
// What bounds it on an H100: reading the live rows of pp (4 B per vote
// slot: 421,376 live rows, 216 MB, at the bench scene) and the
// shared-memory atomics (one per vote). The 16-byte loads keep the read at
// full width; keeping each histogram in shared memory keeps the atomics
// off device memory; stopping at the live row count keeps the capacity's
// slack rows (up to a quarter of row_cap) from landing, serially, on the
// last row's block. The gather that writes pp could be fused into this
// kernel so that pp is never written (reading the model pair table by
// source row instead); that is later work.
//
// Built by objective_slam_tpu_torch/ops/_build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphaBits = 22;
constexpr uint32_t kAlphaMask = (1u << kAlphaBits) - 1u;
constexpr uint32_t kHalf = 1u << (kAlphaBits - 1);
constexpr int kAlphaPad = 32;
constexpr int kVecPerRow = 128 / 4;      // 128 words per vote row as uint4
constexpr int kThreads = 256;

__device__ __forceinline__ void tally_word(uint32_t w, uint32_t a_s,
                                           uint32_t n_model,
                                           uint32_t n_angle, int* hist) {
  const uint32_t m = w >> kAlphaBits;
  if (m >= n_model) return;
  const uint32_t d = (a_s - (w & kAlphaMask) + kHalf) & kAlphaMask;
  // int32 product and arithmetic shift, as the JAX int32 arithmetic does.
  int bin = static_cast<int>(d * n_angle) >> kAlphaBits;
  bin = min(max(bin, 0), kAlphaPad - 1);
  atomicAdd(&hist[m * kAlphaPad + bin], 1);
}

__global__ void __launch_bounds__(kThreads)
block_tally_kernel(const uint4* __restrict__ pp,
                   const int* __restrict__ alpha_row,
                   const int* __restrict__ row_start,
                   const int* __restrict__ total_rows, int R, int row_cap,
                   int n_model, int n_angle, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int r = blockIdx.x;
  const int cells = n_model * kAlphaPad;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int live = min(max(*total_rows, 0), row_cap);
  const int start = min(max(row_start[r], 0), live);
  const int end = r + 1 < R ? min(max(row_start[r + 1], 0), live) : live;
  const size_t v_end = static_cast<size_t>(max(end, start)) * kVecPerRow;
  for (size_t v = static_cast<size_t>(start) * kVecPerRow + threadIdx.x;
       v < v_end; v += blockDim.x) {
    const uint4 w = __ldg(pp + v);
    const uint32_t a_s =
        static_cast<uint32_t>(__ldg(alpha_row + v / kVecPerRow));
    tally_word(w.x, a_s, n_model, n_angle, hist);
    tally_word(w.y, a_s, n_model, n_angle, hist);
    tally_word(w.z, a_s, n_model, n_angle, hist);
    tally_word(w.w, a_s, n_model, n_angle, hist);
  }
  __syncthreads();

  int* dst = out + static_cast<size_t>(r) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = hist[i];
}

}  // namespace

// Launches the tally on `stream`; returns cudaGetLastError() as an int
// (0 on success). Pointers are device pointers: pp (row_cap, 128) int32
// (16-byte aligned), alpha_row (row_cap,) int32, row_start (R,) int32,
// total_rows (1,) int32, out (R, n_model, 32) int32. Allocates nothing and
// does not synchronise.
extern "C" int osn_block_tally(const void* pp, const void* alpha_row,
                               const void* row_start, const void* total_rows,
                               int R, int row_cap, int n_model, int n_angle,
                               void* out, void* stream) {
  const int smem = n_model * kAlphaPad * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_tally_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  block_tally_kernel<<<R, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(pp), static_cast<const int*>(alpha_row),
      static_cast<const int*>(row_start),
      static_cast<const int*>(total_rows), R, row_cap, n_model, n_angle,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
