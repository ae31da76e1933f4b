// Kernel K1 — the block tally of the block-expansion vote engine, with the
// row gather fused in.
//
// Replaces the TPU kernel objective_slam_tpu/ops/voting_block.py `_tally`
// (Pallas body at voting_block.py:538-579, pallas_call at :590) together
// with the row gather before it (`jnp.take(pair2d, src_row)`, :421). The
// TPU kernel builds one-hot int8 operands and contracts them on the MXU
// because scatters are slow on the TPU; this one computes the same
// histogram directly.
//
// What it computes: for every reference row r, the dense Hough tally
// out[r, m, a] (int32, shape (R, n_model, 32)) over the vote rows
// t in [row_start[r], row_start[r+1]) (the last row runs to the live row
// count *total_rows; both ends are clipped to [0, min(*total_rows,
// row_cap)]) of the pair-table rows pair2d[src_row[t]]: 128 words each,
// m << 22 | α_m fixed point. alpha_row[t] holds α_s of vote row t. The α bin
// is osn::alpha_bin (row_hist.cuh). Words whose m is >= n_model (the
// 0xFFFFFFFF sentinel decodes to m = 1023) are skipped; padding vote rows
// name the all-sentinel row n_rows. A row with no vote rows writes zeros.
// src_row is read as given (the caller clips it on overflow); an index
// outside pair2d is clamped to it only to keep the read in bounds.
//
// Design: one thread-block cluster of C blocks per reference row
// (row_hist.cuh). The row's live vote rows are split evenly over the
// cluster's blocks, so a heavy row spreads over C SMs. In a block, each warp
// takes every eighth vote row: lane l first fetches src_row/alpha_row of
// the warp's l-th next row, then for each row the warp broadcasts them and
// reads the 512-byte pair row as 32 lanes × 16 bytes (four rows in flight),
// decodes four words a lane and adds them into the block's shared
// n_model × 32 histogram (at most 1023 × 32 × 4 = 130,944 B). The cluster
// then sums its histograms through distributed shared memory and stores
// the row once. Integer adds are order-free, so the result is bit-equal to
// the plain torch version.
//
// What bounds it on an H100: the bytes the function must move are small
// (src_row and alpha_row of the live rows, pair2d once, the accumulator
// once: about 26 MB at the bench scene), but every vote row re-reads its
// 512-byte pair row from the L2 cache (216 MB at the bench scene; pair2d is
// a few MB and stays in L2), and every vote costs one shared-memory atomic.
// The gathered copy pp (row_cap × 512 B) is never written.
//
// Built by objective_slam_tpu_torch/ops/_build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded with ctypes.

#include "row_hist.cuh"

namespace {

using osn::kAlphaBits;
using osn::kAlphaPad;
using osn::kThreads;

constexpr int kVecPerRow = 128 / 4;      // 128 words per vote row as uint4
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;             // pair rows loaded ahead per warp

__device__ __forceinline__ void tally_word(uint32_t w, uint32_t a_s,
                                           uint32_t n_model,
                                           uint32_t n_angle, int* hist) {
  const uint32_t m = w >> kAlphaBits;
  if (m >= n_model) return;
  atomicAdd(&hist[m * kAlphaPad + osn::alpha_bin(a_s, w & osn::kAlphaMask,
                                                  n_angle)], 1);
}

__global__ void __launch_bounds__(kThreads)
block_tally_kernel(const uint4* __restrict__ pair2d, int n_pair_rows,
                   const int* __restrict__ src_row,
                   const int* __restrict__ alpha_row,
                   const int* __restrict__ row_start,
                   const int* __restrict__ total_rows, int R, int row_cap,
                   int n_model, int n_angle, int cluster,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) int hist[];
  const int r = static_cast<int>(blockIdx.x) / cluster;
  const int part = static_cast<int>(blockIdx.x) % cluster;
  const int cells = n_model * kAlphaPad;
  for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int live = min(max(*total_rows, 0), row_cap);
  const int start = min(max(row_start[r], 0), live);
  const int end = max(r + 1 < R ? min(max(row_start[r + 1], 0), live) : live,
                      start);
  const long long len = end - start;
  const int t0 = start + static_cast<int>(len * part / cluster);
  const int t1 = start + static_cast<int>(len * (part + 1) / cluster);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The warp's vote rows are base, base + kWarps, ...: 32 of them a batch.
  for (int base = t0 + warp; base < t1; base += 32 * kWarps) {
    const int t_l = base + lane * kWarps;
    int src = 0;
    uint32_t a_s = 0;
    if (t_l < t1) {
      src = min(max(__ldg(src_row + t_l), 0), n_pair_rows - 1);
      a_s = static_cast<uint32_t>(__ldg(alpha_row + t_l));
    }
    const int n_here = min(32, (t1 - base + kWarps - 1) / kWarps);
    for (int j = 0; j < n_here; j += kInFlight) {
      uint4 w[kInFlight];
      uint32_t a[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        // Past n_here the warp reloads its last row and does not tally it.
        const int jj = min(j + u, n_here - 1);
        const int s = __shfl_sync(0xFFFFFFFFu, src, jj);
        a[u] = __shfl_sync(0xFFFFFFFFu, a_s, jj);
        w[u] = __ldg(pair2d + static_cast<size_t>(s) * kVecPerRow + lane);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (j + u >= n_here) break;
        tally_word(w[u].x, a[u], n_model, n_angle, hist);
        tally_word(w[u].y, a[u], n_model, n_angle, hist);
        tally_word(w[u].z, a[u], n_model, n_angle, hist);
        tally_word(w[u].w, a[u], n_model, n_angle, hist);
      }
    }
  }
  __syncthreads();
  osn::cluster_store_row(hist, cells, cluster,
                         out + static_cast<size_t>(r) * cells);
}

}  // namespace

// Launches the tally on `stream` with one cluster of `cluster` blocks (1 to
// 8) per reference row; returns 0, a CUDA error code, or -1 when no such
// cluster fits the card. Pointers are device pointers: pair2d
// (n_pair_rows, 128) int32 (16-byte aligned), src_row and alpha_row
// (row_cap,) int32, row_start (R,) int32, total_rows (1,) int32, out
// (R, n_model, 32) int32, every row of which is written. Allocates nothing
// and does not synchronise.
extern "C" int osn_block_tally(const void* pair2d, int n_pair_rows,
                               const void* src_row, const void* alpha_row,
                               const void* row_start, const void* total_rows,
                               int R, int row_cap, int n_model, int n_angle,
                               int cluster, void* out, void* stream) {
  const int smem = n_model * kAlphaPad * static_cast<int>(sizeof(int));
  return osn::launch_rows(
      block_tally_kernel, R, cluster, smem, static_cast<cudaStream_t>(stream),
      static_cast<const uint4*>(pair2d), n_pair_rows,
      static_cast<const int*>(src_row), static_cast<const int*>(alpha_row),
      static_cast<const int*>(row_start),
      static_cast<const int*>(total_rows), R, row_cap, n_model, n_angle,
      cluster, static_cast<int*>(out));
}

extern "C" const char* osn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
