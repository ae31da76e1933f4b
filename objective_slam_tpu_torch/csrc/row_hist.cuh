// Shared pieces of kernels K1 (block_tally.cu) and K2 (fast_tally.cu): the
// α-bin rule, the cluster reduction that stores one reference row of the
// accumulator, and the cluster launch.
//
// Both kernels give each reference row r one thread-block cluster of C
// blocks (1 <= C <= 8). Every block of the cluster tallies its share of the
// row's votes into its own n_model × 32 int32 histogram in shared memory;
// then block b sums slice b of all C histograms through distributed shared
// memory and stores it to out[r] with plain coalesced 16-byte stores. Every
// row, an empty one included, is written exactly once, so the output needs
// no zeroing and the flush needs no global atomics.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace osn {

namespace cg = cooperative_groups;

constexpr int kAlphaBits = 22;
constexpr uint32_t kAlphaMask = (1u << kAlphaBits) - 1u;
constexpr uint32_t kHalf = 1u << (kAlphaBits - 1);
constexpr int kAlphaPad = 32;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;          // the portable cluster size
// Returned by launch_rows when no cluster of the asked shape fits an SM
// group (a CUDA error code is positive).
constexpr int kErrNoClusterFits = -1;

// α bin of a vote: ((α_s − α_m + 2^21) mod 2^22) · n_angle >> 22 in int32
// arithmetic (the product wraps as the JAX package's int32 product does,
// the shift is arithmetic), clipped to [0, 31]. Bit-equal to the JAX
// package's _unpack_bin and to the fallback engine's integer binning.
__device__ __forceinline__ int alpha_bin(uint32_t a_s, uint32_t a_m,
                                         uint32_t n_angle) {
  const uint32_t d = (a_s - a_m + kHalf) & kAlphaMask;
  const int bin = static_cast<int>(d * n_angle) >> kAlphaBits;
  return min(max(bin, 0), kAlphaPad - 1);
}

// Sums slice `rank` of the cluster's `cells`-int histograms (cells a
// multiple of 4, each histogram 16-byte aligned) and stores it to
// dst[slice]. The first cluster.sync() waits until every block of the
// cluster has finished its tally; the second keeps each block resident
// until the others have read its shared memory.
__device__ __forceinline__ void cluster_store_row(const int* hist, int cells,
                                                  int n_blocks,
                                                  int* __restrict__ dst) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();
  const int vecs = cells / 4;
  const int lo = static_cast<int>(static_cast<long long>(vecs) * rank /
                                  n_blocks);
  const int hi = static_cast<int>(static_cast<long long>(vecs) * (rank + 1) /
                                  n_blocks);
  int4* out = reinterpret_cast<int4*>(dst);
  for (int i = lo + static_cast<int>(threadIdx.x); i < hi;
       i += static_cast<int>(blockDim.x)) {
    int4 s = make_int4(0, 0, 0, 0);
    for (int q = 0; q < n_blocks; ++q) {
      const int4 v = reinterpret_cast<const int4*>(
          cluster.map_shared_rank(const_cast<int*>(hist), q))[i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
  cluster.sync();
}

// Launches `kernel` over R reference rows with one cluster of `cluster`
// blocks each (grid R · cluster, kThreads threads a block, `smem` bytes of
// dynamic shared memory). Raises the kernel's shared-memory limit when it
// needs more than 48 KB and checks first that at least one such cluster
// fits the card. Returns 0, a CUDA error code, or kErrNoClusterFits.
template <typename... Params, typename... Args>
int launch_rows(void (*kernel)(Params...), int R, int cluster, int smem,
                cudaStream_t stream, Args... args) {
  if (R <= 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R) * static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fits = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fits < 1) return kErrNoClusterFits;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace osn
