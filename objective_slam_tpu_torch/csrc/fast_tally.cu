// Kernel K2 — the tally of the fallback vote engine, with its per-vote
// expansion fused in.
//
// Replaces the TPU kernel objective_slam_tpu/ops/voting_fast.py
// `_pallas_tally` (Pallas body at voting_fast.py:450-464, pallas_call at
// :466) and the XLA combine after it (:478-487), together with the
// per-vote expansion before it (the segment fills and the per-vote pair
// lookup, :296-355). The TPU kernel contracts one-hot bf16 operands of
// per-vote arrays over the whole vote buffer on the MXU; this one walks the
// scene pairs and never writes a per-vote array.
//
// What it computes: out[r, m, a] (int32, shape (R, n_model, 32)). Scene
// pair s = r·n + i of reference row r has cnt[s] votes, its bucket's first
// pair at off[s] and α_s fixed point alpha_fix[s]. Its vote j (j < cnt[s])
// sits at buffer slot heads[s] + j, where heads[s] = row_start[r] + the
// votes of the row's earlier pairs; it is counted iff that slot is below
// vote_cap. A counted vote reads the pair-table entry at
// clamp(off[s] + j, 0, table_len − 1): the packed word m << 22 | α_m, or
// (unpacked tables) m from pair_mr and α_m = round-half-even((a + π) ·
// scale) in float32, clipped to [0, 2^22 − 1]. m outside [0, n_model) is
// skipped; the bin is osn::alpha_bin (row_hist.cuh). This is what the
// plain per-slot route (segment fills, then the chunked tally) counts.
//
// Design: one thread-block cluster of C blocks per reference row
// (row_hist.cuh); the row's n scene pairs are split evenly over the
// cluster's blocks. A block walks its pairs in tiles of 1,024 (four a
// thread): it takes the exclusive block scan (cub::BlockScan) of the tile's
// counts into shared memory, with the offset and α_s of the pairs that
// have votes, and splits the tile's votes evenly over its threads, each
// taking a contiguous run and finding its pairs by binary search in the
// scan. So a bucket of thousands of pairs does not stall one thread. A
// thread has four table reads in flight, and the loads of the next two
// tiles are in flight meanwhile. Only the row that straddles vote_cap needs the
// row-level prefix of a block's first pair; its blocks sum the counts
// before their share. With the shared-memory histogram (n_model <= 1712;
// the tile's arrays take 12 KB of the 227 KB) the cluster then sums its
// histograms and stores the row once (no zeroing, no global atomics).
// Wider models add each vote to out[r] with a global atomic, into an
// output the caller zeroed.
//
// What bounds it on an H100: reading cnt (4 B per scene pair; 24.9 M pairs
// at the UWA-analog para model), off and alpha_fix of the pairs with votes,
// and writing the accumulator (159.7 MB at para). Every vote also reads one
// pair-table word from the L2 cache (the table is 249 KB at para) and makes
// one shared-memory atomic. The per-vote arrays of the plain route
// (84 M slots at para) are never written.
//
// Built by objective_slam_tpu_torch/ops/_build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded with ctypes.

#include <cub/block/block_scan.cuh>

#include "row_hist.cuh"

namespace {

using osn::kAlphaBits;
using osn::kAlphaMask;
using osn::kAlphaPad;
using osn::kThreads;

constexpr int kItems = 4;                // scene pairs a thread loads
constexpr int kTile = kThreads * kItems;  // scene pairs a tile
constexpr int kVotes = 4;                // table reads a thread has in flight

using BlockScan = cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;

// Counts of the tile's pairs [t0, t0 + kTile) ∩ [.., p1): thread t holds
// pairs t0 + kItems·t + k (the blocked order of the block scan).
__device__ __forceinline__ void load_counts(const int* __restrict__ cnt,
                                            long long t0, long long p1,
                                            int (&c)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = t0 + kItems * static_cast<long long>(threadIdx.x) + k;
    c[k] = i < p1 ? __ldg(cnt + i) : 0;
  }
}

// Offset and α_s of the tile's pairs that have votes (the others are not
// read: most scene pairs have none).
__device__ __forceinline__ void load_pairs(const int* __restrict__ off,
                                           const int* __restrict__ alpha_fix,
                                           long long t0, const int (&c)[kItems],
                                           int (&o)[kItems], int (&a)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = t0 + kItems * static_cast<long long>(threadIdx.x) + k;
    o[k] = c[k] > 0 ? __ldg(off + i) : 0;
    a[k] = c[k] > 0 ? __ldg(alpha_fix + i) : 0;
  }
}

template <bool kShared, bool kPacked>
__global__ void __launch_bounds__(kThreads)
fast_tally_kernel(const int* __restrict__ cnt, const int* __restrict__ off,
                  const int* __restrict__ alpha_fix,
                  const int* __restrict__ row_start,
                  const int* __restrict__ row_tot,
                  const int* __restrict__ pair_packed,
                  const int* __restrict__ pair_mr,
                  const float* __restrict__ pair_alpha, int table_len, int n,
                  long long vote_cap, int n_model, int n_angle, float pi_f,
                  float scale_f, int cluster, int* __restrict__ out) {
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int s_ex[kTile + 1];   // exclusive scan of the tile's counts
  __shared__ int s_off[kTile];      // offset and α_s of pairs with votes
  __shared__ int s_alpha[kTile];
  extern __shared__ __align__(16) int hist[];
  const int r = static_cast<int>(blockIdx.x) / cluster;
  const int part = static_cast<int>(blockIdx.x) % cluster;
  const int cells = n_model * kAlphaPad;
  int* dst = out + static_cast<size_t>(r) * cells;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = 0;
    __syncthreads();
  }

  const long long row0 = row_start[r];
  const long long first = static_cast<long long>(r) * n;
  const long long p0 = first + static_cast<long long>(n) * part / cluster;
  const long long p1 = first + static_cast<long long>(n) * (part + 1) / cluster;
  // Votes of the row at a row index >= limit lie at or past vote_cap.
  const long long limit = vote_cap - row0;
  const bool straddles = row0 + row_tot[r] > vote_cap;
  long long base = 0;           // row index of the block's next vote
  if (limit > 0 && straddles && part > 0) {
    int partial = 0;
    for (long long i = first + threadIdx.x; i < p0; i += kThreads)
      partial += __ldg(cnt + i);
    int ex, before;
    BlockScan(scan_tmp).ExclusiveSum(partial, ex, before);
    base = before;
    __syncthreads();            // scan_tmp is reused below
  }

  // A pipeline of tiles: while the votes of one tile are added, the
  // offsets and α_s of the next and the counts of the one after are in
  // flight.
  int c[kItems], o[kItems], a[kItems], c_next[kItems];
  if (limit > 0) {
    load_counts(cnt, p0, p1, c);
    load_pairs(off, alpha_fix, p0, c, o, a);
    load_counts(cnt, p0 + kTile, p1, c_next);
  }
  for (long long t0 = p0; limit > 0 && t0 < p1; t0 += kTile) {
    if (straddles && base >= limit) break;
    int ex[kItems], tile;
    BlockScan(scan_tmp).ExclusiveSum(c, ex, tile);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = kItems * static_cast<int>(threadIdx.x) + k;
      s_ex[j] = ex[k];
      if (c[k] > 0) {
        s_off[j] = o[k];
        s_alpha[j] = a[k];
      }
    }
    if (threadIdx.x == 0) s_ex[kTile] = tile;
    __syncthreads();
    int c_after[kItems];
    load_pairs(off, alpha_fix, t0 + kTile, c_next, o, a);
    load_counts(cnt, t0 + 2 * kTile, p1, c_after);

    const int n_votes = straddles
        ? static_cast<int>(min(static_cast<long long>(tile), limit - base))
        : tile;
    // Thread t adds the tile's votes [t·per, (t+1)·per) in order, kVotes
    // at a time: it searches for a vote's pair only when it leaves the
    // previous pair, its table reads walk the bucket, and the lanes of a
    // warp work far apart in the tile, so their adds seldom meet on one
    // histogram cell.
    const int per = (n_votes + kThreads - 1) / kThreads;
    int v = min(static_cast<int>(threadIdx.x) * per, n_votes);
    const int v_end = min(v + per, n_votes);
    int lo = 0, seg_end = 0;    // the current pair and the end of its votes
    while (v < v_end) {
      int pair[kVotes], slot[kVotes];
#pragma unroll
      for (int u = 0; u < kVotes; ++u) {
        if (v + u < v_end && v + u >= seg_end) {
          // The tile's pair holding the vote: the last with s_ex <= it (it
          // has votes, since the next one's s_ex is past it).
          int l = lo, h = kTile - 1;
          while (l < h) {
            const int mid = (l + h + 1) >> 1;
            if (s_ex[mid] <= v + u) l = mid; else h = mid - 1;
          }
          lo = l;
          seg_end = s_ex[l + 1];
        }
        pair[u] = lo;
        slot[u] = min(max(s_off[lo] + (v + u - s_ex[lo]), 0), table_len - 1);
      }
      uint32_t m[kVotes], a_m[kVotes];
#pragma unroll
      for (int u = 0; u < kVotes; ++u) {
        if (kPacked) {
          const uint32_t w =
              static_cast<uint32_t>(__ldg(pair_packed + slot[u]));
          m[u] = w >> kAlphaBits;
          a_m[u] = w & kAlphaMask;
        } else {
          m[u] = static_cast<uint32_t>(__ldg(pair_mr + slot[u]));
          // Written out so that the compiler cannot contract it into an
          // FMA: the plain version rounds the sum, then the product.
          const int q = __float2int_rn(__fmul_rn(
              __fadd_rn(__ldg(pair_alpha + slot[u]), pi_f), scale_f));
          a_m[u] = static_cast<uint32_t>(
              min(max(q, 0), static_cast<int>(kAlphaMask)));
        }
      }
#pragma unroll
      for (int u = 0; u < kVotes; ++u) {
        if (v + u >= v_end || m[u] >= static_cast<uint32_t>(n_model))
          continue;
        const int cell = static_cast<int>(m[u]) * kAlphaPad +
            osn::alpha_bin(static_cast<uint32_t>(s_alpha[pair[u]]), a_m[u],
                           static_cast<uint32_t>(n_angle));
        if (kShared) {
          atomicAdd(&hist[cell], 1);
        } else {
          atomicAdd(&dst[cell], 1);
        }
      }
      v += kVotes;
    }
    base += tile;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      c[k] = c_next[k];
      c_next[k] = c_after[k];
    }
    __syncthreads();            // the tile's shared arrays are reused next
  }

  if (kShared) {
    __syncthreads();
    osn::cluster_store_row(hist, cells, cluster, dst);
  }
}

template <bool kPacked>
int launch(bool use_shared, int R, int cluster, cudaStream_t stream,
           const int* cnt, const int* off, const int* alpha_fix,
           const int* row_start, const int* row_tot, const int* pair_packed,
           const int* pair_mr, const float* pair_alpha, int table_len, int n,
           long long vote_cap, int n_model, int n_angle, float pi_f,
           float scale_f, int* out) {
  if (use_shared) {
    const int smem = n_model * kAlphaPad * static_cast<int>(sizeof(int));
    return osn::launch_rows(fast_tally_kernel<true, kPacked>, R, cluster, smem,
                            stream, cnt, off, alpha_fix, row_start, row_tot,
                            pair_packed, pair_mr, pair_alpha, table_len, n,
                            vote_cap, n_model, n_angle, pi_f, scale_f, cluster,
                            out);
  }
  // Global-atomic path: no cluster is needed, the blocks of a row share
  // nothing but `out`.
  if (R <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(R) * static_cast<unsigned>(cluster));
  fast_tally_kernel<false, kPacked><<<grid, kThreads, 0, stream>>>(
      cnt, off, alpha_fix, row_start, row_tot, pair_packed, pair_mr,
      pair_alpha, table_len, n, vote_cap, n_model, n_angle, pi_f, scale_f,
      cluster, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the tally on `stream`; returns 0, a CUDA error code, or -1 when
// no cluster of the asked shape fits the card. Pointers are device
// pointers: cnt, off, alpha_fix (R·n,) int32; row_start, row_tot (R,)
// int32; either pair_packed (table_len,) int32 (pair_mr and pair_alpha
// null) or pair_mr (table_len,) int32 and pair_alpha (table_len,) float32;
// out (R, n_model, 32) int32. use_shared picks the shared-memory histogram
// (the caller passes it for n_model <= 1712), which writes every row of
// out; the global-atomic path adds into an out the caller zeroed. cluster
// (1 to 8) blocks share each reference row. pi_f and scale_f are the
// float32 constants of the unpacked α_m rounding. Allocates nothing and
// does not synchronise.
extern "C" int osn_fast_tally(const void* cnt, const void* off,
                              const void* alpha_fix, const void* row_start,
                              const void* row_tot, const void* pair_packed,
                              const void* pair_mr, const void* pair_alpha,
                              int table_len, int R, int n,
                              long long vote_cap, int n_model, int n_angle,
                              float pi_f, float scale_f, int use_shared,
                              int cluster, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int*>(cnt);
  const auto* o = static_cast<const int*>(off);
  const auto* a = static_cast<const int*>(alpha_fix);
  const auto* rs = static_cast<const int*>(row_start);
  const auto* rt = static_cast<const int*>(row_tot);
  const auto* pk = static_cast<const int*>(pair_packed);
  const auto* pm = static_cast<const int*>(pair_mr);
  const auto* pa = static_cast<const float*>(pair_alpha);
  auto* dst = static_cast<int*>(out);
  if (pk != nullptr)
    return launch<true>(use_shared != 0, R, cluster, s, c, o, a, rs, rt, pk,
                        pm, pa, table_len, n, vote_cap, n_model, n_angle,
                        pi_f, scale_f, dst);
  return launch<false>(use_shared != 0, R, cluster, s, c, o, a, rs, rt, pk,
                       pm, pa, table_len, n, vote_cap, n_model, n_angle, pi_f,
                       scale_f, dst);
}

extern "C" const char* osn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
