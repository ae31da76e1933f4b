// Kernel K2 — the chunked tally of the fallback vote engine.
//
// Replaces the TPU kernel objective_slam_tpu/ops/voting_fast.py
// `_pallas_tally` (Pallas body at voting_fast.py:450-464, pallas_call at
// :466) together with the XLA combine that follows it (:478-487). That
// kernel contracts one-hot bf16 operands on the MXU into per-chunk partial
// histograms (n_chunks, m_pad, 32) in device memory, because scatters are
// slow on the TPU, and a cumsum over chunks then gives each reference row
// its tally. Here each chunk's histogram is added into its row directly.
//
// What it computes: out[r, m, a] (int32, shape (R, n_model, 32), zeroed by
// the caller) counts the votes v with vote_ok[v], v < min(*total_p,
// vote_cap), m = m_r[v] in [0, n_model) and a = a_bin[v] in [0, 32), where
// r owns v's chunk: the last r with row_start[r] / chunk <= v / chunk (the
// rule of _chunk_row_map; an empty row shares its start with the next row,
// and a start at or past the buffer's end owns nothing). A chunk before
// row 0's start belongs to no row. The buffer is row-aligned by
// construction, so every chunk lies in one row.
//
// Design: one thread block per chunk of `chunk` votes. A block whose chunk
// starts at or past the live count returns at once; the live count is read
// on the device, so the host never waits for it. Thread 0 finds the row by
// binary search over the non-decreasing row starts. With the shared-memory
// histogram (n_model <= 1792: n_model × 32 int32, 32,000 B at 250 model
// points, at most 229,376 B through the opt-in above 48 KB), the block adds
// its votes with shared atomics and then adds each nonzero bin into
// out[row] with one global atomic. Wider models add each vote straight into
// out[row] with a global atomic. Integer atomics are order-free, so either
// path is bit-equal to the plain torch version.
//
// What bounds it on an H100: reading m_r, a_bin and vote_ok of the live
// slots (9 B a slot; at the UWA-analog para model 76 M live slots, of which
// 41 M are row padding with vote_ok false) and writing the accumulator.
// The loads are coalesced 4-byte and 1-byte loads; padding slots skip the
// m_r/a_bin loads. Wider loads, and fusing the pair-table lookup so that
// m_r and a_bin are never written, are later work.
//
// Built by objective_slam_tpu_torch/ops/_build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphaPad = 32;
constexpr int kThreads = 256;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fast_tally_kernel(const int* __restrict__ m_r, const int* __restrict__ a_bin,
                  const uint8_t* __restrict__ vote_ok,
                  const int* __restrict__ row_start,
                  const int* __restrict__ total_p, int R,
                  long long vote_cap, int chunk, int n_model,
                  int* __restrict__ out) {
  extern __shared__ int hist[];
  __shared__ int row;
  const long long c = blockIdx.x;
  const long long v0 = c * chunk;
  const long long live =
      min(max(static_cast<long long>(*total_p), 0LL), vote_cap);
  if (v0 >= live) return;

  if (threadIdx.x == 0) {
    // Last r with row_start[r] / chunk <= c; -1 when there is none.
    int lo = 0, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      const int s = row_start[mid];
      const long long sc = s >= 0 ? s / chunk : -1;
      if (sc <= c) lo = mid + 1; else hi = mid;
    }
    row = lo - 1;
  }
  __syncthreads();
  const int r = row;
  if (r < 0) return;

  const int cells = n_model * kAlphaPad;
  int* dst = out + static_cast<size_t>(r) * cells;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = 0;
    __syncthreads();
  }

  const long long v_end = min(v0 + chunk, live);
  for (long long v = v0 + threadIdx.x; v < v_end; v += kThreads) {
    if (!vote_ok[v]) continue;
    const int m = __ldg(m_r + v);
    const int a = __ldg(a_bin + v);
    if (static_cast<unsigned>(m) < static_cast<unsigned>(n_model) &&
        static_cast<unsigned>(a) < static_cast<unsigned>(kAlphaPad)) {
      if (kShared) {
        atomicAdd(&hist[m * kAlphaPad + a], 1);
      } else {
        atomicAdd(&dst[m * kAlphaPad + a], 1);
      }
    }
  }

  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const int h = hist[i];
      if (h != 0) atomicAdd(&dst[i], h);
    }
  }
}

}  // namespace

// Launches the tally on `stream`; returns cudaGetLastError() as an int
// (0 on success). Pointers are device pointers: m_r, a_bin (vote_cap,)
// int32, vote_ok (vote_cap,) bool as bytes, row_start (R,) int32,
// total_p (1,) int32, out (R, n_model, 32) int32 already zeroed. chunk
// divides vote_cap. use_shared picks the shared-memory histogram (the
// caller passes it for n_model <= 1792). Allocates nothing and does not
// synchronise.
extern "C" int osn_fast_tally(const void* m_r, const void* a_bin,
                              const void* vote_ok, const void* row_start,
                              const void* total_p, int R,
                              long long vote_cap, int chunk, int n_model,
                              int use_shared, void* out, void* stream) {
  const long long n_chunks = vote_cap / chunk;
  if (n_chunks == 0) return 0;
  if (n_chunks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_chunks));
  const int* mr = static_cast<const int*>(m_r);
  const int* ab = static_cast<const int*>(a_bin);
  const uint8_t* ok = static_cast<const uint8_t*>(vote_ok);
  const int* rs = static_cast<const int*>(row_start);
  const int* tp = static_cast<const int*>(total_p);
  int* o = static_cast<int*>(out);
  if (use_shared) {
    const int smem = n_model * kAlphaPad * static_cast<int>(sizeof(int));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fast_tally_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    fast_tally_kernel<true><<<grid, kThreads, smem, s>>>(
        mr, ab, ok, rs, tp, R, vote_cap, chunk, n_model, o);
  } else {
    fast_tally_kernel<false><<<grid, kThreads, 0, s>>>(
        mr, ab, ok, rs, tp, R, vote_cap, chunk, n_model, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
