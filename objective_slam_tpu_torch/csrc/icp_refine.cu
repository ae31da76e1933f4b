// ICP refinement in one launch: every iteration of ops/icp.refine_pose
// (nearest scan point, distance and normal gate, Kabsch or point-to-plane
// step, pose update) with the pose kept on chip.
//
// Replaces no TPU kernel: the JAX package leaves ICP to XLA
// (objective_slam_tpu/ops/icp.py:refine_pose). The port's plain loop
// (ops/icp.refine_pose_plain) issues about 82 small launches an iteration
// and waits on the host for each; this kernel issues one for the whole
// refinement and reads nothing back to the host.
//
// What it computes, for i = 0 .. iterations − 1 from T = T0 (float32):
//   mt = m Rᵀ + t; nn = argmin_j d²(j), d² = ‖mt‖² + ‖s_j‖² − 2 mt·s_j, the
//   first j on ties, d² = +∞ where valid[j] is 0; w = d² < max_sq, times
//   (R·mn)·unit(sn[nn]) > cos_thresh when both normal sets are given;
//   wsum = max(Σw, 1). For i < n_point_iters the weighted Kabsch step, in
//   the centred two-pass form: cm = Σw·mt / wsum, cs = Σw·s[nn] / wsum,
//   H = Σ w (mt − cm)(s[nn] − cs)ᵀ, R = V diag(1, 1, det(V Uᵀ)) Uᵀ from a
//   one-sided Jacobi SVD (kabsch_rotation; ops/icp.kabsch_rotation is its
//   torch twin), t = cs − R cm. Later iterations solve the point-to-plane
//   normal equations (JwᵀJ + 1e-6·I) δ = −Jwᵀr with partial pivoting, clamp
//   the rotation to kOmegaMax rad and lift it by Rodrigues. Then T = dT·T.
//   rms = sqrt(Σ w d² / wsum) and inliers = Σw of the last iteration.
//
// Design: a cooperative grid, one or two blocks an SM, sized from n_m·n_s
// (about kPairsPerBlock point pairs a block). Work items are (32 model
// points) × (a chunk of the scan). A warp holds four model points in
// registers; the block streams its chunk through shared memory in tiles of
// kScanTile points (x, y, z, ‖s‖² with +∞ for invalid points) and each lane
// keeps its running minimum. A (d², index) pair packs into one 64-bit key
// whose order is (d², index), so the warp's minimum is a shuffle reduction
// and the chunks meet in one atomicMin a model point: the first index wins
// a tie, as in the plain loop. After a grid barrier every block reads all
// n_m keys and solves the step itself, from the same data in the same
// order, so all blocks hold the same pose and an iteration needs one
// barrier. The keys rotate over three buffers of n_m, so the buffer a block
// resets was read before the last barrier and is written after the next.
// The centred Kabsch pass rebuilds each correspondence from its key, as the
// first pass built it, rather than keeping it: shared memory holds the scan
// tile and the reductions alone (17.6 KB a block), whatever the model's size.
//
// What bounds it on an H100: the n_m·n_s distance evaluations, 8 float32
// operations each, an FMA counted as two (26 M pairs an iteration at
// 1,000 × 26,000); the scan streams from the L2 cache. At small n_m·n_s the
// serial part bounds it: the barrier, the gathers of the n_m
// correspondences and one thread's 3 × 3 SVD or 6 × 6 solve an iteration.
//
// Built by objective_slam_tpu_torch/ops/_build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded with ctypes.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 4;                       // model points a warp holds
constexpr int kModelTile = kWarps * kPerWarp;     // model points a work item
constexpr int kScanTile = 1024;                   // scan points a smem tile
constexpr int kMaxBlocksPerSM = 2;
constexpr long long kPairsPerBlock = 16384;
constexpr int kMinChunk = 256;
constexpr int kRed = 32;                          // widest block reduction
constexpr int kSweeps = 12;
constexpr float kJacobiTol = 1e-7f;
constexpr float kRankTol = 1e-6f;
constexpr float kOmegaMax = 0.02f;                // ops/icp._OMEGA_MAX
constexpr unsigned long long kNoKey = ~0ull;
// Returned when no block of this kernel fits an SM (a CUDA error is > 0).
constexpr int kErrNoBlockFits = -1;

struct Params {
  const float* m;               // (n_m, 3) contiguous
  const float* mn;              // (n_m, 3) contiguous, or null
  const float* s;               // n_s rows of 3, row stride s_stride
  const float* sn;              // n_s rows of 3, row stride sn_stride, or null
  const unsigned char* valid;   // (n_s,) 0/1, or null
  const float* T0;              // (4, 4) contiguous
  unsigned long long* keys;     // (3, n_m) workspace
  float* out;                   // pose (16), rms, inliers (int32 bits)
  int n_m, n_s, s_stride, sn_stride;
  float max_sq, cos_thresh;
  int iterations, n_point_iters, gate;
  int n_mtiles, n_chunks, chunk_len;
};

// Order-preserving map of a float32 to uint32 (−0 taken as +0).
__device__ __forceinline__ unsigned int ordered(float f) {
  const unsigned int u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// The float32 operations below round as the plain loop's operations round
// on the card (measured against torch and cuBLAS on an H100): a product
// with K = 3 is one FMA chain over k = 0, 1, 2; torch.sum over three
// elements adds (e0 + e2) + e1. The nearest neighbour and the gates then
// see the plain loop's bits whenever the pose is the same: a tie between two
// scan points within a rounding of ‖mt‖² + ‖s‖² goes the same way.
// __fmul_rn and __fadd_rn keep nvcc from fusing what torch rounds apart.

// x0·w0 + x1·w1 + x2·w2 as a K = 3 product rounds it.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float w0,
                                      float w1, float w2) {
  return __fmaf_rn(x2, w2, __fmaf_rn(x1, w1, __fmul_rn(x0, w0)));
}

// e0 + e1 + e2 as torch.sum over three elements adds it.
__device__ __forceinline__ float sum3(float e0, float e1, float e2) {
  return __fadd_rn(__fadd_rn(e0, e2), e1);
}

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return sum3(__fmul_rn(x, x), __fmul_rn(y, y), __fmul_rn(z, z));
}

// mt = T[:3, :3] · p + T[:3, 3], as m @ Rᵀ + t rounds it.
__device__ __forceinline__ void transform(const float* T, float x, float y,
                                          float z, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = __fadd_rn(dot3(x, y, z, T[4 * r], T[4 * r + 1], T[4 * r + 2]),
                     T[4 * r + 3]);
}

// Sums v[0 .. K) over the block into tot[0 .. K); every block sums in the
// same fixed order, so all blocks get the same bits.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * kRed + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kRed + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// One Jacobi rotation of columns P and Q of a (and v); false if they are
// orthogonal already.
template <int P, int Q>
__device__ __forceinline__ bool jacobi_pair(float (&a)[3][3],
                                            float (&v)[3][3]) {
  float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    alpha += a[i][P] * a[i][P];
    beta += a[i][Q] * a[i][Q];
    gamma += a[i][P] * a[i][Q];
  }
  if (!(fabsf(gamma) > kJacobiTol * sqrtf(alpha * beta))) return false;
  const float zeta = (beta - alpha) / (2.0f * gamma);
  const float t = copysignf(1.0f, zeta) /
                  (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float sn = c * t;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float x = a[i][P], y = a[i][Q];
    a[i][P] = c * x - sn * y;
    a[i][Q] = sn * x + c * y;
    const float vx = v[i][P], vy = v[i][Q];
    v[i][P] = c * vx - sn * vy;
    v[i][Q] = sn * vx + c * vy;
  }
  return true;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// The Kabsch rotation of a 3 × 3 correlation H (row-major): with
// H = U S Vᵀ, R = V diag(1, 1, det(V Uᵀ)) Uᵀ (row-major), the identity for
// H = 0. One-sided Jacobi SVD of H scaled to a largest entry of 1: the
// columns of A = H V are made orthogonal, S holds their norms, U their
// directions. U's second column is taken orthogonal to its first, its third
// is their cross product, so U is a rotation for a rank-deficient H too and
// the sign lands on the smallest singular value. ops/icp.kabsch_rotation
// is the torch twin.
__device__ void kabsch_rotation(const float* H, float* R) {
  float scale = 0.0f;
  for (int i = 0; i < 9; ++i) scale = fmaxf(scale, fabsf(H[i]));
  if (!(scale > 0.0f)) {
    for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0) ? 1.0f : 0.0f;
    return;
  }
  float a[3][3], v[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a[i][j] = H[3 * i + j] / scale;
      v[i][j] = (i == j) ? 1.0f : 0.0f;
    }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = jacobi_pair<0, 1>(a, v);
    rotated |= jacobi_pair<0, 2>(a, v);
    rotated |= jacobi_pair<1, 2>(a, v);
    if (!rotated) break;
  }
  float sig[3];
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrtf(a[0][j] * a[0][j] + a[1][j] * a[1][j] + a[2][j] * a[2][j]);
  int o[3] = {0, 1, 2};   // columns by singular value, largest first
  if (sig[o[1]] > sig[o[0]]) { int t = o[0]; o[0] = o[1]; o[1] = t; }
  if (sig[o[2]] > sig[o[1]]) { int t = o[1]; o[1] = o[2]; o[2] = t; }
  if (sig[o[1]] > sig[o[0]]) { int t = o[0]; o[0] = o[1]; o[1] = t; }
  float u0[3], u1[3], u2[3], v0[3], v1[3], v2[3];
  for (int i = 0; i < 3; ++i) {
    u0[i] = a[i][o[0]] / sig[o[0]];
    u1[i] = a[i][o[1]];
    v0[i] = v[i][o[0]];
    v1[i] = v[i][o[1]];
    v2[i] = v[i][o[2]];
  }
  const float p = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
  for (int i = 0; i < 3; ++i) u1[i] -= p * u0[i];
  float n1 = sqrtf(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  if (!(n1 > kRankTol * sig[o[0]])) {
    // Rank 1: any direction orthogonal to u0 (the axis u0 leans on least).
    int k = 0;
    for (int i = 1; i < 3; ++i)
      if (fabsf(u0[i]) < fabsf(u0[k])) k = i;
    for (int i = 0; i < 3; ++i) u1[i] = ((i == k) ? 1.0f : 0.0f) - u0[k] * u0[i];
    n1 = sqrtf(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  }
  for (int i = 0; i < 3; ++i) u1[i] /= n1;
  cross3(u0, u1, u2);
  float c12[3];
  cross3(v1, v2, c12);
  const float d = (v0[0] * c12[0] + v0[1] * c12[1] + v0[2] * c12[2]) < 0.0f
                      ? -1.0f : 1.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = v0[i] * u0[j] + v1[i] * u1[j] + d * v2[i] * u2[j];
}

// The point-to-plane increment from A (6 × 6, with the 1e-6 ridge) and
// rhs b: Gaussian elimination with partial pivoting, the se(3) step
// clamped to kOmegaMax, ω lifted by Rodrigues (ops/icp._solve_plane).
__device__ void plane_step(float (&A)[6][6], float (&b)[6], float* R,
                           float* t) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[r][c]) > fabsf(A[piv][c])) piv = r;
    if (piv != c) {
      for (int k = 0; k < 6; ++k) {
        const float x = A[c][k]; A[c][k] = A[piv][k]; A[piv][k] = x;
      }
      const float x = b[c]; b[c] = b[piv]; b[piv] = x;
    }
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
      for (int k = c; k < 6; ++k) A[r][k] -= f * A[c][k];
      b[r] -= f * b[c];
    }
  }
  float x[6];
  for (int r = 5; r >= 0; --r) {
    float s = b[r];
    for (int k = r + 1; k < 6; ++k) s -= A[r][k] * x[k];
    x[r] = s / A[r][r];
  }
  float th = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]) + 1e-12f;
  const float scale = fminf(kOmegaMax / th, 1.0f);
  float k[3];
  for (int i = 0; i < 3; ++i) {
    t[i] = x[3 + i] * scale;
    x[i] *= scale;
  }
  th *= scale;
  for (int i = 0; i < 3; ++i) k[i] = x[i] / th;
  const float K[9] = {0.0f, -k[2], k[1], k[2], 0.0f, -k[0], -k[1], k[0], 0.0f};
  const float sn = sinf(th), cs = 1.0f - cosf(th);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float kk = 0.0f;
      for (int q = 0; q < 3; ++q) kk += K[3 * i + q] * K[3 * q + j];
      R[3 * i + j] = ((i == j) ? 1.0f : 0.0f) + sn * K[3 * i + j] + cs * kk;
    }
}

// T ← [[R, t], [0, 1]] · T (4 × 4, row-major, in shared memory), as the
// plain loop's dT @ T rounds it (one FMA chain over k); one thread.
__device__ __forceinline__ void compose(const float* R, const float* t,
                                        float* T) {
  float n[12];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c)
      n[4 * r + c] = __fmaf_rn(
          t[r], T[12 + c],
          dot3(R[3 * r], R[3 * r + 1], R[3 * r + 2], T[c], T[4 + c],
               T[8 + c]));
  for (int i = 0; i < 12; ++i) T[i] = n[i];
}

// The nearest scan point of every model point of this block's work items,
// folded into keys[] (one atomicMin a model point and item).
__device__ void nearest(const Params& p, unsigned long long* keys,
                        float4* tile, const float* T) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int items = p.n_mtiles * p.n_chunks;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int chunk = item % p.n_chunks;
    const int m0 = (item / p.n_chunks) * kModelTile + warp * kPerWarp;
    const int c0 = chunk * p.chunk_len;
    const int c1 = min(c0 + p.chunk_len, p.n_s);
    float mx[kPerWarp], my[kPerWarp], mz[kPerWarp], base[kPerWarp];
    float best[kPerWarp];
    unsigned int bi[kPerWarp];
#pragma unroll
    for (int k = 0; k < kPerWarp; ++k) {
      const int i = min(m0 + k, p.n_m - 1);
      float mt[3];
      transform(T, __ldg(p.m + 3 * i), __ldg(p.m + 3 * i + 1),
                __ldg(p.m + 3 * i + 2), mt);
      base[k] = sqnorm3(mt[0], mt[1], mt[2]);
      mx[k] = mt[0];
      my[k] = mt[1];
      mz[k] = mt[2];
      best[k] = __int_as_float(0x7F800000);
      bi[k] = 0xFFFFFFFFu;
    }
    for (int t0 = c0; t0 < c1; t0 += kScanTile) {
      const int n_here = min(kScanTile, c1 - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < n_here; i += kThreads) {
        const int j = t0 + i;
        const float* q = p.s + static_cast<size_t>(j) * p.s_stride;
        const float x = __ldg(q), y = __ldg(q + 1), z = __ldg(q + 2);
        float sq = sqnorm3(x, y, z);
        if (p.valid != nullptr && !__ldg(p.valid + j))
          sq = __int_as_float(0x7F800000);
        tile[i] = make_float4(x, y, z, sq);
      }
      __syncthreads();
      for (int i = lane; i < n_here; i += 32) {
        const float4 q = tile[i];
#pragma unroll
        for (int k = 0; k < kPerWarp; ++k) {
          // (‖mt‖² + ‖s‖²) − 2·(mt·s), each rounded as the plain loop's
          // tile (2·(mt·s) is exact, so one FMA rounds the difference).
          const float d = __fmaf_rn(
              -2.0f, dot3(mx[k], my[k], mz[k], q.x, q.y, q.z),
              __fadd_rn(base[k], q.w));
          if (d < best[k]) {
            best[k] = d;
            bi[k] = static_cast<unsigned int>(t0 + i);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerWarp; ++k) {
      unsigned long long key =
          (static_cast<unsigned long long>(ordered(best[k])) << 32) | bi[k];
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, key, off);
        key = o < key ? o : key;
      }
      if (lane == 0 && m0 + k < p.n_m) atomicMin(keys + m0 + k, key);
    }
  }
}

struct Match {
  float mt[3], tgt[3], nrm[3], d, w;
};

// Model point i's correspondence under T from the folded keys.
__device__ __forceinline__ Match correspond(const Params& p,
                                            const unsigned long long* keys,
                                            int i, const float* T,
                                            bool need_normal) {
  Match c;
  const unsigned long long key = __ldcg(keys + i);
  unsigned int j = static_cast<unsigned int>(key);
  c.d = unordered(static_cast<unsigned int>(key >> 32));
  // No finite candidate in any chunk: the plain loop's first index.
  if (j >= static_cast<unsigned int>(p.n_s)) j = 0;
  transform(T, __ldg(p.m + 3 * i), __ldg(p.m + 3 * i + 1),
            __ldg(p.m + 3 * i + 2), c.mt);
  const float* q = p.s + static_cast<size_t>(j) * p.s_stride;
  for (int r = 0; r < 3; ++r) c.tgt[r] = __ldg(q + r);
  c.w = c.d < p.max_sq ? 1.0f : 0.0f;
  if (need_normal || p.gate) {
    const float* n = p.sn + static_cast<size_t>(j) * p.sn_stride;
    const float x = __ldg(n), y = __ldg(n + 1), z = __ldg(n + 2);
    const float len = fmaxf(__fsqrt_rn(sqnorm3(x, y, z)), 1e-12f);
    c.nrm[0] = __fdiv_rn(x, len);
    c.nrm[1] = __fdiv_rn(y, len);
    c.nrm[2] = __fdiv_rn(z, len);
  }
  if (p.gate) {
    // (mn @ Rᵀ) · unit(sn[nn]), as the plain loop rounds it.
    const float x = __ldg(p.mn + 3 * i), y = __ldg(p.mn + 3 * i + 1),
                z = __ldg(p.mn + 3 * i + 2);
    float e[3];
    for (int r = 0; r < 3; ++r)
      e[r] = __fmul_rn(dot3(x, y, z, T[4 * r], T[4 * r + 1], T[4 * r + 2]),
                       c.nrm[r]);
    c.w *= (sum3(e[0], e[1], e[2]) > p.cos_thresh) ? 1.0f : 0.0f;
  }
  return c;
}

// One weighted Kabsch step; thread 0 leaves (Σw, Σw·d²) in sums.
__device__ void solve_point(const Params& p, const unsigned long long* keys,
                            float* T, float* red, float* tot, float* sums) {
  const int n = p.n_m;
  // 0: Σw, 1..3: Σw·mt, 4..6: Σw·s[nn], 7: Σw·d².
  float acc[8] = {};
  // Each correspondence waits on two dependent loads (its key, then s[nn]):
  // unrolled, a thread has four in flight (two in the plane step, whose
  // 29 sums take the registers), measured fastest on an H100.
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Match c = correspond(p, keys, i, T, false);
    for (int r = 0; r < 3; ++r) {
      acc[1 + r] += c.w * c.mt[r];
      acc[4 + r] += c.w * c.tgt[r];
    }
    acc[0] += c.w;
    acc[7] += c.w * c.d;
  }
  block_sum(acc, red, tot);
  const float w_raw = tot[0], wd = tot[7];
  const float wsum = fmaxf(w_raw, 1.0f);
  float cm[3], cs[3];
  for (int r = 0; r < 3; ++r) {
    cm[r] = tot[1 + r] / wsum;
    cs[r] = tot[4 + r] / wsum;
  }
  // The centred second pass: H = Σ w (mt − cm)(s[nn] − cs)ᵀ, each
  // correspondence rebuilt from its key under the same T (thread 0 moves T
  // only after the reduction below).
  float h[9] = {};
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Match c = correspond(p, keys, i, T, false);
    float a[3], b[3];
    for (int r = 0; r < 3; ++r) {
      a[r] = c.w * (c.mt[r] - cm[r]);
      b[r] = c.tgt[r] - cs[r];
    }
    for (int r = 0; r < 3; ++r)
      for (int q = 0; q < 3; ++q) h[3 * r + q] += a[r] * b[q];
  }
  block_sum(h, red, tot);
  if (threadIdx.x == 0) {
    float R[9], t[3];
    kabsch_rotation(tot, R);
    for (int r = 0; r < 3; ++r)
      t[r] = cs[r] - (R[3 * r] * cm[0] + R[3 * r + 1] * cm[1] +
                      R[3 * r + 2] * cm[2]);
    compose(R, t, T);
    sums[0] = w_raw;
    sums[1] = wd;
  }
  __syncthreads();
}

// One clamped point-to-plane step; thread 0 leaves (Σw, Σw·d²) in sums.
__device__ void solve_plane(const Params& p, const unsigned long long* keys,
                            float* T, float* red, float* tot, float* sums) {
  // 0: Σw, 1: Σw·d², 2..22: upper triangle of JwᵀJ, 23..28: Jwᵀr.
  float acc[29] = {};
#pragma unroll 2
  for (int i = threadIdx.x; i < p.n_m; i += kThreads) {
    const Match c = correspond(p, keys, i, T, true);
    float J[6];
    cross3(c.mt, c.nrm, J);
    J[3] = c.nrm[0];
    J[4] = c.nrm[1];
    J[5] = c.nrm[2];
    const float r = (c.mt[0] - c.tgt[0]) * c.nrm[0] +
                    (c.mt[1] - c.tgt[1]) * c.nrm[1] +
                    (c.mt[2] - c.tgt[2]) * c.nrm[2];
    acc[0] += c.w;
    acc[1] += c.w * c.d;
    int k = 2;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float ja = J[a] * c.w;
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += ja * J[b];
      acc[23 + a] += ja * r;
    }
  }
  block_sum(acc, red, tot);
  if (threadIdx.x == 0) {
    float A[6][6], b[6];
    int k = 2;
    for (int a = 0; a < 6; ++a) {
      for (int q = a; q < 6; ++q) A[a][q] = A[q][a] = tot[k++];
      A[a][a] += 1e-6f;
      b[a] = -tot[23 + a];
    }
    float R[9], t[3];
    plane_step(A, b, R, t);
    compose(R, t, T);
    sums[0] = tot[0];
    sums[1] = tot[1];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
icp_refine_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float4* tile = reinterpret_cast<float4*>(smem);
  float* red = smem + 4 * kScanTile;
  float* tot = red + kWarps * kRed;
  float* T = tot + kRed;
  float* sums = T + 16;           // Σw, Σw·d² of the last step
  cg::grid_group grid = cg::this_grid();
  const int stride = static_cast<int>(gridDim.x) * kThreads;
  const int first = static_cast<int>(blockIdx.x) * kThreads +
                    static_cast<int>(threadIdx.x);

  if (threadIdx.x < 16) T[threadIdx.x] = p.T0[threadIdx.x];
  if (threadIdx.x < 4) sums[threadIdx.x] = 0.0f;
  for (int i = first; i < 2 * p.n_m; i += stride) p.keys[i] = kNoKey;
  grid.sync();
  for (int it = 0; it < p.iterations; ++it) {
    unsigned long long* keys = p.keys + (it % 3) * p.n_m;
    nearest(p, keys, tile, T);
    grid.sync();
    unsigned long long* next = p.keys + ((it + 2) % 3) * p.n_m;
    for (int i = first; i < p.n_m; i += stride) next[i] = kNoKey;
    if (it < p.n_point_iters)
      solve_point(p, keys, T, red, tot, sums);
    else
      solve_plane(p, keys, T, red, tot, sums);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 16; ++i) p.out[i] = T[i];
    p.out[16] = sqrtf(sums[1] / fmaxf(sums[0], 1.0f));
    reinterpret_cast<int*>(p.out)[17] = static_cast<int>(sums[0]);
  }
}

}  // namespace

// Refines T0 on `stream` in one cooperative launch; returns 0, a CUDA error
// code, or -1 when no block fits an SM. Pointers are device pointers:
// m (n_m, 3) float32 contiguous; mn the same or null; s n_s rows of 3
// float32 (row stride s_stride floats, unit column stride); sn likewise or
// null; valid (n_s,) bytes 0/1 or null; T0 (4, 4) float32; keys (3 · n_m)
// 64-bit workspace; out 18 floats (pose, rms, inliers as int32). gate: both
// normal sets given (sn and mn non-null); plane steps (it >= n_point_iters)
// need sn. n_m >= 0 (an empty model leaves T0 as it is), n_s >= 1.
// Allocates nothing and does not synchronise.
extern "C" int osn_icp_refine(const void* m, const void* mn, const void* s,
                              int s_stride, const void* sn, int sn_stride,
                              const void* valid, const void* T0, int n_m,
                              int n_s, float max_sq, float cos_thresh,
                              int iterations, int n_point_iters, int gate,
                              void* keys, void* out, void* stream) {
  if (n_m < 0 || n_s < 1 || iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(sizeof(float)) *
                       (4 * kScanTile + kWarps * kRed + kRed + 16 + 4);
  const void* fn = reinterpret_cast<const void*>(icp_refine_kernel);
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    icp_refine_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  per_sm = std::min(per_sm, kMaxBlocksPerSM);
  if (per_sm < 1) return kErrNoBlockFits;
  const int max_blocks = per_sm * sms;

  Params p;
  p.m = static_cast<const float*>(m);
  p.mn = static_cast<const float*>(mn);
  p.s = static_cast<const float*>(s);
  p.sn = static_cast<const float*>(sn);
  p.valid = static_cast<const unsigned char*>(valid);
  p.T0 = static_cast<const float*>(T0);
  p.keys = static_cast<unsigned long long*>(keys);
  p.out = static_cast<float*>(out);
  p.n_m = n_m;
  p.n_s = n_s;
  p.s_stride = s_stride;
  p.sn_stride = sn_stride;
  p.max_sq = max_sq;
  p.cos_thresh = cos_thresh;
  p.iterations = iterations;
  p.n_point_iters = n_point_iters;
  p.gate = gate;
  // Blocks from n_m·n_s: about kPairsPerBlock pairs each, as many chunks of
  // the scan as the model tiles leave room for, each at least kMinChunk.
  p.n_mtiles = (n_m + kModelTile - 1) / kModelTile;
  const long long pairs = static_cast<long long>(p.n_mtiles) * kModelTile *
                          n_s;
  const int want = static_cast<int>(
      std::min(static_cast<long long>(max_blocks),
               std::max(1LL, (pairs + kPairsPerBlock - 1) / kPairsPerBlock)));
  const int max_chunks = std::max(1, n_s / kMinChunk);
  const int n_chunks =
      std::min(std::max(1, want / std::max(1, p.n_mtiles)), max_chunks);
  p.chunk_len = (n_s + n_chunks - 1) / n_chunks;
  p.n_chunks = (n_s + p.chunk_len - 1) / p.chunk_len;
  const int blocks =
      std::max(1, std::min(p.n_mtiles * p.n_chunks, max_blocks));

  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
