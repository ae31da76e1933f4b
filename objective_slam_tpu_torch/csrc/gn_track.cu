// KinFu frame-to-model tracking in one launch: every Gauss-Newton step of
// models/tsdf.track_frame (transform, projective association into the
// previous camera, the three gates, the 6 × 6 point-to-plane normal
// equations, the pivoted solve, the clamped Rodrigues lift, the pose
// update) with the pose kept on chip.
//
// Replaces no TPU kernel: the JAX package leaves this loop to XLA
// (objective_slam_tpu/models/tsdf.py:track_frame). The port's plain loop
// (models/tsdf._gauss_newton_plain) issues about 140 small launches a step
// over all h·w pixels and waits on nothing; this kernel issues one for the
// whole fixed-iteration loop and reads nothing back to the host.
//
// What it computes, for i = 0 .. iters − 1 from T = T_wc0 (float32), per
// pixel p with frame_ok[p]:
//   pw = R·v_cam[p] + t and nw = R·n_cam[p] (T = [R, t]); (x, y, z) =
//   R_cw·pw + t_cw (T_cw_prev = [R_cw, t_cw]); u = rint(fx·x / max(z, 1e-9)
//   + cx), v likewise, each clamped to ±2^30 first; cand = z > 0, (u, v) in
//   the image, model_ok[v·w + u]; ok = cand, ‖pw − vm‖² < d2_i, nw·nm >
//   normal_cos, with (vm, nm) the model maps at v·w + u and d2_i =
//   d2_wide for i < wide_steps, else d2. Over the ok pixels, with
//   rf = (pw − vm)·nm and J = [pw × nm, nm]: A = Σ JᵀJ, b = Σ J rf. Then
//   (A + 1e-6·I) δ = −b by Gaussian elimination with partial pivoting, the
//   step scaled by min(kOmegaMax / (‖ω‖ + 1e-12), 1), ω lifted by
//   Rodrigues, T = dT·T. rms = sqrt(Σ rf² / max(#ok, 1)), inliers = #ok
//   and overlap = #cand of the last step.
//
// The per-pixel float32 operations round as the plain loop's operations
// round on the card (torch's elementwise kernels), so from the same pose
// both see the same associations and gates; the sums and the solve run in
// another order. No TF32 and no lower precision anywhere.
//
// Design: a cooperative grid, one or two blocks an SM, sized from h·w,
// pixels strided over the grid. Each thread keeps its pixels' 21 + 6 + 1
// float sums and the two counts in registers; the block reduces them by
// warp shuffles and writes one row of partials. After one grid barrier
// every block adds all rows in the same fixed order, so every block solves
// the same 6 × 6 system and holds the same pose in shared memory: a step
// needs one barrier. The partials alternate between two buffers, so the
// next step's writes never meet this step's reads. No float atomics: a
// launch gives the same bits each time.
//
// What bounds it on an H100: the bytes of a step, about 50 B a valid pixel
// (its vertex, normal and mask, the gathered model vertex, normal and mask)
// and about 100 float32 operations (an FMA as two); 15 MB a step at
// 640 × 480, from the L2 cache after the first step. At that size the
// serial part bounds it: the barrier, the block-wide sum of the partials
// and one thread's 6 × 6 solve a step.
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
constexpr int kMaxBlocksPerSM = 2;
// Partials a block: 21 entries of JᵀJ (upper triangle), 6 of Jᵀr, Σ r²,
// then #ok and #cand (int32 bits).
constexpr int kSums = 30;
constexpr int kFloatSums = 28;
constexpr int kRow = 32;                  // floats a row of partials
constexpr int kSlices = kThreads / kRow;  // the final sum's block slices
constexpr int kMinPixelsPerThread = 4;
constexpr int kMaxGrid = 1024;            // rows of partials a buffer
constexpr float kIndexLimit = 1073741824.0f;   // tsdf._INDEX_LIMIT
constexpr float kOmegaMax = 0.08f;             // tsdf._OMEGA_MAX
// Returned when no block of this kernel fits an SM (a CUDA error is > 0).
constexpr int kErrNoBlockFits = -1;

struct Params {
  const float* v_cam;               // (n, 3) camera-frame vertices
  const float* n_cam;               // (n, 3) camera-frame normals
  const unsigned char* frame_ok;    // (n,) 0/1
  const float* v_model;             // (n, 3) world-frame model vertices
  const float* n_model;             // (n, 3) world-frame model normals
  const unsigned char* model_ok;    // (n,) 0/1
  const float* T_wc0;               // (4, 4) start pose
  const float* T_cw_prev;           // (4, 4) the model view's camera
  float* partials;                  // (2, gridDim.x, kRow)
  float* out;                       // pose (16), rms, inliers, overlap
  int h, w, n;
  float fx, fy, cx, cy;
  float d2_wide, d2, normal_cos;
  int iters, wide_steps;
};

// The float32 operations below round as the plain loop's torch operations
// round on the card (measured on an H100 against torch 2.11): torch.addcmul
// is one FMA, torch.sum over a last dimension of three adds (e0 + e2) + e1,
// torch.linalg.cross's a1·b2 − a2·b1 is fma(a1, b2, −(a2·b1)), division
// rounds once, a 4 × 4 product sums two FMA pairs. __fmul_rn and __fadd_rn keep nvcc from fusing what torch
// rounds apart.

// Row r of R (row-major 4 × 4 T) applied to (x, y, z), as tsdf._rotate
// builds it: fma(z, R[r,2], fma(y, R[r,1], R[r,0]·x)).
__device__ __forceinline__ float rot_row(const float* T, int r, float x,
                                         float y, float z) {
  return __fmaf_rn(z, T[4 * r + 2],
                   __fmaf_rn(y, T[4 * r + 1], __fmul_rn(T[4 * r], x)));
}

// e0 + e1 + e2 as torch.sum over the last dimension of three adds it.
__device__ __forceinline__ float sum3(float e0, float e1, float e2) {
  return __fadd_rn(__fadd_rn(e0, e2), e1);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1]),
              __fmul_rn(a[2], b[2]));
}

// round-half-even of x clamped to ±kIndexLimit, as tsdf._round_index.
__device__ __forceinline__ int round_index(float x) {
  return static_cast<int>(rintf(fminf(fmaxf(x, -kIndexLimit), kIndexLimit)));
}

// Sums v[0 .. kSums) over the block into row[0 .. kSums) in a fixed order
// (the two counts as integers).
__device__ __forceinline__ void block_sum(float (&v)[kFloatSums], int n_ok,
                                          int n_cand, float* red,
                                          float* row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kFloatSums; ++k) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], off);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    n_ok += __shfl_xor_sync(0xFFFFFFFFu, n_ok, off);
    n_cand += __shfl_xor_sync(0xFFFFFFFFu, n_cand, off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kFloatSums; ++k) red[warp * kRow + k] = v[k];
    red[warp * kRow + kFloatSums] = __int_as_float(n_ok);
    red[warp * kRow + kFloatSums + 1] = __int_as_float(n_cand);
  }
  __syncthreads();
  if (threadIdx.x < kFloatSums) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kRow + threadIdx.x];
    row[threadIdx.x] = s;
  } else if (threadIdx.x < kSums) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w)
      s += __float_as_int(red[w * kRow + threadIdx.x]);
    row[threadIdx.x] = __int_as_float(s);
  }
  __syncthreads();
}

// Sums the rows of partials of all gridDim.x blocks into tot[0 .. kSums):
// thread (slice s, entry k) adds blocks s, s + kSlices, ... in order, then
// entry k adds the slices in order. Every block gets the same bits.
__device__ __forceinline__ void grid_sum(const float* rows, float* red,
                                         float* tot) {
  const int k = threadIdx.x % kRow;
  const int s = threadIdx.x / kRow;
  if (k < kFloatSums) {
    float acc = 0.0f;
    for (int b = s; b < static_cast<int>(gridDim.x); b += kSlices)
      acc += __ldcg(rows + b * kRow + k);
    red[s * kRow + k] = acc;
  } else if (k < kSums) {
    int acc = 0;
    for (int b = s; b < static_cast<int>(gridDim.x); b += kSlices)
      acc += __float_as_int(__ldcg(rows + b * kRow + k));
    red[s * kRow + k] = __int_as_float(acc);
  }
  __syncthreads();
  if (threadIdx.x < kFloatSums) {
    float acc = 0.0f;
    for (int q = 0; q < kSlices; ++q) acc += red[q * kRow + threadIdx.x];
    tot[threadIdx.x] = acc;
  } else if (threadIdx.x < kSums) {
    int acc = 0;
    for (int q = 0; q < kSlices; ++q)
      acc += __float_as_int(red[q * kRow + threadIdx.x]);
    tot[threadIdx.x] = __int_as_float(acc);
  }
  __syncthreads();
}

// The point-to-plane increment from A (6 × 6, with the 1e-6 ridge) and rhs
// b: Gaussian elimination with partial pivoting, the se(3) step scaled so
// that ‖ω‖ ≤ kOmegaMax, ω lifted by Rodrigues (a copy of
// csrc/icp_refine.cu's plane_step, whose clamp is 0.02).
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
// plain loop's dT @ T rounds it on the card (cuBLAS, K = 4: two FMA
// pairs, then their sum); one thread.
__device__ __forceinline__ void compose(const float* R, const float* t,
                                        float* T) {
  float n[12];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c)
      n[4 * r + c] = __fadd_rn(
          __fmaf_rn(R[3 * r + 1], T[4 + c], __fmul_rn(R[3 * r], T[c])),
          __fmaf_rn(t[r], T[12 + c], __fmul_rn(R[3 * r + 2], T[8 + c])));
  for (int i = 0; i < 12; ++i) T[i] = n[i];
}

// This thread's pixels under T: the sums over its ok pixels and its counts.
__device__ __forceinline__ void accumulate(const Params& p, const float* T,
                                           const float* C, float d2_i,
                                           float (&acc)[kFloatSums],
                                           int& n_ok, int& n_cand) {
  const int stride = static_cast<int>(gridDim.x) * kThreads;
  for (int i = static_cast<int>(blockIdx.x) * kThreads +
               static_cast<int>(threadIdx.x);
       i < p.n; i += stride) {
    if (!__ldg(p.frame_ok + i)) continue;
    const float vx = __ldg(p.v_cam + 3 * i), vy = __ldg(p.v_cam + 3 * i + 1),
                vz = __ldg(p.v_cam + 3 * i + 2);
    float pw[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      pw[r] = __fadd_rn(rot_row(T, r, vx, vy, vz), T[4 * r + 3]);
    // Projective association into the previous camera.
    float q[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      q[r] = __fadd_rn(rot_row(C, r, pw[0], pw[1], pw[2]), C[4 * r + 3]);
    const float zc = fmaxf(q[2], 1e-9f);
    const int u = round_index(__fadd_rn(__fdiv_rn(__fmul_rn(p.fx, q[0]), zc),
                                        p.cx));
    const int v = round_index(__fadd_rn(__fdiv_rn(__fmul_rn(p.fy, q[1]), zc),
                                        p.cy));
    if (!(q[2] > 0.0f) || u < 0 || u >= p.w || v < 0 || v >= p.h) continue;
    const int flat = v * p.w + u;
    if (!__ldg(p.model_ok + flat)) continue;
    ++n_cand;
    float vm[3], nm[3], d[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      vm[r] = __ldg(p.v_model + 3 * flat + r);
      nm[r] = __ldg(p.n_model + 3 * flat + r);
      d[r] = __fsub_rn(pw[r], vm[r]);
    }
    if (!(dot3(d, d) < d2_i)) continue;
    const float nx = __ldg(p.n_cam + 3 * i), ny = __ldg(p.n_cam + 3 * i + 1),
                nz = __ldg(p.n_cam + 3 * i + 2);
    float nw[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) nw[r] = rot_row(T, r, nx, ny, nz);
    if (!(dot3(nw, nm) > p.normal_cos)) continue;
    ++n_ok;
    const float rf = dot3(d, nm);
    const float J[6] = {
        __fmaf_rn(pw[1], nm[2], -__fmul_rn(pw[2], nm[1])),
        __fmaf_rn(pw[2], nm[0], -__fmul_rn(pw[0], nm[2])),
        __fmaf_rn(pw[0], nm[1], -__fmul_rn(pw[1], nm[0])),
        nm[0], nm[1], nm[2]};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 6; ++c) acc[k++] += J[a] * J[c];
      acc[21 + a] += J[a] * rf;
    }
    acc[27] += rf * rf;
  }
}

__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
gn_track_kernel(const Params p) {
  __shared__ float red[kSlices * kRow];
  __shared__ float tot[kRow];
  __shared__ float T[16];           // the current T_wc
  __shared__ float C[16];           // T_cw_prev
  cg::grid_group grid = cg::this_grid();

  if (threadIdx.x < 16) {
    T[threadIdx.x] = p.T_wc0[threadIdx.x];
    C[threadIdx.x] = p.T_cw_prev[threadIdx.x];
  }
  if (threadIdx.x < kRow) tot[threadIdx.x] = 0.0f;
  __syncthreads();
  for (int it = 0; it < p.iters; ++it) {
    float* rows = p.partials + (it & 1) * gridDim.x * kRow;
    float acc[kFloatSums] = {};
    int n_ok = 0, n_cand = 0;
    accumulate(p, T, C, it < p.wide_steps ? p.d2_wide : p.d2, acc, n_ok,
               n_cand);
    block_sum(acc, n_ok, n_cand, red, rows + blockIdx.x * kRow);
    grid.sync();
    grid_sum(rows, red, tot);
    if (threadIdx.x == 0) {
      float A[6][6], b[6];
      int k = 0;
      for (int a = 0; a < 6; ++a) {
        for (int c = a; c < 6; ++c) A[a][c] = A[c][a] = tot[k++];
        A[a][a] += 1e-6f;
        b[a] = -tot[21 + a];
      }
      float R[9], t[3];
      plane_step(A, b, R, t);
      compose(R, t, T);
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 16; ++i) p.out[i] = T[i];
    const int n_ok = __float_as_int(tot[kFloatSums]);
    p.out[16] = sqrtf(tot[27] / fmaxf(static_cast<float>(n_ok), 1.0f));
    reinterpret_cast<int*>(p.out)[17] = n_ok;
    reinterpret_cast<int*>(p.out)[18] = __float_as_int(tot[kFloatSums + 1]);
  }
}

}  // namespace

// Runs `iters` Gauss-Newton steps from T_wc0 on `stream` in one cooperative
// launch; returns 0, a CUDA error code, or -1 when no block fits an SM.
// Pointers are device pointers: v_cam, n_cam, v_model, n_model (h·w, 3)
// float32 contiguous; frame_ok, model_ok (h·w,) bytes 0/1; T_wc0, T_cw_prev
// (4, 4) float32; partials 2 · kMaxGrid · kRow = 65,536 floats of
// workspace; out 19 floats (pose, rms, inliers and overlap as int32). The
// first wide_steps steps gate at d2_wide, the rest at d2. h, w >= 0,
// h·w < 2^31 − 2^24, iters >= 0 (no step: T_wc0 comes back with rms,
// inliers and overlap 0). Allocates nothing and does not synchronise.
extern "C" int osn_gn_track(const void* v_cam, const void* n_cam,
                            const void* frame_ok, const void* v_model,
                            const void* n_model, const void* model_ok,
                            const void* T_wc0, const void* T_cw_prev, int h,
                            int w, float fx, float fy, float cx, float cy,
                            float d2_wide, float d2, float normal_cos,
                            int iters, int wide_steps, void* partials,
                            void* out, void* stream) {
  const long long n = static_cast<long long>(h) * w;
  if (h < 0 || w < 0 || n >= (1LL << 31) - (1LL << 24) || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_track_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  per_sm = std::min(per_sm, kMaxBlocksPerSM);
  if (per_sm < 1) return kErrNoBlockFits;
  // About kMinPixelsPerThread pixels a thread, at most a full grid.
  const long long want = (n + kThreads * kMinPixelsPerThread - 1) /
                         (kThreads * kMinPixelsPerThread);
  const int blocks = static_cast<int>(std::max(
      1LL, std::min({want, static_cast<long long>(per_sm) * sms,
                     static_cast<long long>(kMaxGrid)})));
  Params p;
  p.v_cam = static_cast<const float*>(v_cam);
  p.n_cam = static_cast<const float*>(n_cam);
  p.frame_ok = static_cast<const unsigned char*>(frame_ok);
  p.v_model = static_cast<const float*>(v_model);
  p.n_model = static_cast<const float*>(n_model);
  p.model_ok = static_cast<const unsigned char*>(model_ok);
  p.T_wc0 = static_cast<const float*>(T_wc0);
  p.T_cw_prev = static_cast<const float*>(T_cw_prev);
  p.partials = static_cast<float*>(partials);
  p.out = static_cast<float*>(out);
  p.h = h;
  p.w = w;
  p.n = static_cast<int>(n);
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.d2_wide = d2_wide;
  p.d2 = d2;
  p.normal_cos = normal_cos;
  p.iters = iters;
  p.wide_steps = wide_steps;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_track_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
