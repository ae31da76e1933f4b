// KinFu raycast in three ordinary launches: the volume's depth view of
// models/tsdf.raycast_depth from a sign mask of the pooled field and a
// march of one thread a pixel.
//
// Replaces no TPU kernel: the JAX package leaves the raycast to XLA
// (objective_slam_tpu/models/tsdf.py:raycast_depth). The port's plain
// version (models/tsdf._raycast_depth) rebuilds the 3³ min-pooled field
// over every voxel, samples the coarse march as an (n_steps, h, w) stack
// and the refinement windows as (fine_steps, h, w) stacks: about 1,150
// launches and several GB of temporaries a frame at 512³ and 640 × 480.
//
// What it computes, with v(x) = tsdf(x) where weight(x) > 0, else τ, and
// τ wherever x lies outside the volume:
//   pooled(x) = min over the 3³ neighbourhood of v (NaN if any is NaN);
//   per pixel (u, v) the ray r(t) = o_w + t·d_w, d_w = R·((u − cx)/fx,
//   (v − cy)/fy, 1), and its grid position g(t) = (r(t) − origin)/vs −
//   0.5; the coarse sample at ts[s] reads pooled at rint(g(ts[s])) (τ
//   outside); segment s is a bracket where sample s is > 0 and sample s + 1
//   is ≤ 0; bracket k (k < n_brackets, in march order) samples the field
//   trilinearly at tw_f = ts[s] + offs[f] (corners unobserved or outside
//   left out of the weights, τ where they weigh 0.5 or less), and its first
//   +→− step f − 1 → f gives d = tw_{f−1} + (tw_f − tw_{f−1})·v_{f−1} /
//   max(v_{f−1} − v_f, 1e-9). The depth is the first bracket's d, in
//   bracket order, that is not 0; 0 where no window crosses.
//
// Every float32 operation rounds as the plain version's torch operation
// rounds on the card (torch.addcmul is one FMA, a tensor op with a CPU
// scalar rounds once in float32); __fmul_rn, __fadd_rn, __fsub_rn,
// __fmaf_rn and __fdiv_rn keep nvcc from contracting what torch rounds
// apart. The plain version's reductions over the stacks are sums of one
// term that is not 0, so the depths are equal bit for bit.
//
// Design. The coarse march tests only the sign of pooled, so it is kept as
// two bit planes, pooled > 0 and pooled ≤ 0 (a NaN sets neither), one
// 32-bit word of each for 32 voxels along W: 32 MiB at 512³, resident in
// the H100's 50 MB L2 cache through the march. Launch 1, the flags: the
// volume streamed once, coalesced, each warp's ballots packing the NaN and
// ≤ 0 flags of 32 voxels into a word. Launch 2, the mask: each word ORed
// over its 3³ neighbourhood (along W by bit shifts, the edge bits from the
// neighbouring words), from the flags' 32 MiB in the L2 cache. Launch 3,
// the march: one thread a pixel, blocks of 32 × 8 pixels, so a warp's rays
// run side by side through the same mask words and voxels; a window stops
// at its first crossing, the march at its first depth.
//
// What bounds it on an H100: the flags pass reads the 1 GiB volume once
// (0.32 ms at 3.35 TB/s); the mask pass and the march read from the L2
// cache (8 B of mask a coarse step, 64 B a trilinear sample: 8 corners of
// tsdf and weight).
//
// Built by objective_slam_tpu_torch/ops/_build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kIndexLimit = 1073741824.0f;   // tsdf._INDEX_LIMIT
constexpr float kTiny = 1e-9f;                  // the plain version's clamps
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaskThreads = 256;
constexpr int kWordsPerWarp = 4;     // words a warp of the flags pass reads
constexpr int kTileU = 32;           // march block: kTileU × kTileV pixels
constexpr int kTileV = 8;

struct Grid {
  const float* tsdf;                 // (D, H, W)
  const float* weight;               // (D, H, W)
  int D, H, W;
  int words;                         // mask words a row: ceil(W / 32)
  float trunc;                       // τ
};

// --------------------------------------------------------------- the mask

// v of voxel i of an observed row: tsdf where weight > 0, else τ.
__device__ __forceinline__ float field(const Grid& g, long long i) {
  const float w = __ldg(g.weight + i);
  const float t = __ldg(g.tsdf + i);
  return w > 0.0f ? t : g.trunc;
}

// flags[q] = (NaN bits, ≤ 0 bits) of v over the 32 voxels of word q (row
// q / words, voxels 32·(q % words) + lane; past W they read τ). A warp
// takes kWordsPerWarp consecutive words, their loads issued together.
__global__ void __launch_bounds__(kMaskThreads)
raycast_flags_kernel(const Grid g, int n_words, uint2* flags) {
  const int lane = threadIdx.x & 31;
  const int q0 = static_cast<int>(
      ((static_cast<long long>(blockIdx.x) * kMaskThreads + threadIdx.x) >>
       5) * kWordsPerWarp);
  if (q0 >= n_words) return;                  // whole warps leave
  float v[kWordsPerWarp];
#pragma unroll
  for (int c = 0; c < kWordsPerWarp; ++c) {
    const int q = q0 + c;
    const int x = 32 * (q % g.words) + lane;
    v[c] = g.trunc;
    if (q < n_words && x < g.W)
      v[c] = field(g, static_cast<long long>(q / g.words) * g.W + x);
  }
#pragma unroll
  for (int c = 0; c < kWordsPerWarp; ++c) {
    const unsigned n = __ballot_sync(kFull, isnan(v[c]));
    const unsigned l = __ballot_sync(kFull, v[c] <= 0.0f);
    if (lane == c && q0 + c < n_words) flags[q0 + c] = make_uint2(n, l);
  }
}

// mask[q] = (pooled > 0 bits, pooled ≤ 0 bits) of word q = (d, h, word):
// the flags ORed over the 3³ neighbourhood, rows and words outside the
// volume reading τ's flags; along W by shifts, the edge bits from the
// neighbouring words.
__global__ void __launch_bounds__(kMaskThreads)
raycast_mask_kernel(const Grid g, int n_words, const uint2* flags,
                    uint2* mask) {
  const int q = static_cast<int>(blockIdx.x) * kMaskThreads +
                static_cast<int>(threadIdx.x);
  if (q >= n_words) return;
  const int word = q % g.words;
  const int h = (q / g.words) % g.H;
  const int d = q / g.words / g.H;
  const uint2 tau = make_uint2(isnan(g.trunc) ? kFull : 0u,
                               g.trunc <= 0.0f ? kFull : 0u);
  unsigned n = 0u, l = 0u;
  for (int dd = -1; dd <= 1; ++dd)
    for (int dh = -1; dh <= 1; ++dh) {
      const int dr = d + dd, hr = h + dh;
      uint2 c = tau, left = tau, right = tau;
      if (dr >= 0 && dr < g.D && hr >= 0 && hr < g.H) {
        const uint2* row = flags + (dr * g.H + hr) * g.words;
        c = __ldg(row + word);
        if (word > 0) left = __ldg(row + word - 1);
        if (word + 1 < g.words) right = __ldg(row + word + 1);
      }
      n |= c.x | (c.x << 1) | (c.x >> 1) | (left.x >> 31) | (right.x << 31);
      l |= c.y | (c.y << 1) | (c.y >> 1) | (left.y >> 31) | (right.y << 31);
    }
  mask[q] = make_uint2(~n & ~l, ~n & l);
}

// -------------------------------------------------------------- the march

struct March {
  Grid g;
  const uint2* mask;
  const float* T_wc;                 // (4, 4) camera → world
  const float* origin;               // (3,)
  const float* ts;                   // (n_steps,) coarse parameters
  const float* offs;                 // (fine_steps,) window offsets
  const float* ray_u;                // (w,) (u − cx)/fx
  const float* ray_v;                // (h,) (v − cy)/fy
  float* depth;                      // (h, w)
  int h, w, n_steps, fine_steps, n_brackets;
  float vs_inv;                      // float32(1/voxel_size)
};

// torch.clamp's NaN passes through; torch.round is half-even; both then
// cast as torch casts to int64.
__device__ __forceinline__ long long round_index(float x) {
  const float c = isnan(x) ? x : fminf(fmaxf(x, -kIndexLimit), kIndexLimit);
  return static_cast<long long>(rintf(c));
}

__device__ __forceinline__ long long floor_index(float x) {
  const float c = isnan(x) ? x : fminf(fmaxf(x, -kIndexLimit), kIndexLimit);
  return static_cast<long long>(floorf(c));
}

// One pixel's ray: direction, origin and the volume's origin, as the plain
// version's (h, w) maps hold them.
struct Ray {
  float d[3], o[3], vo[3];
};

// Grid coordinate a of the ray at t: (fma(d, t, o) − origin)·vs_inv − 0.5.
__device__ __forceinline__ float coord(const Ray& r, int a, float t,
                                       float vs_inv) {
  return __fsub_rn(
      __fmul_rn(__fsub_rn(__fmaf_rn(r.d[a], t, r.o[a]), r.vo[a]), vs_inv),
      0.5f);
}

__device__ __forceinline__ bool inside(const Grid& g, long long i,
                                       long long j, long long k) {
  return i >= 0 && i < g.D && j >= 0 && j < g.H && k >= 0 && k < g.W;
}

// The pooled field's sign at the nearest voxel of the ray at t.
__device__ __forceinline__ void coarse(const March& p, const Ray& r, float t,
                                       bool& pos, bool& nonpos) {
  const long long i = round_index(coord(r, 0, t, p.vs_inv));
  const long long j = round_index(coord(r, 1, t, p.vs_inv));
  const long long k = round_index(coord(r, 2, t, p.vs_inv));
  if (!inside(p.g, i, j, k)) {
    pos = p.g.trunc > 0.0f;
    nonpos = p.g.trunc <= 0.0f;
    return;
  }
  const uint2 m = __ldg(p.mask + (i * p.g.H + j) * p.g.words + (k >> 5));
  const unsigned bit = 1u << (k & 31);
  pos = (m.x & bit) != 0u;
  nonpos = (m.y & bit) != 0u;
}

// The trilinear sample of the ray at t: corners in the plain version's
// order (i, then j, then k), each weight ((f_i·f_j)·f_k), sums from 0.
__device__ float sample(const March& p, const Ray& r, float t) {
  long long b[3];
  float fr[3], om[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = coord(r, a, t, p.vs_inv);
    b[a] = floor_index(x);
    fr[a] = __fsub_rn(x, static_cast<float>(b[a]));
    om[a] = __fsub_rn(1.0f, fr[a]);
  }
  float val = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int di = c >> 2, dj = (c >> 1) & 1, dk = c & 1;
    const float wt = __fmul_rn(__fmul_rn(di ? fr[0] : om[0],
                                         dj ? fr[1] : om[1]),
                               dk ? fr[2] : om[2]);
    const long long i = b[0] + di, j = b[1] + dj, k = b[2] + dk;
    float add_v = 0.0f, add_w = 0.0f;
    if (inside(p.g, i, j, k)) {
      const long long f = (i * p.g.H + j) * p.g.W + k;
      const float wv = __ldg(p.g.weight + f);
      const float tv = __ldg(p.g.tsdf + f);
      if (wv > 0.0f && !isnan(tv)) {
        add_v = __fmul_rn(wt, tv);
        add_w = wt;
      }
    }
    val = __fadd_rn(val, add_v);
    wsum = __fadd_rn(wsum, add_w);
  }
  return wsum > 0.5f ? __fdiv_rn(val, fmaxf(wsum, kTiny)) : p.g.trunc;
}

// The window of the bracket at t0: true and its depth d at the first +→−
// step of the samples, false where none crosses.
__device__ bool window(const March& p, const Ray& r, float t0, float& d) {
  float t_prev = __fadd_rn(t0, __ldg(p.offs));
  float v_prev = sample(p, r, t_prev);
  for (int f = 1; f < p.fine_steps; ++f) {
    const float t = __fadd_rn(t0, __ldg(p.offs + f));
    const float v = sample(p, r, t);
    if (v_prev > 0.0f && v <= 0.0f) {
      const float frac = __fdiv_rn(v_prev, fmaxf(__fsub_rn(v_prev, v), kTiny));
      // + 0: the plain version's sum over the window turns −0 into +0.
      d = __fadd_rn(__fmaf_rn(frac, __fsub_rn(t, t_prev), t_prev), 0.0f);
      return true;
    }
    t_prev = t;
    v_prev = v;
  }
  return false;
}

__global__ void __launch_bounds__(kTileU * kTileV)
raycast_march_kernel(const March p) {
  const int u = blockIdx.x * kTileU + threadIdx.x;
  const int v = blockIdx.y * kTileV + threadIdx.y;
  if (u >= p.w || v >= p.h) return;
  // The ray: R·(ray_u, ray_v, 1) as tsdf._rotate rounds it,
  // fma(1, R[a,2], fma(ray_v, R[a,1], R[a,0]·ray_u)).
  const float ru = __ldg(p.ray_u + u), rv = __ldg(p.ray_v + v);
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* row = p.T_wc + 4 * a;
    r.d[a] = __fadd_rn(__fmaf_rn(rv, __ldg(row + 1),
                                 __fmul_rn(__ldg(row), ru)),
                       __ldg(row + 2));
    r.o[a] = __ldg(row + 3);
    r.vo[a] = __ldg(p.origin + a);
  }
  float depth = 0.0f;
  int k = 0;
  bool prev_pos = false;
  for (int s = 0; s < p.n_steps && k < p.n_brackets; ++s) {
    bool pos, nonpos;
    coarse(p, r, __ldg(p.ts + s), pos, nonpos);
    if (prev_pos && nonpos) {
      // Bracket k: segment s − 1, its window from ts[s − 1] (+ 0: the
      // plain version's sum over the march turns −0 into +0).
      ++k;
      float d;
      if (window(p, r, __fadd_rn(__ldg(p.ts + s - 1), 0.0f), d) &&
          depth == 0.0f)
        depth = d;
      if (depth != 0.0f) break;
    }
    prev_pos = pos;
  }
  p.depth[static_cast<long long>(v) * p.w + u] = depth;
}

}  // namespace

// The depth view (h, w) of the volume on `stream`: the flags and mask
// passes, then the march; returns 0 or a CUDA error code. Pointers are
// device pointers: tsdf, weight (D, H, W) float32 contiguous; origin (3,),
// T_wc (4, 4) row-major, ts (n_steps,), offs (fine_steps,), ray_u (w,),
// ray_v (h,) float32; work 2·D·H·ceil(W/32) uint2 of workspace (the flags,
// then the mask); depth (h, w) float32. D, H, W >= 1, D·H·ceil(W/32) <
// 2^31 − 1024, h, w >= 0, n_steps >= 2, fine_steps >= 1, n_brackets >= 0.
// Allocates nothing and does not synchronise.
extern "C" int osn_raycast(const void* tsdf, const void* weight, int D,
                           int H, int W, const void* origin, const void* T_wc,
                           const void* ts, int n_steps, const void* offs,
                           int fine_steps, const void* ray_u,
                           const void* ray_v, int h, int w, int n_brackets,
                           float vs_inv, float trunc, void* work, void* depth,
                           void* stream) {
  if (D < 1 || H < 1 || W < 1 || h < 0 || w < 0 || n_steps < 2 ||
      fine_steps < 1 || n_brackets < 0 || (h + kTileV - 1) / kTileV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Grid g;
  g.tsdf = static_cast<const float*>(tsdf);
  g.weight = static_cast<const float*>(weight);
  g.D = D;
  g.H = H;
  g.W = W;
  g.words = (W + 31) / 32;
  g.trunc = trunc;
  const long long words = static_cast<long long>(D) * H * g.words;
  if (words >= (1LL << 31) - kMaskThreads * kWordsPerWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_words = static_cast<int>(words);
  uint2* flags = static_cast<uint2*>(work);
  uint2* mask = flags + n_words;
  const int per_block = kMaskThreads / 32 * kWordsPerWarp;
  raycast_flags_kernel<<<(n_words + per_block - 1) / per_block, kMaskThreads,
                         0, s>>>(g, n_words, flags);
  raycast_mask_kernel<<<(n_words + kMaskThreads - 1) / kMaskThreads,
                        kMaskThreads, 0, s>>>(g, n_words, flags, mask);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || h == 0 || w == 0) return static_cast<int>(e);
  March p;
  p.g = g;
  p.mask = static_cast<const uint2*>(mask);
  p.T_wc = static_cast<const float*>(T_wc);
  p.origin = static_cast<const float*>(origin);
  p.ts = static_cast<const float*>(ts);
  p.offs = static_cast<const float*>(offs);
  p.ray_u = static_cast<const float*>(ray_u);
  p.ray_v = static_cast<const float*>(ray_v);
  p.depth = static_cast<float*>(depth);
  p.h = h;
  p.w = w;
  p.n_steps = n_steps;
  p.fine_steps = fine_steps;
  p.n_brackets = n_brackets;
  p.vs_inv = vs_inv;
  const dim3 grid((w + kTileU - 1) / kTileU, (h + kTileV - 1) / kTileV);
  raycast_march_kernel<<<grid, dim3(kTileU, kTileV), 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* osn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
