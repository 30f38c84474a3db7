// K2 and K3: DepthNet populate-and-shade, rays + predicted depth -> composited maps.
//
// Replaces nerf_sampling_tpu/kernels/fused_render.py::_call (the
// pl.pallas_call at :390) in two of its populate modes (_kernel, :203-344):
//   K2, z_source="around_center" (fused_render_around_depth):
//     z_s = clip(depth + offsets[s], near, far), offsets = std * sorted(
//     linspace(-1, 1, S-1) U {0}); a NaN depth stays NaN; already sorted.
//   K3, z_source="gaussian" (fused_render_gaussian, :558-610):
//     z_s = depth + std * noise_s for s < S-1 and z_{S-1} = depth, with no
//     clip; noise is Box-Muller over Philox keyed by (seed, ray)
//     (philox.cuh), or injected. Each ray's z is sorted (stable, NaN last)
//     before shading, so the in-order compositing below is the reference's
//     sort-then-composite. The TPU kernel composited in storage order with
//     an order-free O(S^2) product instead; here the sort is one rank pass.
// Then, for both: fp32 positional encoding of o + z*d and of the unit view
// direction, rounded to bf16; the 8x256 NeRF MLP (nerf_mlp.cuh: bf16
// operands, fp32 accumulation); compositing in sample order with dists
// z[s+1]-z[s] and a 1e10 tail, both scaled by |d|, alpha =
// 1-exp(-relu(sigma)*dist), the exclusive product of 1-alpha+1e-10, and a
// white background.
//
// What bounds it on the H100: about 1.2 MFLOP per sample on the tensor
// cores, 12 TFLOP per 400x400 frame at 64 samples, against 1.2 MB of bf16
// weights that stay in L2; device-memory traffic is 40 bytes per ray (plus
// 4(S-1) with injected noise). The matrix products bound it. This version
// streams the weights from L2 per 64-row chunk through wmma fragments (no
// TMA, no wgmma): simple and right first, fast in a later change.
//
// Design: one block per group of R rays (R*S <= 1024 sample rows), two
// blocks per SM. Compositing walks each ray's samples in order, one thread
// per ray. None of the TPU kernel's Mosaic devices (affine-in-z S matrix,
// rotation PE, ones-row reductions, order-free compositor) is needed here.

#include <cuda_runtime.h>

#include "nerf_mlp.cuh"
#include "philox.cuh"

namespace nst {
namespace {

constexpr int kMaxRows = 1024;   // sample rows per block
constexpr int kMaxRays = 64;     // rays per block

struct RenderParams {
  const float* rays_o;   // [n, 3]
  const float* rays_d;   // [n, 3]
  const float* depth;    // [n]
  const float* offsets;  // uniform: [S], std-scaled, sorted
  const float* noise;    // gaussian: [n, S-1] injected draws, or null
  float* out;            // [6, n]: r, g, b, disp, acc, depth
  long long n;
  int S, R;
  int gaussian;          // 0: uniform (K2), 1: gaussian (K3)
  float near_, far_;     // uniform clip
  float std_;            // gaussian
  unsigned seed;         // gaussian, when noise is null
  int white_bkgd;
  NerfWeights w;
};

constexpr size_t kSmemBytes = kTileBytes + (5 * kMaxRows + 8 * kMaxRays) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
    render_around_depth_kernel(const __grid_constant__ RenderParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t = carve_tiles(smem);
  float* zp = reinterpret_cast<float*>(smem + kTileBytes);
  float* sigma = zp + kMaxRows;
  float* plane[3] = {sigma + kMaxRows, sigma + 2 * kMaxRows, sigma + 3 * kMaxRows};
  float* ray = sigma + 4 * kMaxRows;  // per ray: o[3], d[3], |d|, depth

  const int tid = threadIdx.x;
  const int S = p.S;
  const long long ray0 = (long long)blockIdx.x * p.R;
  const int nr = (int)min((long long)p.R, p.n - ray0);
  const int rows = nr * S;

  for (int r = tid; r < nr; r += kThreads) {
    float* q = ray + 8 * r;
    for (int c = 0; c < 3; ++c) {
      q[c] = p.rays_o[(ray0 + r) * 3 + c];
      q[3 + c] = p.rays_d[(ray0 + r) * 3 + c];
    }
    q[6] = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5]);
    q[7] = p.depth[ray0 + r];
  }
  __syncthreads();
  if (!p.gaussian) {
    for (int row = tid; row < rows; row += kThreads) {
      const float v = ray[8 * (row / S) + 7] + p.offsets[row % S];
      zp[row] = isnan(v) ? v : fminf(fmaxf(v, p.near_), p.far_);
    }
  } else {
    // the population, unsorted, in the sigma plane (free until the MLP)
    for (int row = tid; row < rows; row += kThreads) {
      const int r = row / S, s = row - r * S;
      const float c = ray[8 * r + 7];
      float v = c;
      if (s < S - 1) {
        const long long g = ray0 + r;
        const float nz = p.noise ? p.noise[g * (S - 1) + s]
                                 : gaussian_normal(p.seed, (uint32_t)g, (uint32_t)s);
        v = __fadd_rn(c, __fmul_rn(p.std_, nz));  // as the plain version: no FMA
      }
      sigma[row] = v;
    }
    __syncthreads();
    sort_rows(sigma, zp, nr, S);
  }
  __syncthreads();

  nerf_rows(p.w, t, ray, zp, rows, S, false, sigma, plane);

  // compositing in sample order, one thread per ray
  for (int r = tid; r < nr; r += kThreads) {
    const float dn = ray[8 * r + 6];
    float T = 1.f, acc = 0.f, dep = 0.f, c[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      const int row = r * S + s;
      const float z = zp[row];
      const float dist = (s < S - 1 ? zp[row + 1] - z : 1e10f) * dn;
      const float sg = sigma[row] < 0.f ? 0.f : sigma[row];
      const float alpha = 1.f - expf(-sg * dist);
      const float w = alpha * T;
      acc += w;
      dep += w * z;
      for (int k = 0; k < 3; ++k) c[k] += w * plane[k][row];
      T *= 1.f - alpha + 1e-10f;
    }
    const float q = dep / (acc + 1e-10f);
    const long long g = ray0 + r;
    for (int k = 0; k < 3; ++k) p.out[k * p.n + g] = p.white_bkgd ? c[k] + (1.f - acc) : c[k];
    p.out[3 * p.n + g] = 1.f / (q < 1e-10f ? 1e-10f : q);
    p.out[4 * p.n + g] = acc;
    p.out[5 * p.n + g] = dep;
  }
}

// ptrs, in order: rays_o, rays_d, depth, z_arg (offsets or noise, may be
// null for noise), out; then the NeRF's weights (nerf_mlp.cuh::read_weights).
int launch(const void* const* ptrs, int n_ptrs, long long n, int S, int D, unsigned skip_mask,
           RenderParams p, void* stream) {
  if (S < 1 || S > 512) return (int)cudaErrorInvalidValue;
  p.rays_o = static_cast<const float*>(ptrs[0]);
  p.rays_d = static_cast<const float*>(ptrs[1]);
  p.depth = static_cast<const float*>(ptrs[2]);
  if (p.gaussian)
    p.noise = static_cast<const float*>(ptrs[3]);
  else
    p.offsets = static_cast<const float*>(ptrs[3]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[4]));
  const int k = read_weights(ptrs + 5, D, skip_mask, false, &p.w);
  if (k < 0 || n_ptrs != 5 + k) return (int)cudaErrorInvalidValue;
  p.n = n;
  p.S = S;
  p.R = kMaxRows / S < kMaxRays ? kMaxRows / S : kMaxRays;  // >= 2 for S <= 512

  cudaError_t err = cudaFuncSetAttribute(render_around_depth_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + p.R - 1) / p.R);
  render_around_depth_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace nst

// K2. Returns a cudaError_t (0 on success).
extern "C" int nst_render_around_depth(const void* const* ptrs, int n_ptrs, long long n, int S, int D,
                                       unsigned skip_mask, float near_, float far_, int white_bkgd,
                                       void* stream) {
  nst::RenderParams p = {};
  p.gaussian = 0;
  p.near_ = near_;
  p.far_ = far_;
  p.white_bkgd = white_bkgd;
  return nst::launch(ptrs, n_ptrs, n, S, D, skip_mask, p, stream);
}

// K3: ptrs[3] is the injected noise [n, S-1] or null (Philox draws keyed by
// (seed, ray)). Returns a cudaError_t (0 on success).
extern "C" int nst_render_gaussian(const void* const* ptrs, int n_ptrs, long long n, int S, int D,
                                   unsigned skip_mask, float std_, unsigned seed, int white_bkgd,
                                   void* stream) {
  if (S < 2) return (int)cudaErrorInvalidValue;
  nst::RenderParams p = {};
  p.gaussian = 1;
  p.std_ = std_;
  p.seed = seed;
  p.white_bkgd = white_bkgd;
  return nst::launch(ptrs, n_ptrs, n, S, D, skip_mask, p, stream);
}
