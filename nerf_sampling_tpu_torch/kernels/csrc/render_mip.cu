// K11: mip-NeRF's two-level render, rays -> rgb, distance and acc, in one
// launch (kernels/fused_mip.py; google/mipnerf internal/models.py at test
// time, randomized off).
//
// Per ray, with S intervals a level and T = S + 1 t-values:
//   1. the first level's t-values near (1 - t) + far t, t = i fl(1/S) and
//      exactly 1 at the end (jnp.linspace as XLA computes it);
//   2. the MLP's trunk and density head over the S intervals (the IPE of
//      each interval's conical frustum: mlp_wgmma.cuh::ipe_fill), then the
//      weights: density softplus(raw + density_bias), delta (t1 - t0) |d|,
//      w = (1 - exp(-density delta)) exp(-sum of the earlier density deltas);
//   3. mip-NeRF's resampling (mip.resample_along_rays,
//      math.sorted_piecewise_constant_pdf): the weights' blurpool (the max
//      of neighbours, the ends repeated, then the mean of neighbours) plus
//      the padding, their sum padded to 1e-5, the pdf and its CDF pinned to
//      0 and 1, and T new t-values at u = (1 - eps) i fl(1/S): each u in
//      the last interval whose CDF entry it reaches (a binary search, which
//      on a sorted CDF gives the published mask max/min form's interval),
//      the interpolant with NaN taken as 0, clipped to [0, 1]. They are not
//      merged with the first level's;
//   4. the same MLP in full over the new intervals (the view encoding in the
//      PE tile's last columns), rgb = sigmoid(raw) rgb_scale - rgb_padding,
//      and the compositing: rgb, acc, distance = sum(w t_mid) / acc with
//      NaN taken as 0 (the published nan_to_num call's effect) clipped to
//      [t_0, t_S], a white background.
// bf16 products with fp32 sums on the wgmma core, as K7; everything outside
// the products fp32, without fused multiply-adds where the plain version
// rounds each step; the sums over a ray left to right, as the plain version.
//
// Design: K7's block (render_hier.cu): 288 threads, two consumer
// warpgroups on 128-row tiles and the producer warp, one block per SM, R =
// min(1536 / S, 16) rays (12 at S = 128: 1536 interval rows a level). One
// slice image serves both levels: the producer streams, tile by tile, its
// prefix of mip_forward_slices(sigma_only) for the first level, then all
// of it for the second. The PE tile's two panels hold the 96 IPE columns
// and the 27 view columns (nerf_forward<S, 2>: layer 0 and the skip layer
// read both panels, their weight rows past the IPE zero; the views layer
// reads the second, its IPE rows zero). Six fp32 planes of R * T floats:
// the two levels' t-values, sigma, and three planes that hold the first
// level's weights, blurred weights and CDF until the second level writes
// its rgb logits there.

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"
#include "nerf_mlp.cuh"

namespace nst {
namespace {

constexpr int kMaxRays = 16;                     // rays per block
constexpr int kMaxRows = 1536;                   // interval rows per level and block
constexpr int kPlane = kMaxRows + kMaxRays;      // T = S + 1 t-values a ray
constexpr int kMaxIntervals = 512;
constexpr float kOneMinusEps = 0.99999988079071044921875f;  // 1 - 2^-23
constexpr size_t kMlpBytes = wg::mlp_bytes<bf16>();
constexpr size_t kSmem = kMlpBytes + (6 * kPlane + 8 * kMaxRays) * sizeof(float) + kMaxRays * 32 * sizeof(bf16);

struct MipParams {
  const float* rays_o;  // [n, 3]
  const float* rays_d;  // [n, 3]
  const float* radii;   // [n]
  float* out;           // [5, n]: r g b distance acc
  long long n;
  int S, R;
  float near_, far_;
  int white_bkgd, integrate;
  float density_bias, rgb_scale, rgb_padding, resample_padding;
  NerfWeights w;
  const bf16* slices;  // the full forward's; the first level reads its prefix
  int n_sigma, n_full;
};

// jnp.maximum / jnp.minimum: NaN if either is
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) { return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x)))); }

// The weights of one ray's S intervals into w[0..S): raw densities sg,
// t-values tv (S + 1), |d| dn
__device__ __forceinline__ void interval_weights(const float* sg, const float* tv, int S, float dn, float bias,
                                                 float* w) {
  float cum = 0.f;
  for (int s = 0; s < S; ++s) {
    const float dd = __fmul_rn(softplus(__fadd_rn(sg[s], bias)), __fmul_rn(__fsub_rn(tv[s + 1], tv[s]), dn));
    w[s] = __fmul_rn(__fsub_rn(1.f, expf(-dd)), expf(-cum));
    cum = __fadd_rn(cum, dd);
  }
}

// The MLP over rows [0, rows) of the intervals of t-value plane tv: sigma[row]
// and, unless sigma_only, the rgb logits rgb[0..2][row]. Consumer threads;
// ends without a block-wide barrier.
__device__ void mip_rows(const NerfWeights& w, const wg::RenderTiles<bf16>& t, wg::Cursor& cur, const float* ray,
                         const bf16* view, const float* tv, int rows, int S, bool sigma_only, bool integrate,
                         float* sigma, float* const* rgb) {
  for (int c0 = 0; c0 < rows; c0 += wg::kRows) {
    wg::ipe_fill(t.pe, ray, view, tv, c0, rows, S, integrate);
    float* rgb_c[3] = {nullptr, nullptr, nullptr};
    if (!sigma_only)
      for (int k = 0; k < 3; ++k) rgb_c[k] = rgb[k] + c0;
    wg::nerf_forward<wg::kRenderStages, 2>(w, t, cur, rows - c0, sigma_only, sigma + c0, rgb_c, true);
  }
}

__global__ void __launch_bounds__(wg::kThreads, 1) render_mip_kernel(const __grid_constant__ MipParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* tc = reinterpret_cast<float*>(smem + kMlpBytes);  // the first level's t-values
  float* tf = tc + kPlane;                                 // the second level's
  float* sg = tf + kPlane;
  float* plane[3] = {sg + kPlane, sg + 2 * kPlane, sg + 3 * kPlane};
  float* ray = sg + 4 * kPlane;                           // per ray: o[3], d[3], |d|, radius
  bf16* view = reinterpret_cast<bf16*>(ray + 8 * kMaxRays);  // per ray: the view encoding
  const long long ray0 = (long long)blockIdx.x * p.R;
  const int nr = (int)min((long long)p.R, p.n - ray0);
  const int S = p.S, T = S + 1;

  const wg::RenderTiles<bf16> t = wg::carve_render<bf16>(smem);
  wg::Cursor cur;
  __syncthreads();
  if ((int)threadIdx.x >= wg::kConsumers) {  // the producer: both levels' slices, tile by tile
    const int tiles = (nr * S + wg::kRows - 1) / wg::kRows;
    const wg::Segment segs[2] = {{p.slices, p.n_sigma, tiles}, {p.slices, p.n_full, tiles}};
    wg::produce(t.ring, segs, 2);
    return;
  }
  const int tid = threadIdx.x;
  for (int r = tid; r < nr; r += wg::kConsumers) {
    float* q = ray + 8 * r;
    for (int c = 0; c < 3; ++c) {
      q[c] = p.rays_o[(ray0 + r) * 3 + c];
      q[3 + c] = p.rays_d[(ray0 + r) * 3 + c];
    }
    q[6] = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(q[3], q[3]), __fmul_rn(q[4], q[4])), __fmul_rn(q[5], q[5])));
    q[7] = p.radii[ray0 + r];
  }
  // 1. the first level's t-values
  const float step = 1.f / (float)S;
  for (int e = tid; e < nr * T; e += wg::kConsumers) {
    const int i = e % T;
    const float s = i == S ? 1.f : __fmul_rn((float)i, step);
    tc[e] = __fadd_rn(__fmul_rn(p.near_, __fsub_rn(1.f, s)), __fmul_rn(p.far_, s));
  }
  wg::consumers_sync();                // the rays, before their view encodings
  wg::stage_mip_views(ray, nr, view);  // ends with the consumers' barrier

  // 2. the first level's densities and weights
  mip_rows(p.w, t, cur, ray, view, tc, nr * S, S, true, p.integrate, sg, plane);
  wg::consumers_sync();
  for (int r = tid; r < nr; r += wg::kConsumers) {
    const float* tv = tc + r * T;
    float* w = plane[0] + r * S;
    float* wb = plane[1] + r * S;
    float* cdf = plane[2] + r * T;
    interval_weights(sg + r * S, tv, S, ray[8 * r + 6], p.density_bias, w);
    // 3. the blurpool, the padding, the pdf and the CDF
    float sum = 0.f;
    for (int s = 0; s < S; ++s) {
      const float a = nan_max(w[s > 0 ? s - 1 : 0], w[s]), b = nan_max(w[s], w[s < S - 1 ? s + 1 : S - 1]);
      wb[s] = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(a, b)), p.resample_padding);
      sum = __fadd_rn(sum, wb[s]);
    }
    const float pad = nan_max(0.f, __fsub_rn(1e-5f, sum));
    const float pad_s = __fdiv_rn(pad, (float)S), total = __fadd_rn(sum, pad);
    float run = 0.f;
    cdf[0] = 0.f;
    for (int k = 1; k < S; ++k) {
      run = __fadd_rn(run, __fdiv_rn(__fadd_rn(wb[k - 1], pad_s), total));
      cdf[k] = nan_min(1.f, run);
    }
    cdf[S] = 1.f;
  }
  wg::consumers_sync();
  for (int e = tid; e < nr * T; e += wg::kConsumers) {
    const int r = e / T, i = e - r * T;
    const float* c = plane[2] + r * T;
    const float* b = tc + r * T;
    const float u = __fmul_rn(kOneMinusEps, i == S ? 1.f : __fmul_rn((float)i, step));
    int lo = 0, hi = T;  // the CDF entries <= u
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c[mid] <= u) lo = mid + 1; else hi = mid;
    }
    const int j0 = lo > 0 ? lo - 1 : 0, j1 = j0 + 1 < T ? j0 + 1 : T - 1;
    float x = __fdiv_rn(__fsub_rn(u, c[j0]), __fsub_rn(c[j1], c[j0]));
    x = x != x ? 0.f : fminf(fmaxf(x, 0.f), 1.f);
    tf[e] = __fadd_rn(b[j0], __fmul_rn(x, __fsub_rn(b[j1], b[j0])));
  }
  wg::consumers_sync();

  // 4. the second level in full, then the compositing
  mip_rows(p.w, t, cur, ray, view, tf, nr * S, S, false, p.integrate, sg, plane);
  wg::consumers_sync();
  for (int r = tid; r < nr; r += wg::kConsumers) {
    const float* tv = tf + r * T;
    const float dn = ray[8 * r + 6];
    float cum = 0.f, acc = 0.f, dsum = 0.f, c[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      const int row = r * S + s;
      const float dd = __fmul_rn(softplus(__fadd_rn(sg[row], p.density_bias)),
                                 __fmul_rn(__fsub_rn(tv[s + 1], tv[s]), dn));
      const float w = __fmul_rn(__fsub_rn(1.f, expf(-dd)), expf(-cum));
      cum = __fadd_rn(cum, dd);
      for (int k = 0; k < 3; ++k) {
        const float rgb = __fsub_rn(__fmul_rn(1.f / (1.f + expf(-plane[k][row])), p.rgb_scale), p.rgb_padding);
        c[k] = __fadd_rn(c[k], __fmul_rn(w, rgb));
      }
      acc = __fadd_rn(acc, w);
      dsum = __fadd_rn(dsum, __fmul_rn(w, __fmul_rn(0.5f, __fadd_rn(tv[s], tv[s + 1]))));
    }
    float dist = __fdiv_rn(dsum, acc);
    dist = dist != dist ? 0.f : dist;
    dist = fminf(fmaxf(dist, tv[0]), tv[S]);
    const long long g = ray0 + r, n = p.n;
    for (int k = 0; k < 3; ++k) p.out[k * n + g] = p.white_bkgd ? __fadd_rn(c[k], __fsub_rn(1.f, acc)) : c[k];
    p.out[3 * n + g] = dist;
    p.out[4 * n + g] = acc;
  }
}

constexpr int rays_per_block(int S) { return kMaxRows / S < kMaxRays ? kMaxRows / S : kMaxRays; }

}  // namespace
}  // namespace nst

// ptrs, in order: rays_o, rays_d, radii, out; the MLP's weight slices
// (fused_render.pack_slices of a fused_mip.pack_mip pack: the full forward,
// whose prefix the first level reads); its epilogue vectors
// (nerf_mlp.cuh::read_weights, all heads). A launch without the slices is
// refused. integrate 0: every variance of the IPE 0 (mip-NeRF's
// disable_integration). Returns a cudaError_t (0 on success).
extern "C" int nst_render_mip(const void* const* ptrs, int n_ptrs, long long n, int S, int D, unsigned skip,
                              float near_, float far_, int white_bkgd, int integrate, float density_bias,
                              float rgb_scale, float rgb_padding, float resample_padding, void* stream) {
  using namespace nst;
  if (S < 4 || S > kMaxIntervals || n < 0) return (int)cudaErrorInvalidValue;
  MipParams p = {};
  p.rays_o = static_cast<const float*>(ptrs[0]);
  p.rays_d = static_cast<const float*>(ptrs[1]);
  p.radii = static_cast<const float*>(ptrs[2]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[3]));
  p.slices = static_cast<const bf16*>(ptrs[4]);
  const int k = read_weights(ptrs + 5, D, skip, false, &p.w);
  if (k < 0 || n_ptrs != 5 + k || !p.slices) return (int)cudaErrorInvalidValue;
  p.n_sigma = wg::mip_forward_slices(D, skip, true);
  p.n_full = wg::mip_forward_slices(D, skip, false);
  p.n = n;
  p.S = S;
  p.R = rays_per_block(S);
  p.near_ = near_;
  p.far_ = far_;
  p.white_bkgd = white_bkgd;
  p.integrate = integrate;
  p.density_bias = density_bias;
  p.rgb_scale = rgb_scale;
  p.rgb_padding = rgb_padding;
  p.resample_padding = resample_padding;
  cudaError_t err = cudaFuncSetAttribute(render_mip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + p.R - 1) / p.R);
  render_mip_kernel<<<grid, wg::kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K11's launch shape at S intervals a level: resident blocks per SM, rays
// per block, threads per block and dynamic shared memory.
extern "C" int nst_render_mip_occupancy(int S, int* out) {
  using namespace nst;
  if (S < 4 || S > kMaxIntervals) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(render_mip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  out[1] = rays_per_block(S);
  out[2] = wg::kThreads;
  out[3] = (int)kSmem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, render_mip_kernel, out[2], kSmem);
}
