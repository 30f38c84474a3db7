// K2, K3, K8 and K9: populate-and-shade, rays (+ depths) -> composited maps.
//
// Replaces nerf_sampling_tpu/kernels/fused_render.py::_call (the
// pl.pallas_call at :390) in its populate modes (_kernel, :203-344):
//   K2, z_source="around_center" (fused_render_around_depth):
//     z_s = clip(depth + offsets[s], near, far), offsets = std * sorted(
//     linspace(-1, 1, S-1) U {0}); a NaN depth stays NaN; already sorted.
//   K3, z_source="gaussian" (fused_render_gaussian, :558-610):
//     z_s = depth + std * noise_s for s < S-1 and z_{S-1} = depth, with no
//     clip; noise is Box-Muller over Philox keyed by (seed, global ray
//     index = ray_base + row) (philox.cuh), or injected. Each ray's z is sorted (stable, NaN last)
//     before shading, so the in-order compositing below is the reference's
//     sort-then-composite. The TPU kernel composited in storage order with
//     an order-free O(S^2) product instead; here the sort is one rank pass.
//   K8, z_source="linspace" (fused_render, :447-488): the eval grid at
//     perturb 0, the same for every ray, with the TPU kernel's rounding
//     (:278-286), not jnp.linspace's: t = s / (S-1) as a true fp32 division
//     (0 when S = 1), then v = a*(1-t) + b*t in four rounded fp32 steps, no
//     fused multiply-add; z = v with (a, b) = (near, far), or z = 1/v with
//     (a, b) = (1/near, 1/far) for lindisp (the wrapper rounds 1/near and
//     1/far to fp32 once, as the JAX kernel's Python constants are). No
//     rotation-recurrence PE: it drifts about 2e-4 in fp32 (:298-303).
//   K9, z_source="input" / "input_unsorted" (fused_shade, :613-659): the
//     caller's z [n, S]. "input" is taken as sorted; "input_unsorted" is
//     sorted per ray by K3's rank pass first, which is the stable sort by
//     (z, index) that the TPU kernel's order-free compositor reproduces
//     (ops.unsorted_weights), NaN last.
// Then, for all: fp32 positional encoding of o + z*d and of the unit view
// direction; the 8x256 NeRF MLP on the wgmma core (mlp_wgmma.cuh);
// compositing in sample
// order with dists z[s+1]-z[s] and a 1e10 tail, both scaled by |d|, alpha =
// 1-exp(-relu(sigma)*dist), the exclusive product of 1-alpha+1e-10, and a
// white background. Element type T: bf16 (bf16 PE, weights and
// activations, fp32 accumulation), fp32 throughout (K8 and K9 in the
// COMPARE mode), or int8 for all four modes: the W8A8 MLP of
// kernels/quant.py (K10, the core's s8 forward), selected by an int8 plan;
// the z sources and the compositing are the same in every type.
//
// What bounds it on the H100: about 1.2 MFLOP per sample, 12 TFLOP per
// 400x400 frame at 64 samples, against 1.2 MB of bf16 weights (2.4 MB
// fp32, 0.6 MB int8) that stay in L2; device-memory traffic is 40 bytes
// per ray (plus 4(S-1) with injected noise, 4S with input z). The matrix
// products bound it: on the tensor cores in bf16 (989 TFLOP/s), in int8
// for 557,056 of a query's 593,408 multiply-adds (1,979 TOP/s), in fp32 as
// 3xTF32 on the tensor cores (three tf32 products at 494.7 TFLOP/s: 74 ms a
// frame at 64 samples, against 181 ms on the FMA units' 67 TFLOP/s).
//
// Design: one block per group of R rays (R*S <= kMaxRows sample rows, at
// most 64 rays). Every type runs the MLP on the wgmma core (mlp_wgmma.cuh),
// as K6/K7 do, a producer warp streaming the NeRF's full-forward weight
// slices (cp.async.bulk into an mbarrier ring) once per tile while the
// consumers do everything else (the ray loads, the population, the sort,
// the PE, the products' epilogues and the compositing), one block per SM:
//   bf16 and int8: 288 threads, two consumer warpgroups on 128-row tiles, a
//     5-stage ring; rows = 1536, so 24 rays a block at S = 64 and 3 at S =
//     512; int8 runs the s8 forward (nerf_forward on NerfWeightsQ: s8
//     products, nerf_mlp.cuh's requants) on the same tiles and ring, so
//     its shared memory is bf16's 218,192 bytes (4,096 of them the rays'
//     staged view embeddings: mlp_wgmma.cuh's PE fill);
//   fp32 (K8/K9 in COMPARE): 160 threads, one consumer warpgroup on 64-row
//     tiles with 3xTF32 products and its activations in a thread-private
//     store, a 6-stage ring (the fp32 path of mlp_wgmma.cuh, as K7 fp32);
//     rows = 1024, so 16 rays a block at S = 64 and 2 at S = 512.
// Compositing walks each ray's samples in order, one thread per ray. None
// of the TPU kernel's Mosaic devices (affine-in-z S matrix, rotation PE,
// ones-row reductions, order-free compositor) is needed here.

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"
#include "nerf_mlp.cuh"
#include "philox.cuh"

namespace nst {
namespace {

constexpr int kMaxRays = 64;  // rays per block

template <typename T>
constexpr int kMaxRows = std::is_same_v<T, float> ? 1024 : 1536;  // sample rows per block
template <typename T>
constexpr int kWorkers = wg::kWorkers<T>;  // the consumers: they do the kernel's work

enum ZSource { kAroundCenter = 0, kGaussian = 1, kLinspace = 2, kInput = 3, kInputUnsorted = 4 };

template <typename T>
struct RenderParams {
  const float* rays_o;   // [n, 3]
  const float* rays_d;   // [n, 3]
  const float* depth;    // around_center, gaussian: [n]
  const float* z_arg;    // around_center: offsets [S], std-scaled, sorted;
                         // gaussian: injected noise [n, S-1] or null; input: z [n, S]
  float* out;            // [6, n]: r, g, b, disp, acc, depth
  long long n;
  int S, R;
  int source;            // ZSource
  float near_, far_;     // around_center: the clip; linspace: the grid ends a, b
  int lindisp;           // linspace: z = 1/v
  float std_;            // gaussian
  unsigned seed;         // gaussian, when the noise is null
  long long ray_base;    // gaussian: the global index of ray 0; Philox is keyed by ray_base + g
  int white_bkgd;
  NerfWeightsT<T> w;
  const bf16* slices;    // the NeRF's full-forward weight slices (mlp_wgmma.cuh; int8: bf16 and s8; fp32: hi and lo)
  int n_slices;
};

// bf16 and int8 also stage each ray's view embedding (mlp_wgmma.cuh::stage_views, 64 bytes a ray)
template <typename T>
constexpr size_t smem_bytes() {
  return wg::mlp_bytes<T>() + (5 * kMaxRows<T> + 8 * kMaxRays) * sizeof(float) +
         (wg::kCore32<T> ? 0 : kMaxRays * 32 * sizeof(bf16));
}

// Rays per block at S samples (>= 2 at 512).
template <typename T>
constexpr int rays_per_block(int S) {
  return kMaxRows<T> / S < kMaxRays ? kMaxRows<T> / S : kMaxRays;
}

template <typename T>
__global__ void __launch_bounds__(wg::kBlockThreads<T>, 1)
    render_around_depth_kernel(const __grid_constant__ RenderParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* zp = reinterpret_cast<float*>(smem + wg::mlp_bytes<T>());
  float* sigma = zp + kMaxRows<T>;
  float* plane[3] = {sigma + kMaxRows<T>, sigma + 2 * kMaxRows<T>, sigma + 3 * kMaxRows<T>};
  float* ray = sigma + 4 * kMaxRows<T>;  // per ray: o[3], d[3], |d|, depth
  bf16* view = reinterpret_cast<bf16*>(ray + 8 * kMaxRays);  // bf16, int8: per ray, the view embedding

  const int tid = threadIdx.x;
  const int S = p.S;
  const long long ray0 = (long long)blockIdx.x * p.R;
  const int nr = (int)min((long long)p.R, p.n - ray0);
  const int rows = nr * S;
  const bool centered = p.source == kAroundCenter || p.source == kGaussian;

  const wg::RenderTiles<T> t = wg::carve_render<T>(smem);
  wg::Cursor cur;
  __syncthreads();
  if (tid >= kWorkers<T>) {  // the producer: the full forward's slices, tile by tile
    constexpr int tile = wg::kTileRows<T>;
    const wg::Segment seg = {p.slices, p.n_slices, (rows + tile - 1) / tile};
    wg::produce(t.ring, &seg, 1, kWorkers<T>);
    return;
  }
  // the consumers' barrier (the producer warp never joins)
  auto sync = [] {
    if constexpr (wg::kCore32<T>) wg::group_sync();
    else wg::consumers_sync();
  };

  for (int r = tid; r < nr; r += kWorkers<T>) {
    float* q = ray + 8 * r;
    for (int c = 0; c < 3; ++c) {
      q[c] = p.rays_o[(ray0 + r) * 3 + c];
      q[3 + c] = p.rays_d[(ray0 + r) * 3 + c];
    }
    q[6] = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5]);
    q[7] = centered ? p.depth[ray0 + r] : 0.f;
  }
  sync();
  if (p.source == kAroundCenter) {
    for (int row = tid; row < rows; row += kWorkers<T>) {
      const float v = ray[8 * (row / S) + 7] + p.z_arg[row % S];
      zp[row] = isnan(v) ? v : fminf(fmaxf(v, p.near_), p.far_);
    }
  } else if (p.source == kLinspace) {
    for (int row = tid; row < rows; row += kWorkers<T>) {
      const float tv = __fdiv_rn((float)(row % S), (float)(S > 1 ? S - 1 : 1));
      const float v = __fadd_rn(__fmul_rn(p.near_, __fsub_rn(1.f, tv)), __fmul_rn(p.far_, tv));
      zp[row] = p.lindisp ? __fdiv_rn(1.f, v) : v;
    }
  } else if (p.source == kInput) {
    for (int row = tid; row < rows; row += kWorkers<T>) zp[row] = p.z_arg[ray0 * S + row];
  } else {
    // the unsorted population in the sigma plane (free until the MLP)
    for (int row = tid; row < rows; row += kWorkers<T>) {
      float v;
      if (p.source == kInputUnsorted) {
        v = p.z_arg[ray0 * S + row];
      } else {  // gaussian
        const int r = row / S, s = row - r * S;
        v = ray[8 * r + 7];
        if (s < S - 1) {
          const long long g = ray0 + r;
          const float nz = p.z_arg ? p.z_arg[g * (S - 1) + s]
                                   : gaussian_normal(p.seed, (uint32_t)(p.ray_base + g), (uint32_t)s);
          v = __fadd_rn(v, __fmul_rn(p.std_, nz));  // as the plain version: no FMA
        }
      }
      sigma[row] = v;
    }
    sync();
    sort_rows(sigma, zp, nr, S, kWorkers<T>);
  }
  sync();

  if constexpr (wg::kCore32<T>) wg::nerf_rows(p.w, t, cur, ray, zp, rows, S, false, sigma, plane);
  else wg::nerf_rows(p.w, t, cur, ray, view, zp, rows, S, false, sigma, plane);
  sync();

  // compositing in sample order, one thread per ray
  for (int r = tid; r < nr; r += kWorkers<T>) {
    const float dn = ray[8 * r + 6];
    float T_ = 1.f, acc = 0.f, dep = 0.f, c[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      const int row = r * S + s;
      const float z = zp[row];
      const float dist = (s < S - 1 ? zp[row + 1] - z : 1e10f) * dn;
      const float sg = sigma[row] < 0.f ? 0.f : sigma[row];
      const float alpha = 1.f - expf(-sg * dist);
      const float w = alpha * T_;
      acc += w;
      dep += w * z;
      for (int k = 0; k < 3; ++k) c[k] += w * plane[k][row];
      T_ *= 1.f - alpha + 1e-10f;
    }
    const float q = dep / (acc + 1e-10f);
    const long long g = ray0 + r;
    for (int k = 0; k < 3; ++k) p.out[k * p.n + g] = p.white_bkgd ? c[k] + (1.f - acc) : c[k];
    p.out[3 * p.n + g] = 1.f / (q < 1e-10f ? 1e-10f : q);
    p.out[4 * p.n + g] = acc;
    p.out[5 * p.n + g] = dep;
  }
}

// ptrs, in order: rays_o, rays_d, depth (may be null), z_arg (may be
// null), out; then the NeRF's full-forward weight slices (mlp_wgmma.cuh:
// forward_slices, forward_qslices, forward_slices32); then its epilogue
// vectors (nerf_mlp.cuh::read_pack; plan: the int8 constants, null for bf16
// and fp32). A launch without the slices is refused.
template <typename T>
int launch(const void* const* ptrs, int n_ptrs, long long n, int S, int D, unsigned skip_mask,
           RenderParams<T> p, const int* plan, void* stream) {
  if (S < 1 || S > 512) return (int)cudaErrorInvalidValue;
  p.rays_o = static_cast<const float*>(ptrs[0]);
  p.rays_d = static_cast<const float*>(ptrs[1]);
  p.depth = static_cast<const float*>(ptrs[2]);
  p.z_arg = static_cast<const float*>(ptrs[3]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[4]));
  p.slices = static_cast<const bf16*>(ptrs[5]);
  const int k = read_pack(ptrs + 6, D, skip_mask, false, plan, &p.w);
  if (k < 0 || n_ptrs != 6 + k || !p.slices) return (int)cudaErrorInvalidValue;
  p.n_slices = wg::kCore32<T>                  ? wg::forward_slices32(D, skip_mask, false)
               : std::is_same_v<T, int8_t>     ? wg::forward_qslices(D, skip_mask, false)
                                               : wg::forward_slices(D, skip_mask, false);
  p.n = n;
  p.S = S;
  p.R = rays_per_block<T>(S);

  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(render_around_depth_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + p.R - 1) / p.R);
  render_around_depth_kernel<T><<<grid, wg::kBlockThreads<T>, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* const* ptrs, int n_ptrs, long long n, int S, int D, unsigned skip_mask,
                 int source, float a, float b, int lindisp, int white_bkgd, float std_, unsigned seed,
                 long long ray_base, const int* plan, void* stream) {
  RenderParams<T> p = {};
  p.source = source;
  p.near_ = a;
  p.far_ = b;
  p.lindisp = lindisp;
  p.white_bkgd = white_bkgd;
  p.std_ = std_;
  p.seed = seed;
  p.ray_base = ray_base;
  return launch(ptrs, n_ptrs, n, S, D, skip_mask, p, plan, stream);
}

// The bf16 kernel, or the int8 one when an int8 plan is given (fp32 takes none).
int launch_mode(const void* const* ptrs, int n_ptrs, long long n, int S, int D, unsigned skip_mask,
                int source, float a, float b, int lindisp, int white_bkgd, float std_, unsigned seed,
                long long ray_base, int fp32, const int* plan, void* stream) {
  if (fp32 && plan) return (int)cudaErrorInvalidValue;
  if (fp32)
    return launch_typed<float>(ptrs, n_ptrs, n, S, D, skip_mask, source, a, b, lindisp, white_bkgd, std_, seed,
                               ray_base, nullptr, stream);
  if (plan)
    return launch_typed<int8_t>(ptrs, n_ptrs, n, S, D, skip_mask, source, a, b, lindisp, white_bkgd, std_,
                                seed, ray_base, plan, stream);
  return launch_typed<bf16>(ptrs, n_ptrs, n, S, D, skip_mask, source, a, b, lindisp, white_bkgd, std_, seed,
                            ray_base, nullptr, stream);
}

}  // namespace
}  // namespace nst

// Every entry: plan is the int8 pack's constants (kernels/quant.py::
// quant_plan, a host array read at launch) for the int8 kernel, null for
// bf16 (and fp32); every call hands the weight slices after out.
// Each returns a cudaError_t (0 on success).

// K2.
extern "C" int nst_render_around_depth(const void* const* ptrs, int n_ptrs, long long n, int S, int D,
                                       unsigned skip_mask, float near_, float far_, int white_bkgd,
                                       const int* plan, void* stream) {
  return nst::launch_mode(ptrs, n_ptrs, n, S, D, skip_mask, nst::kAroundCenter, near_, far_, 0, white_bkgd,
                          0.f, 0u, 0, 0, plan, stream);
}

// K3: ptrs[3] is the injected noise [n, S-1] (by local row) or null (Philox
// draws keyed by (seed, ray_base + row): ray_base is the global index of the
// launch's ray 0, a rank's first row under data parallelism, 0 otherwise).
extern "C" int nst_render_gaussian(const void* const* ptrs, int n_ptrs, long long n, int S, int D,
                                   unsigned skip_mask, float std_, unsigned seed, long long ray_base,
                                   int white_bkgd, const int* plan, void* stream) {
  if (S < 2) return (int)cudaErrorInvalidValue;
  return nst::launch_mode(ptrs, n_ptrs, n, S, D, skip_mask, nst::kGaussian, 0.f, 0.f, 0, white_bkgd, std_,
                          seed, ray_base, 0, plan, stream);
}

// K8: the grid ends (a, b) are (near, far), or (1/near, 1/far) rounded to
// fp32 with lindisp; ptrs[2] and ptrs[3] are null. fp32: the wgmma_slices32
// and vectors of pack_nerf(model, torch.float32).
extern "C" int nst_render_linspace(const void* const* ptrs, int n_ptrs, long long n, int S, int D,
                                   unsigned skip_mask, float a, float b, int lindisp, int white_bkgd,
                                   int fp32, const int* plan, void* stream) {
  if (ptrs[2] || ptrs[3]) return (int)cudaErrorInvalidValue;
  return nst::launch_mode(ptrs, n_ptrs, n, S, D, skip_mask, nst::kLinspace, a, b, lindisp, white_bkgd, 0.f,
                          0u, 0, fp32, plan, stream);
}

// K9: ptrs[3] is the caller's z [n, S] (ptrs[2] null); sorted: z is taken
// as sorted per ray, else it is sorted first.
extern "C" int nst_shade(const void* const* ptrs, int n_ptrs, long long n, int S, int D, unsigned skip_mask,
                         int sorted, int white_bkgd, int fp32, const int* plan, void* stream) {
  if (ptrs[2] || !ptrs[3]) return (int)cudaErrorInvalidValue;
  const int source = sorted ? nst::kInput : nst::kInputUnsorted;
  return nst::launch_mode(ptrs, n_ptrs, n, S, D, skip_mask, source, 0.f, 0.f, 0, white_bkgd, 0.f, 0u, 0, fp32,
                          plan, stream);
}

// The launch shape at S samples of the bf16 kernel (K2, K3, K8, K9; kind
// 0), the int8 one (kind 1) or the fp32 one (K8/K9 in COMPARE; kind 2):
// resident blocks per SM, rays per block, threads per block and dynamic
// shared memory.
namespace nst {
namespace {
template <typename T>
int occupancy(int S, int* out) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(render_around_depth_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  out[1] = rays_per_block<T>(S);
  out[2] = wg::kBlockThreads<T>;
  out[3] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, render_around_depth_kernel<T>, out[2], smem);
}
}  // namespace
}  // namespace nst

extern "C" int nst_render_around_depth_occupancy(int S, int kind, int* out) {
  if (S < 1 || S > 512) return (int)cudaErrorInvalidValue;
  if (kind == 2) return nst::occupancy<float>(S, out);
  return kind == 1 ? nst::occupancy<int8_t>(S, out) : nst::occupancy<nst::bf16>(S, out);
}
