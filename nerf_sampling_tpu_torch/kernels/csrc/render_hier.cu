// K6 and K7: the hierarchical pass, rays -> composited maps + argmax.
//
// Replaces nerf_sampling_tpu/kernels/fused_hier.py::_call (the
// pl.pallas_call at :255) in both of its modes (_kernel, :104-221):
//   K6, run with a seed (stochastic=True): the frozen-NeRF target pass of
//     the depth-net train step (nerf_sampling_tpu/train/steps.py:127-161);
//   K7, deterministic: the FULL_NERF eval render (render/engine.py:688-707),
//     with no jitter and det u = linspace(0, 1, Nf) (fused_hier.py:76-80;
//     here i * fl(1/(Nf-1)) with the end pinned to 1, jnp.linspace's
//     rounding, as the plain version and the XLA path).
// Per ray, with Nc coarse and Nf fine samples:
//   1. coarse z = lower + (upper - lower) * t_rand over the strata of the
//      [near, far] linspace (or lindisp) grid (Trainer.py:604-626); in det
//      mode the grid itself;
//   2. the coarse NeRF, trunk and alpha head only (no rgb is read), then
//      the coarse weights: |d|-scaled dists with a 1e10 tail, alpha =
//      1-exp(-relu(sigma)*dist), the exclusive product of 1-alpha+1e-10;
//   3. the CDF of weights[1:-1] + 1e-5 (a leading 0, over the Nc-1 coarse
//      midpoints); each u inverted by a right-sided binary search, a denom
//      below 1e-5 taken as 1 (sample_pdf, run_nerf_helpers.py:250-293);
//   4. the Nc + Nf union sorted stably, ties coarse first (the reference's
//      sort(cat([z_c, z_f]))), by one rank pass;
//   5. the full fine NeRF over the union, compositing in order on a white
//      background, and the argmax of the weights: the FIRST maximum in
//      sorted order, as the XLA path's argmax (the TPU kernel took the
//      first in storage order, fused_hier.py:211-213).
// The draws t_rand (Nc) and u (Nf) of a ray are Philox uniforms keyed by
// (seed, global ray index = ray_base + the ray's row in this launch)
// (philox.cuh), or read from injected draws (by local row); det
// mode draws nothing. The seed comes by value, or from device memory
// (seed_ptr, read once by each consumer thread at its start): a CUDA graph
// that holds a K6 launch then draws the seed its replay finds there, where
// a seed given by value would be frozen into the graph. Element type T:
// bf16 (K6, and K7 in FULL_NERF and NERF_MAX), fp32 throughout (K7 in the COMPARE mode: fp32 sums and
// activations, the products as 3xTF32 on the tensor cores), or int8 (K6 and K7 under cuda_int8: the
// W8A8 MLP of kernels/quant.py, K10; the coarse pass on the coarse NeRF's
// int8 pack and plan, the fine pass on the fine NeRF's).
//
// What bounds it on the H100: the two MLP passes, Nc sigma-only queries
// (~0.98 MFLOP each) and Nc+Nf full queries (~1.19 MFLOP) a ray, on the
// tensor cores, with the weights (2 x 1.2 MB bf16) streamed from L2. Device
// memory traffic is 24 bytes in and 44 out per ray. In int8 most of the
// multiply-adds run at the s8 rate (1,979 TOP/s), from half the slice bytes
// (a sigma-only pass at D = 8 with one skip: 32 slices against bf16's 60),
// and every element of a layer passes an integer requant in registers. In
// fp32 the frame is 46.5 TFLOP at 64 + 128 samples over 400x400 rays: 0.69
// s on the FMA units (67 TFLOP/s), 0.28 s as 3xTF32 on the tensor cores
// (three tf32 products at 494.7 TFLOP/s), from four times bf16's slice
// bytes (hi and lo images of fp32 weights).
//
// Design: one block per R rays, R = min(rows / (Nc+Nf), 16), so the union
// planes hold R*(Nc+Nf) <= rows rows. Six fp32 planes in shared memory:
// U (unsorted union; coarse z first, in concat order), zs (coarse z, then
// the sorted union), sg (coarse then fine sigma) and three planes that
// hold the coarse weights, CDF and midpoints until the fine pass writes
// rgb there. Every type runs the MLP on the wgmma core (mlp_wgmma.cuh),
// a producer warp streaming both NeRFs' weight slices for the whole block
// (coarse pass, then fine) while the consumers run everything else:
//   bf16 and int8 (int8 with s8 products and the integer requants in
//     registers): 288 threads, two consumer warpgroups on 128-row tiles;
//     rows = 1536, so 8 rays a block at 64 + 128 samples and the train
//     step's 1024 rays fill 128 of the 132 SMs in one wave at one block
//     per SM;
//   fp32 (K7 in COMPARE): 160 threads, one consumer warpgroup on 64-row
//     tiles with 3xTF32 products, rows = 1024 (5 rays a block at 64 +
//     128), one block per SM. The shape is forced by fp32's bytes and
//     registers: 128 rows of fp32 activations and PE (176 KB) leave no room
//     for a ring in 227 KB of shared memory, and two consumer warpgroups
//     get 168 registers a thread, too few for 128 fp32 accumulators beside
//     the split A fragments. So the activations stay with the thread that
//     computed them (a thread-private store, the next layer's register A
//     fragment through a host permutation of the weights' depth), 64 KB,
//     the PE 24 KB and a 6-stage ring 96 KB (mlp_wgmma.cuh, the fp32
//     path).

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"
#include "nerf_mlp.cuh"
#include "philox.cuh"

namespace nst {
namespace {

constexpr int kMaxRays = 16;  // rays per block

// every type runs the wgmma core: bf16 and int8 on two consumer warpgroups,
// fp32 on one (mlp_wgmma.cuh)
template <typename T>
constexpr int kBlockThreads = wg::kBlockThreads<T>;
template <typename T>
constexpr int kWorkers = wg::kWorkers<T>;  // the consumer threads
template <typename T>
constexpr int kTileRows = wg::kTileRows<T>;
template <typename T>
constexpr size_t kMlpBytes = wg::mlp_bytes<T>();
template <typename T>
constexpr int kMaxRows = std::is_same_v<T, float> ? 1024 : 1536;  // union rows per block

template <typename T>
struct HierParams {
  const float* rays_o;  // [n, 3]
  const float* rays_d;  // [n, 3]
  const float* draws;   // [n, Nc + Nf] injected uniforms, or null
  float* out;           // [11, n]: r g b disp acc depth max_z max_w max_r max_g max_b
  long long n;
  int Nc, Nf, R;
  float near_, far_;
  int lindisp, white_bkgd, det;
  unsigned seed;
  const unsigned* seed_ptr;  // the seed in device memory, or null: seed
  long long ray_base;   // the global index of ray 0: Philox is keyed by ray_base + g
  NerfWeightsT<T> wc, wf;
  const bf16* slices_c;  // the coarse net's forward slices (sigma_only), then the fine net's
  const bf16* slices_f;  // (int8: wgmma_qslices' images of bf16 and int8 slices; fp32: wgmma_slices32's)
  int n_slices_c, n_slices_f;
};

// bf16 and int8 also stage each ray's view embedding (mlp_wgmma.cuh::stage_views, 64 bytes a ray)
template <typename T>
constexpr size_t smem_bytes() {
  return kMlpBytes<T> + (6 * kMaxRows<T> + 8 * kMaxRays) * sizeof(float) +
         (wg::kCore32<T> ? 0 : kMaxRays * 32 * sizeof(bf16));
}

template <typename T>
__device__ __forceinline__ float draw(const HierParams<T>& p, unsigned seed, long long g, int k) {
  return p.draws ? p.draws[g * (p.Nc + p.Nf) + k] : hier_uniform(seed, (uint32_t)(p.ray_base + g), (uint32_t)k);
}

template <typename T>
__device__ __forceinline__ float grid_z(const HierParams<T>& p, int s) {
  // i * fl(1/(n-1)) and exactly 1 at the end, as the plain version (jnp.linspace)
  const float t = s == p.Nc - 1 ? 1.f : (float)s * (1.f / (float)(p.Nc - 1));
  if (p.lindisp) return 1.f / (1.f / p.near_ * (1.f - t) + 1.f / p.far_ * t);
  return p.near_ * (1.f - t) + p.far_ * t;
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads<T>, 1)
    render_hier_kernel(const __grid_constant__ HierParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* U = reinterpret_cast<float*>(smem + kMlpBytes<T>);
  float* zs = U + kMaxRows<T>;
  float* sg = zs + kMaxRows<T>;
  float* plane[3] = {sg + kMaxRows<T>, sg + 2 * kMaxRows<T>, sg + 3 * kMaxRows<T>};
  float* ray = sg + 4 * kMaxRows<T>;  // per ray: o[3], d[3], |d|, spare
  bf16* view = reinterpret_cast<bf16*>(ray + 8 * kMaxRays);  // bf16, int8: per ray, the view embedding
  float* wts = plane[0];              // coarse weights [r*Nc + s]
  float* cdf = plane[1];              // [r*(Nc-1) + k]
  float* mids = plane[2];             // [r*(Nc-1) + k]
  const long long ray0 = (long long)blockIdx.x * p.R;
  const int nr = (int)min((long long)p.R, p.n - ray0);

  const wg::RenderTiles<T> t = wg::carve_render<T>(smem);
  wg::Cursor cur;
  __syncthreads();
  if ((int)threadIdx.x >= kWorkers<T>) {  // the producer: both passes' slices, tile by tile
    const wg::Segment segs[2] = {{p.slices_c, p.n_slices_c, (nr * p.Nc + kTileRows<T> - 1) / kTileRows<T>},
                                 {p.slices_f, p.n_slices_f, (nr * (p.Nc + p.Nf) + kTileRows<T> - 1) / kTileRows<T>}};
    wg::produce(t.ring, segs, 2, kWorkers<T>);
    return;
  }
  // the consumers' barrier (the producer warp never joins)
  auto sync = [] {
    if constexpr (std::is_same_v<T, float>) wg::group_sync();
    else wg::consumers_sync();
  };
  auto mlp = [&](const NerfWeightsT<T>& w, int rows, int S, bool sigma_only) {
    if constexpr (wg::kCore32<T>) wg::nerf_rows(w, t, cur, ray, zs, rows, S, sigma_only, sg, plane);
    else wg::nerf_rows(w, t, cur, ray, view, zs, rows, S, sigma_only, sg, plane);
    sync();
  };

  const int tid = threadIdx.x;
  const int Nc = p.Nc, Nf = p.Nf, Su = Nc + Nf, B = Nc - 1;
  const unsigned seed = p.seed_ptr ? *p.seed_ptr : p.seed;

  for (int r = tid; r < nr; r += kWorkers<T>) {
    float* q = ray + 8 * r;
    for (int c = 0; c < 3; ++c) {
      q[c] = p.rays_o[(ray0 + r) * 3 + c];
      q[3 + c] = p.rays_d[(ray0 + r) * 3 + c];
    }
    q[6] = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5]);
    q[7] = 0.f;
  }
  // 1. jittered coarse z: contiguous in zs for the coarse pass, and the
  // first Nc entries of each ray's union in U
  for (int e = tid; e < nr * Nc; e += kWorkers<T>) {
    const int r = e / Nc, s = e - r * Nc;
    const float zc = grid_z(p, s);
    const float lower = s == 0 ? zc : 0.5f * (zc + grid_z(p, s - 1));
    const float upper = s == Nc - 1 ? zc : 0.5f * (grid_z(p, s + 1) + zc);
    const float z = p.det ? zc
                          : __fadd_rn(lower, __fmul_rn(__fsub_rn(upper, lower), draw(p, seed, ray0 + r, s)));
    zs[e] = z;
    U[r * Su + s] = z;
  }
  sync();

  // 2. coarse sigma, then the coarse weights, CDF and midpoints per ray
  mlp(p.wc, nr * Nc, Nc, true);
  for (int r = tid; r < nr; r += kWorkers<T>) {
    const float dn = ray[8 * r + 6];
    const float* z = zs + r * Nc;
    float T_ = 1.f;
    for (int s = 0; s < Nc; ++s) {
      const float dist = (s < Nc - 1 ? z[s + 1] - z[s] : 1e10f) * dn;
      const float sgm = sg[r * Nc + s] < 0.f ? 0.f : sg[r * Nc + s];
      const float alpha = 1.f - expf(-sgm * dist);
      wts[r * Nc + s] = alpha * T_;
      T_ *= 1.f - alpha + 1e-10f;
    }
    float sum = 0.f;
    for (int k = 1; k < Nc - 1; ++k) sum += wts[r * Nc + k] + 1e-5f;
    float run = 0.f;
    cdf[r * B] = 0.f;
    for (int k = 1; k < B; ++k) {
      run += (wts[r * Nc + k] + 1e-5f) / sum;
      cdf[r * B + k] = run;
    }
    for (int k = 0; k < B; ++k) mids[r * B + k] = 0.5f * (z[k + 1] + z[k]);
  }
  sync();

  // 3. fine z by inverse CDF, after the coarse z of each ray's union
  for (int e = tid; e < nr * Nf; e += kWorkers<T>) {
    const int r = e / Nf, j = e - r * Nf;
    const float u = !p.det ? draw(p, seed, ray0 + r, Nc + j)
                    : (j == Nf - 1 ? 1.f : (float)j * (1.f / (float)(Nf - 1)));
    const float* c = cdf + r * B;
    const float* m = mids + r * B;
    int lo = 0, hi = B;  // number of CDF entries <= u (searchsorted, right)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c[mid] <= u) lo = mid + 1; else hi = mid;
    }
    const int below = lo - 1 < 0 ? 0 : lo - 1;
    const int above = lo > B - 1 ? B - 1 : lo;
    float denom = __fsub_rn(c[above], c[below]);
    if (denom < 1e-5f) denom = 1.f;
    const float tt = __fdiv_rn(__fsub_rn(u, c[below]), denom);
    U[r * Su + Nc + j] = __fadd_rn(m[below], __fmul_rn(tt, __fsub_rn(m[above], m[below])));
  }
  sync();

  // 4. the union, sorted stably per ray (coarse first on ties)
  sort_rows(U, zs, nr, Su, kWorkers<T>);
  sync();

  // 5. the fine NeRF over the union, then compositing and the argmax
  mlp(p.wf, nr * Su, Su, false);
  for (int r = tid; r < nr; r += kWorkers<T>) {
    const float dn = ray[8 * r + 6];
    float T_ = 1.f, acc = 0.f, dep = 0.f, c[3] = {0.f, 0.f, 0.f};
    float best_w = 0.f;
    int best = 0;
    for (int s = 0; s < Su; ++s) {
      const int row = r * Su + s;
      const float z = zs[row];
      const float dist = (s < Su - 1 ? zs[row + 1] - z : 1e10f) * dn;
      const float sgm = sg[row] < 0.f ? 0.f : sg[row];
      const float alpha = 1.f - expf(-sgm * dist);
      const float w = alpha * T_;
      if (s == 0 || w > best_w) {  // first maximum in sorted order
        best_w = w;
        best = s;
      }
      acc += w;
      dep += w * z;
      for (int k = 0; k < 3; ++k) c[k] += w * plane[k][row];
      T_ *= 1.f - alpha + 1e-10f;
    }
    const float q = dep / (acc + 1e-10f);
    const long long g = ray0 + r;
    const long long n = p.n;
    for (int k = 0; k < 3; ++k) p.out[k * n + g] = p.white_bkgd ? c[k] + (1.f - acc) : c[k];
    p.out[3 * n + g] = 1.f / (q < 1e-10f ? 1e-10f : q);
    p.out[4 * n + g] = acc;
    p.out[5 * n + g] = dep;
    p.out[6 * n + g] = zs[r * Su + best];
    p.out[7 * n + g] = best_w;
    for (int k = 0; k < 3; ++k) p.out[(8 + k) * n + g] = plane[k][r * Su + best];
  }
}

// Rays per block at Nc + Nf samples (>= 2 at 512).
template <typename T>
constexpr int rays_per_block(int Su) {
  return kMaxRows<T> / Su < kMaxRays ? kMaxRows<T> / Su : kMaxRays;
}

// ptrs, in order: rays_o, rays_d, draws (or null), out; the coarse and the
// fine net's weight slices (mlp_wgmma.cuh: forward_slices, forward_qslices
// in int8, forward_slices32 in fp32); then the epilogue vectors of the
// coarse NeRF's trunk and alpha head and of the whole fine NeRF
// (nerf_mlp.cuh::read_pack, with the int8 plans plan_c and plan_f, null for
// bf16 and fp32). A launch without the slices is refused.
template <typename T>
int launch(const void* const* ptrs, int n_ptrs, long long n, int Nc, int Nf, int Dc, unsigned skip_c,
           int Df, unsigned skip_f, float near_, float far_, int lindisp, int white_bkgd, const unsigned* seed_ptr,
           unsigned seed, long long ray_base, int det, const int* plan_c, const int* plan_f, void* stream) {
  if (Nc < 4 || Nf < 1 || Nc + Nf > 512) return (int)cudaErrorInvalidValue;
  HierParams<T> p = {};
  p.rays_o = static_cast<const float*>(ptrs[0]);
  p.rays_d = static_cast<const float*>(ptrs[1]);
  p.draws = static_cast<const float*>(ptrs[2]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[3]));
  p.slices_c = static_cast<const bf16*>(ptrs[4]);
  p.slices_f = static_cast<const bf16*>(ptrs[5]);
  const int kc = read_pack(ptrs + 6, Dc, skip_c, true, plan_c, &p.wc);
  if (kc < 0) return (int)cudaErrorInvalidValue;
  const int kf = read_pack(ptrs + 6 + kc, Df, skip_f, false, plan_f, &p.wf);
  if (kf < 0 || n_ptrs != 6 + kc + kf || !p.slices_c || !p.slices_f) return (int)cudaErrorInvalidValue;
  auto count = [](int D, unsigned skip, bool sigma_only) {
    if constexpr (std::is_same_v<T, int8_t>) return wg::forward_qslices(D, skip, sigma_only);
    else if constexpr (std::is_same_v<T, float>) return wg::forward_slices32(D, skip, sigma_only);
    else return wg::forward_slices(D, skip, sigma_only);
  };
  p.n_slices_c = count(Dc, skip_c, true);
  p.n_slices_f = count(Df, skip_f, false);
  p.n = n;
  p.Nc = Nc;
  p.Nf = Nf;
  p.R = rays_per_block<T>(Nc + Nf);
  p.near_ = near_;
  p.far_ = far_;
  p.lindisp = lindisp;
  p.white_bkgd = white_bkgd;
  p.seed = seed;
  p.seed_ptr = seed_ptr;
  p.ray_base = ray_base;
  p.det = det;
  if (det && (p.draws || seed_ptr)) return (int)cudaErrorInvalidValue;

  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(render_hier_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + p.R - 1) / p.R);
  render_hier_kernel<T><<<grid, kBlockThreads<T>, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The launch shape at Nc + Nf samples: resident blocks per SM, rays per
// block, threads per block and dynamic shared memory.
template <typename T>
int occupancy(int Nc, int Nf, int* out) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(render_hier_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  out[1] = rays_per_block<T>(Nc + Nf);
  out[2] = kBlockThreads<T>;
  out[3] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, render_hier_kernel<T>, out[2], smem);
}

}  // namespace
}  // namespace nst

// det: no draws (K7). seed_ptr: the seed as a device word (a captured
// step's), or null for the seed given by value. ray_base: the global index
// of the launch's ray 0 (a rank's first row under data parallelism; 0
// otherwise). fp32: the wgmma_slices32 and vectors of
// pack_hier(..., torch.float32).
// plan_c, plan_f: both int8 packs' constants (kernels/quant.py::quant_plan,
// host arrays read at launch) for the int8 kernel, or both null. Returns a
// cudaError_t (0 on success).
extern "C" int nst_render_hier(const void* const* ptrs, int n_ptrs, long long n, int Nc, int Nf,
                               int Dc, unsigned skip_c, int Df, unsigned skip_f, float near_,
                               float far_, int lindisp, int white_bkgd, const unsigned* seed_ptr, unsigned seed,
                               long long ray_base, int det, int fp32, const int* plan_c, const int* plan_f,
                               void* stream) {
  if ((plan_c == nullptr) != (plan_f == nullptr) || (fp32 && plan_c)) return (int)cudaErrorInvalidValue;
  if (fp32)
    return nst::launch<float>(ptrs, n_ptrs, n, Nc, Nf, Dc, skip_c, Df, skip_f, near_, far_, lindisp, white_bkgd,
                              seed_ptr, seed, ray_base, det, nullptr, nullptr, stream);
  if (plan_c)
    return nst::launch<int8_t>(ptrs, n_ptrs, n, Nc, Nf, Dc, skip_c, Df, skip_f, near_, far_, lindisp,
                               white_bkgd, seed_ptr, seed, ray_base, det, plan_c, plan_f, stream);
  return nst::launch<nst::bf16>(ptrs, n_ptrs, n, Nc, Nf, Dc, skip_c, Df, skip_f, near_, far_, lindisp,
                                white_bkgd, seed_ptr, seed, ray_base, det, nullptr, nullptr, stream);
}

// The kernel's launch shape at Nc + Nf samples, kind 0 bf16 (K6, K7), 1
// int8, 2 fp32 (K7 in COMPARE): resident blocks per SM, rays per block,
// threads per block and dynamic shared memory.
extern "C" int nst_render_hier_occupancy(int Nc, int Nf, int kind, int* out) {
  if (kind == 2) return nst::occupancy<float>(Nc, Nf, out);
  return kind == 1 ? nst::occupancy<int8_t>(Nc, Nf, out) : nst::occupancy<nst::bf16>(Nc, Nf, out);
}
