// K5: the recompute backward of K4, cotangent of raw -> weight grads (and dx).
//
// Replaces nerf_sampling_tpu/kernels/fused_nerf_vjp.py::_bwd_call (the
// pl.pallas_call at :272, _bwd_kernel :81-232), the backward of every NeRF
// query of the nerf and joint train steps. It keeps the TPU kernel's
// semantics:
//   - the forward is recomputed from the points (K4's rounding: bf16 PE,
//     bf16 activations, fp32 accumulation);
//   - the trunk's ReLU masks are h > 0 on the bf16 post-activations, the
//     views layer's is zv > 0 on its fp32 pre-activation;
//   - d_h of the last trunk layer is the alpha head's part plus the feature
//     layer's (g16 * alpha_w + d_feature16 @ feat_w^T);
//   - bias grads are column sums of the fp32 d_z and g; the matrix products
//     take the bf16-rounded d_z16 and g16, with fp32 accumulation;
//   - matrix grads are rounded to bf16 (the packed dtype, :289-293);
//   - dL/dx (want_dx) goes through the sin/cos PE in fp32:
//     d/dx sin(2^f x) = 2^f cos(2^f x), d/dx cos(2^f x) = -2^f sin(2^f x).
// What it does not carry over: the TPU grid's sequential accumulation of
// the weight grads in VMEM. On Hopper the blocks run in no order, and a
// tile's activations (10 x 128 x 256 bf16) do not fit in shared memory
// beside the weights' traffic, so it runs in three passes, all
// deterministic (no float atomics: two launches give the same bits, and
// want_dx does not change the weight grads):
//   (a) nerf_bwd_rows_kernel, one block per 128-row tile, on the wgmma core
//       (mlp_wgmma.cuh): recompute the forward from the forward slices
//       (the ones K4 ran the step's forward from; the backward's own
//       follow them in the stream),
//       writing the PE row and every bf16 activation to a device workspace
//       (16-byte stores from the swizzled tile) and the trunk's ReLU masks
//       (a bit per element, in the thread's own words); then the d_h chain
//       from the backward slices, layer by layer, writing every bf16 d_z
//       (and g16) beside them and the tile's fp32 bias-grad column sums
//       (a fixed shuffle tree, then the 8 warps in order); dx when asked;
//   (b) wgrad_kernel: every weight grad A^T @ dZ over the rows, as wgmma
//       GEMMs (bf16, fp32 accumulation) of 128x128 output tiles, each over
//       one slice of rows, into fp32 partials per slice;
//   (c) reduce_kernel: the slices' partials (and the tiles' bias sums)
//       added in slice order, matrix grads rounded to bf16.
//
// What bounds it on the H100: the recompute (1.19 MFLOP a row), the d_h
// chain (about as much) and the weight grads (as much again), all on the
// tensor cores, plus the workspace: 10 KB a row written and read once
// (2 GB at the fine query's 196,608 rows). The row pass streams 141 weight
// slices (2.3 MB) per 128-row tile from L2; pass (b) reads each workspace
// plane once per 128 output columns it meets, mostly from L2.

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"
#include "nerf_mlp.cuh"

namespace nst {
namespace {

constexpr int kG16 = 16;    // width of the g16 plane: r, g, b, sigma, 0 x 12
constexpr int kTile = wg::kRows;
constexpr int kStages = 6;  // weight ring stages of the row pass

struct Workspace {  // bf16 planes of Mp rows (Mp = M rounded up to 128)
  bf16* pe;         // [Mp, 96]
  bf16* h;          // [D][Mp, W]
  bf16* feat;       // [Mp, W]
  bf16* hv;         // [Mp, W/2]
  bf16* g16;        // [Mp, 16]
  bf16* dz;         // [D][Mp, W]
  bf16* dfeat;      // [Mp, W]
  bf16* dzv;        // [Mp, W/2]
};

__host__ __device__ inline long long ws_elems_per_row(int D) {
  return kPeCols + 2LL * D * kW + 2 * kW + 2 * kWv + kG16;
}

// bias-grad layout of one tile's partial sums and of the result:
// trunk_b[0..D-1] | feature_b | views_b | rgb_b (3) and alpha_b
__host__ __device__ inline int bias_elems(int D) { return D * kW + kW + kWv + 4; }

struct RowParams {
  const float* pts;   // [M, 3]
  const float* dirs;  // [M / S, 3]
  const float* g;     // [M, 4] cotangent of raw
  float* dx;          // [M, 6]: d pts, d dirs (per row), or null
  float* dP;          // [Mp, 96] fp32 dL/dPE (want_dx), or null
  float* bias_part;   // [Mp / 128, bias_elems]
  unsigned* masks;    // [Mp / 128][D][4][256]: the trunk's ReLU masks, by thread
  long long M, S, Mp;
  NerfWeights w;
  const bf16* slices_f;  // the forward's slices, then
  const bf16* slices_b;  // the backward's, for each tile
  int n_slices_f, n_slices_b;
  Workspace ws;
};

constexpr size_t kRowSmem = 1024 + wg::Tiles<kStages>::kBytes + (kTile * 8 + kTile * 4 + 8 * kW) * sizeof(float) +
                            kTile * 32 * sizeof(bf16);  // + q, gt, column-sum partials, staged view embeddings

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16(v)); }

// The column sums over the tile's 128 rows of acc (fp32, every consumer
// thread's part): the thread's two rows, a shuffle tree over the 8 row
// groups of the warp, then the 8 warps in order into out[0, NH * 128).
template <int NH>
__device__ __forceinline__ void colsums(const float (&acc)[NH][64], float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = acc[h][4 * j + e] + acc[h][4 * j + 2 + e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[warp * kW + h * 128 + 8 * j + 2 * lane + e] = v;
      }
  wg::consumers_sync();
  for (int col = threadIdx.x; col < NH * 128; col += wg::kConsumers) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * kW + col];
    out[col] = s;
  }
  wg::consumers_sync();  // red is free again
}

// dP[row][col0 + col] += acc for the columns below `cols` (this thread's own elements)
__device__ __forceinline__ void add_dP(const float (&acc)[1][64], float* dP, long long row0, int col0, int cols) {
  const long long r0 = row0 + 64 * (threadIdx.x >> 7);
  wg::for_pairs<1>([&](int r, int col, int h, int i) {
    float* d = dP + (r0 + r) * kPeCols + col0 + col;
    if (col < cols) d[0] += acc[h][i];
    if (col + 1 < cols) d[1] += acc[h][i + 1];
  });
}

__global__ void __launch_bounds__(wg::kThreads, 1) nerf_bwd_rows_kernel(const __grid_constant__ RowParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  const wg::Tiles<kStages> t = wg::carve<kStages>(base);
  float* q = reinterpret_cast<float*>(base + wg::Tiles<kStages>::kBytes);  // [128, 8] inputs
  float* gt = q + kTile * 8;                                               // [128, 4] fp32 cotangent
  float* red = gt + kTile * 4;                                             // [8 warps, 256]
  bf16* view = reinterpret_cast<bf16*>(red + 8 * kW);                      // [128 rays, 32]
  if (threadIdx.x == 0) t.ring.init();
  __syncthreads();
  if (threadIdx.x >= wg::kConsumers) {  // the producer warp
    const wg::Segment segs[2] = {{p.slices_f, p.n_slices_f, 1}, {p.slices_b, p.n_slices_b, 1}};
    wg::produce(t.ring, segs, 2);
    return;
  }

  const NerfWeights& w = p.w;
  const int tid = threadIdx.x, D = w.D;
  const long long tile = blockIdx.x, row0 = tile * kTile, Mp = p.Mp;
  const int valid = (int)min((long long)kTile, p.M - row0);
  float* bp = p.bias_part + tile * bias_elems(D);
  unsigned* masks = p.masks + tile * D * 4 * wg::kConsumers + tid;  // word k of layer i: [(4i + k) * 256]
  const uint32_t x = wg::smem_u32(t.x), pe = wg::smem_u32(t.pe);
  const int lane = tid & 31;
  const int rw = 64 * (tid >> 7) + ((tid >> 5) & 3) * 16 + (lane >> 2);  // the thread's rows rw, rw + 8
  auto H = [&](int i) { return p.ws.h + (size_t)i * Mp * kW; };
  auto DZ = [&](int i) { return p.ws.dz + (size_t)i * Mp * kW; };
  wg::Cursor cur;
  float acc[2][64];
  float accn[1][64];

  // ---- inputs and the PE tile
  for (int e = tid; e < kTile * 4; e += wg::kConsumers)
    gt[e] = (e >> 2) < valid ? p.g[(row0 + (e >> 2)) * 4 + (e & 3)] : 0.f;
  if (p.dP)
    for (int e = tid; e < kTile * kPeCols; e += wg::kConsumers) p.dP[row0 * kPeCols + e] = 0.f;
  wg::point_fill<true>(p.pts, p.dirs, row0, valid, p.S, view, q, t.pe);  // one tile a block: the rolled fill
  wg::consumers_sync();
  wg::copy_rows(t.pe, kPeCols, p.ws.pe, row0);

  // ---- forward recompute: every activation to the workspace, the ReLU masks
  for (int i = 0; i < D; ++i) {
    const wg::Src ops[2] = {{i == 0 ? pe : x, i == 0 ? 1 : 4}, {pe, 1}};
    wg::gemm(acc, ops, (i > 0 && ((w.skip_mask >> i) & 1u)) ? 2 : 1, t.ring, cur);
    wg::bias_act(acc, w.tb[i], kRelu);
    unsigned m[4] = {0u, 0u, 0u, 0u};  // bit 64h + k: acc[h][k] > 0 (on the bf16 value)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 64; ++k) m[(64 * h + k) >> 5] |= (acc[h][k] > 0.f ? 1u : 0u) << (k & 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) masks[(4 * i + k) * wg::kConsumers] = m[k];
    wg::group_sync();
    wg::store_tile(acc, t.x);
    wg::copy_rows(t.x, kW, H(i), row0);
  }
  {
    const wg::Src op = {x, 4};
    wg::gemm(acc, &op, 1, t.ring, cur);
    wg::bias_act(acc, w.feat_b, kNone);
    wg::group_sync();
    wg::store_tile(acc, t.x);
    wg::copy_rows(t.x, kW, p.ws.feat, row0);
  }
  {  // views: hv = relu(zv) to the workspace; d_zv = (zv > 0) * g16[:, :3] @ rgb_w in its place
    const wg::Src opv[2] = {{x, 4}, {pe + wg::kPanelBytes, 1}};
    wg::gemm(accn, opv, 2, t.ring, cur);
    float dzv[1][64];
    wg::for_pairs<1>([&](int r, int col, int h, int i) {
      const float* gr = gt + (64 * (tid >> 7) + r) * 4;
      const float g0 = rnd(gr[0]), g1 = rnd(gr[1]), g2 = rnd(gr[2]);
      for (int e = 0; e < 2; ++e) {
        const float zv = accn[h][i + e] + w.views_b[col + e];
        const float d = g0 * bf(w.rgb_w[col + e]) + g1 * bf(w.rgb_w[kWv + col + e]) + g2 * bf(w.rgb_w[2 * kWv + col + e]);
        dzv[h][i + e] = zv > 0.f ? d : 0.f;
        accn[h][i + e] = rnd(activate(zv, kRelu));
      }
    });
    wg::group_sync();
    wg::store_tile(accn, t.x);
    wg::copy_rows(t.x, kWv, p.ws.hv, row0);
    colsums(dzv, red, bp + D * kW + kW);  // views_b; its barriers also end the copy's reads of x
    wg::store_tile(dzv, t.x);             // d_zv16
    wg::copy_rows(t.x, kWv, p.ws.dzv, row0);
  }

  // ---- backward: the heads
  for (int e = tid; e < kTile * kG16; e += wg::kConsumers) {
    const int r = e / kG16, c = e % kG16;
    p.ws.g16[(row0 + r) * kG16 + c] = __float2bfloat16(c < 4 ? gt[r * 4 + c] : 0.f);
  }
  if (tid < 4) {  // rgb_b and alpha_b: column sums of the fp32 cotangent
    float sum = 0.f;
    for (int r = 0; r < kTile; ++r) sum += gt[r * 4 + tid];
    bp[D * kW + kW + kWv + tid] = sum;
  }
  const wg::Src dzv16 = {x, 2}, dz16 = {x, 4};
  if (p.dP) {  // the view embedding's share of dL/dPE: d_zv16 @ views_ws^T
    wg::gemm(accn, &dzv16, 1, t.ring, cur);
    add_dP(accn, p.dP, row0, kPeViews, 32);
  }
  {  // d_feature = d_zv16 @ views_wf^T; its fp32 column sums are feature_b's grad
    wg::gemm(acc, &dzv16, 1, t.ring, cur);
    colsums(acc, red, bp + D * kW);
    wg::store_tile(acc, t.x);
    wg::copy_rows(t.x, kW, p.ws.dfeat, row0);
  }

  // ---- the trunk: d_h of the last layer is the alpha head's part plus the
  // feature layer's; then d_h_{i-1} = d_z16_i @ tw[i]^T down the layers
  for (int i = D - 1; i >= 0; --i) {
    wg::gemm(acc, &dz16, 1, t.ring, cur);  // x: d_feature16, then d_z16_{i+1}
    unsigned m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = masks[(4 * i + k) * wg::kConsumers];
    const bool last = i == D - 1;
    const float ga = last ? rnd(gt[rw * 4 + 3]) : 0.f, gb = last ? rnd(gt[(rw + 8) * 4 + 3]) : 0.f;
    wg::for_pairs<2>([&](int r, int col, int h, int k) {
      for (int e = 0; e < 2; ++e) {
        float v = acc[h][k + e];
        if (last) v += ((k >> 1) & 1 ? gb : ga) * bf(w.alpha_w[col + e]);
        const int bit = 64 * h + k + e;
        acc[h][k + e] = (m[bit >> 5] >> (bit & 31)) & 1u ? v : 0.f;
      }
    });
    colsums(acc, red, bp + i * kW);
    wg::store_tile(acc, t.x);  // d_z16_i
    wg::copy_rows(t.x, kW, DZ(i), row0);
    if (p.dP && (i == 0 || ((w.skip_mask >> i) & 1u))) {  // the point embedding's share: skip_w[i]^T, w0^T
      wg::gemm(accn, &dz16, 1, t.ring, cur);
      add_dP(accn, p.dP, row0, 0, 64);
    }
  }

  if (p.dx) {  // dL/dx through the PE, in fp32
    wg::consumers_sync();
    for (int e = tid; e < kTile * 6; e += wg::kConsumers) {
      const int r = e / 6, c = e % 6;
      if (r >= valid) continue;
      const int off = c < 3 ? 0 : kPeViews, k = c % 3, L = c < 3 ? (kPtsCh - 3) / 6 : (kViewCh - 3) / 6;
      const float u = q[r * 8 + c];
      const float* d = p.dP + (row0 + r) * kPeCols + off;
      float sum = d[k];
      for (int f = 0; f < L; ++f) {
        const float sc = (float)(1 << f), a = u * sc;
        sum += sc * (d[3 + 6 * f + k] * cosf(a) - d[6 + 6 * f + k] * sinf(a));
      }
      p.dx[(row0 + r) * 6 + c] = sum;
    }
  }
}

// ---- (b) the weight grads: C[K, N] = sum over rows of A[m, k] * B[m, n]
//
// One block per 128 x 128 output tile of a job and slice of rows, on
// wgmma: warpgroup g owns output rows [64g, 64g + 64) (k of the job), all
// 128 columns (n). The row dimension is the product's depth, so both
// operands are read as they lie in the workspace, rows of 64 k or n: the
// MN-major 128-byte swizzled layout (sw128_desc's lbo: the 8 KB between a
// tile's two 64-column panels). cp.async moves them, 16 bytes a thread,
// into a ring of kWgStages stages of 64 rows, kWgStages - 2 ahead of the
// products; columns past the job's K or N load as zeros.

constexpr int kMaxJobs = 40;
constexpr int kWgStages = 4;
constexpr int kWgStage = 2 * 2 * 64 * 128;  // A and B: two 64-column panels of 64 rows each
constexpr int kWgradThreads = wg::kConsumers;
constexpr size_t kWgradSmem = 1024 + kWgStages * kWgStage;

struct GemmJob {
  const bf16* a;  // [rows, lda], columns [0, K)
  const bf16* b;  // [rows, ldb], columns [0, N)
  int lda, ldb, K, N;
  long long out;  // offset of [K, N] in the flat result
  int tile0;      // first output tile of the job
};

struct WgradParams {
  GemmJob job[kMaxJobs];
  int n_jobs;
  long long rows;  // Mp
  int slice_rows;
  long long total;  // elements of the flat result
  float* part;      // [n_slices, total]
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows from m0 of columns [c0, c0 + 128) of a [rows, ld] plane into a
// stage's two swizzled 64-column panels; columns at or past `cols` are zero
__device__ __forceinline__ void load_panels(uint32_t dst, const bf16* src, int ld, int c0, int cols, long long m0) {
  for (int e = threadIdx.x; e < 64 * 16; e += kWgradThreads) {
    const int r = e >> 4, c = (e & 15) * 8;  // row, first of the chunk's 8 columns
    const bool valid = c0 + c < cols;
    const uint32_t off = (c >> 6) * (64 * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4);
    cp_async16(dst + off, valid ? src + (m0 + r) * ld + c0 + c : src, valid);
  }
}

__global__ void __launch_bounds__(kWgradThreads, 1) wgrad_kernel(const __grid_constant__ WgradParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (wg::smem_u32(smem) + 1023) & ~1023u;
  int jid = 0;
  while (jid + 1 < p.n_jobs && p.job[jid + 1].tile0 <= (int)blockIdx.x) ++jid;
  const GemmJob& J = p.job[jid];
  const int local = blockIdx.x - J.tile0, tn = (J.N + 127) / 128;
  const int k0 = (local / tn) * 128, n0 = (local % tn) * 128;
  const long long m_begin = (long long)blockIdx.y * p.slice_rows;
  const int steps = (int)((min(p.rows, m_begin + p.slice_rows) - m_begin) / 64);
  const int g = threadIdx.x >> 7;
  auto a_at = [&](int s) { return base + (s % kWgStages) * kWgStage; };
  auto load = [&](int s) {
    if (s < steps) {
      load_panels(a_at(s), J.a, J.lda, k0, J.K, m_begin + 64LL * s);
      load_panels(a_at(s) + kWgStage / 2, J.b, J.ldb, n0, J.N, m_begin + 64LL * s);
    }
    cp_async_commit();  // one group a step, empty or not, keeps the count
  };

  float acc[1][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = 0.f;
  wg::fence_regs(acc[0]);
  constexpr int kAhead = kWgStages - 2;
  for (int s = 0; s < kAhead; ++s) load(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kAhead - 1>();  // step s has landed (this thread's copies)
    wg::fence_async_smem();
    __syncthreads();              // everyone's copies; every warp's products of step s - 2 are done
    load(s + kAhead);             // into the stage of step s - 2
    const uint32_t a = a_at(s) + g * (64 * 128), b = a_at(s) + kWgStage / 2;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 rows a product
      wg::mma_m64n128k16<1>(acc[0], wg::sw128_desc(a + 2048 * kk, 64 * 128), wg::sw128_desc(b + 2048 * kk, 64 * 128));
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc[0]);

  float* part = p.part + (long long)blockIdx.y * p.total + J.out;
  wg::for_pairs<1>([&](int r, int col, int h, int i) {
    const int k = k0 + 64 * g + r, n = n0 + col;
    if (k < J.K && n < J.N)
      *reinterpret_cast<float2*>(part + (long long)k * J.N + n) = make_float2(acc[h][i], acc[h][i + 1]);
  });
}

// ---- (c) out[j] = sum over s of part[s * total + j], added in slice order
__global__ void reduce_kernel(const float* part, long long total, int n_slices, float* out, int round_bf16) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  float s = 0.f;
  for (int k = 0; k < n_slices; ++k) s += part[(long long)k * total + j];
  out[j] = round_bf16 ? rnd(s) : s;
}

}  // namespace
}  // namespace nst

// Sizes of the buffers the caller allocates, for M rows of a D-layer net:
// out[0] bf16 workspace elements, out[1] bias partials (fp32), out[2]
// weight-grad partials (fp32) at slice_rows rows a slice, out[3] bias-grad
// elements, out[4] ReLU-mask words (uint32), out[5] dL/dPE floats (want_dx),
// out[6] the backward's weight slices of one tile without and out[7] with
// want_dx, out[8] the forward's.
// The weight-grad result has `total` elements, the sum over the jobs (see
// nst_nerf_points_bwd).
extern "C" int nst_nerf_points_bwd_sizes(long long M, int D, unsigned skip_mask, long long total, int slice_rows,
                                         long long* out) {
  using namespace nst;
  if (D < 1 || D > kMaxD || (skip_mask & 1u) || (skip_mask >> D) || slice_rows < kTile || slice_rows % kTile)
    return (int)cudaErrorInvalidValue;
  const long long Mp = (M + kTile - 1) / kTile * kTile;
  out[0] = Mp * ws_elems_per_row(D);
  out[1] = Mp / kTile * bias_elems(D);
  out[2] = (Mp + slice_rows - 1) / slice_rows * total;
  out[3] = bias_elems(D);
  out[4] = Mp / kTile * D * 4 * wg::kConsumers;
  out[5] = Mp * kPeCols;
  out[6] = wg::backward_slices(D, skip_mask, false);
  out[7] = wg::backward_slices(D, skip_mask, true);
  out[8] = wg::forward_slices(D, skip_mask, false);
  return 0;
}

// ptrs, in order: pts, dirs, g, dx (or null: want_dx off), the bf16
// workspace, the bias partials, the weight-grad partials, dw (fp32 [total]:
// the matrix grads, bf16-rounded, in job order), db (fp32, bias_elems), the
// ReLU masks, dL/dPE (or null with dx), the weight slices of one tile:
// the forward's (fused_render.pack_slices, K4's) and the backward's (the
// tail of fused_render.wgmma_program(..., backward=True) past the forward);
// then the NeRF's epilogue vectors (nerf_mlp.cuh::read_weights, all heads).
// The jobs of dw, each [K, N] row-major: w0 [64, W], tw[i] [W, W] for
// i = 1..D-1, skip_w[i] [64, W] for each skip layer, feature_w [W, W],
// views_wf [W, W/2], views_ws [32, W/2], then h_{D-1}^T g16 [W, 16] (the
// alpha head's grad in column 3) and hv^T g16 [W/2, 16] (the rgb head's in
// columns 0..2). pass: 0 the row pass, 1 the weight-grad GEMMs, 2 the
// reductions; the caller launches them in that order on one stream.
// Returns a cudaError_t.
extern "C" int nst_nerf_points_bwd(const void* const* ptrs, int n_ptrs, long long M, long long S, int D,
                                   unsigned skip_mask, long long total, int slice_rows, int pass, void* stream) {
  using namespace nst;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || M % S != 0 || slice_rows < kTile || slice_rows % kTile || pass < 0 || pass > 2)
    return (int)cudaErrorInvalidValue;
  RowParams p = {};
  p.pts = static_cast<const float*>(ptrs[0]);
  p.dirs = static_cast<const float*>(ptrs[1]);
  p.g = static_cast<const float*>(ptrs[2]);
  p.dx = static_cast<float*>(const_cast<void*>(ptrs[3]));
  bf16* ws = static_cast<bf16*>(const_cast<void*>(ptrs[4]));
  p.bias_part = static_cast<float*>(const_cast<void*>(ptrs[5]));
  float* wpart = static_cast<float*>(const_cast<void*>(ptrs[6]));
  float* dw = static_cast<float*>(const_cast<void*>(ptrs[7]));
  float* db = static_cast<float*>(const_cast<void*>(ptrs[8]));
  p.masks = static_cast<unsigned*>(const_cast<void*>(ptrs[9]));
  p.dP = static_cast<float*>(const_cast<void*>(ptrs[10]));
  p.slices_f = static_cast<const bf16*>(ptrs[11]);
  p.slices_b = static_cast<const bf16*>(ptrs[12]);
  const int kw = read_weights(ptrs + 13, D, skip_mask, false, &p.w);
  if (kw < 0 || 13 + kw != n_ptrs || (p.dx == nullptr) != (p.dP == nullptr) || !p.slices_f || !p.slices_b ||
      !p.masks)
    return (int)cudaErrorInvalidValue;
  p.n_slices_f = wg::forward_slices(D, skip_mask, false);
  p.n_slices_b = wg::backward_slices(D, skip_mask, p.dx != nullptr);

  const long long Mp = (M + kTile - 1) / kTile * kTile;
  p.M = M;
  p.S = S;
  p.Mp = Mp;
  bf16* cursor = ws;
  auto take = [&](long long cols) {
    bf16* plane = cursor;
    cursor += Mp * cols;
    return plane;
  };
  p.ws.pe = take(kPeCols);
  p.ws.h = take((long long)D * kW);
  p.ws.feat = take(kW);
  p.ws.hv = take(kWv);
  p.ws.g16 = take(kG16);
  p.ws.dz = take((long long)D * kW);
  p.ws.dfeat = take(kW);
  p.ws.dzv = take(kWv);

  WgradParams q = {};
  long long off = 0;
  int tiles = 0;
  auto job = [&](const bf16* a, int lda, const bf16* b, int ldb, int K, int N) {
    GemmJob& j = q.job[q.n_jobs++];
    j = GemmJob{a, b, lda, ldb, K, N, off, tiles};
    off += (long long)K * N;
    tiles += ((K + 127) / 128) * ((N + 127) / 128);
  };
  auto Hp = [&](int i) { return p.ws.h + (size_t)i * Mp * kW; };
  auto DZp = [&](int i) { return p.ws.dz + (size_t)i * Mp * kW; };
  job(p.ws.pe, kPeCols, DZp(0), kW, 64, kW);
  for (int i = 1; i < D; ++i) job(Hp(i - 1), kW, DZp(i), kW, kW, kW);
  for (int i = 1; i < D; ++i)
    if ((skip_mask >> i) & 1u) job(p.ws.pe, kPeCols, DZp(i), kW, 64, kW);
  job(Hp(D - 1), kW, p.ws.dfeat, kW, kW, kW);
  job(p.ws.feat, kW, p.ws.dzv, kWv, kW, kWv);
  job(p.ws.pe + kPeViews, kPeCols, p.ws.dzv, kWv, 32, kWv);
  job(Hp(D - 1), kW, p.ws.g16, kG16, kW, kG16);
  job(p.ws.hv, kWv, p.ws.g16, kG16, kWv, kG16);
  if (off != total) return (int)cudaErrorInvalidValue;
  q.rows = Mp;
  q.slice_rows = slice_rows;
  q.total = total;
  q.part = wpart;
  if (M == 0) return 0;

  const int n_slices = (int)((Mp + slice_rows - 1) / slice_rows);
  if (pass == 0) {
    cudaError_t err = cudaFuncSetAttribute(nerf_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kRowSmem);
    if (err != cudaSuccess) return (int)err;
    nerf_bwd_rows_kernel<<<(unsigned)(Mp / kTile), wg::kThreads, kRowSmem, st>>>(p);
  } else if (pass == 1) {
    cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kWgradSmem);
    if (err != cudaSuccess) return (int)err;
    wgrad_kernel<<<dim3((unsigned)tiles, (unsigned)n_slices), kWgradThreads, kWgradSmem, st>>>(q);
  } else {
    reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(wpart, total, n_slices, dw, 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nb = bias_elems(D);
    reduce_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(p.bias_part, nb, (int)(Mp / kTile), db, 0);
  }
  return (int)cudaGetLastError();
}
