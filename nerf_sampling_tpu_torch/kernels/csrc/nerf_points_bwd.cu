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
// 64-row tile's activations (10 x 64 x 256 bf16) do not fit in shared
// memory beside the weights' traffic, so it runs in three passes, all
// deterministic (no float atomics: two launches give the same bits, and
// want_dx does not change the weight grads):
//   (a) nerf_bwd_rows_kernel, one block per 64-row tile: recompute the
//       forward, writing the PE row and every bf16 activation to a device
//       workspace; then the d_h chain, layer by layer, through the
//       transposed weights, writing every bf16 d_z (and g16) beside them,
//       and the tile's fp32 bias-grad column sums; dx when asked;
//   (b) wgrad_kernel: every weight grad A^T @ dZ over the rows, as wmma
//       GEMMs (bf16, fp32 accumulation) of 64x64 output tiles, each over
//       one slice of rows, into fp32 partials per slice;
//   (c) reduce_kernel: the slices' partials (and the tiles' bias sums)
//       added in slice order, matrix grads rounded to bf16.
//
// What bounds it on the H100: the recompute (1.19 MFLOP a row), the d_h
// chain (about as much) and the weight grads (as much again), all on the
// tensor cores, plus the workspace: 10 KB a row written and read once
// (2 GB at the fine query's 196,608 rows). The GEMMs stage their operands
// through shared memory; no TMA or wgmma yet.

#include <cuda_runtime.h>

#include "nerf_mlp.cuh"

namespace nst {
namespace {

constexpr int kG16 = 16;  // width of the g16 plane: r, g, b, sigma, 0 x 12

struct BwdWeights {        // transposed copies, [out, in] row-major
  const bf16* twT[kMaxD];  // [W, W] for layers 1..D-1
  const bf16* featT;       // [W, W]
  const bf16* views_wfT;   // [W/2, W]
  const bf16* views_wsT;   // [W/2, 32]  (want_dx)
  const bf16* w0T;         // [W, 64]    (want_dx)
  const bf16* skipT[kMaxD];  // [W, 64]  (want_dx)
};

struct Workspace {  // bf16 planes of Mp rows (Mp = M rounded up to 64)
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
  float* bias_part;   // [Mp / 64, bias_elems]
  long long M, S, Mp;
  NerfWeights w;
  BwdWeights wt;
  Workspace ws;
};

constexpr size_t kRowSmem = kTileBytes + (kChunk * 8 + kChunk * 4 + kThreads) * sizeof(float) +
                            kChunk * kWv;                          // + the zv > 0 mask
constexpr size_t kDxSmem = kChunk * kPeCols * sizeof(float);      // dL/dPE, want_dx only

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16(v)); }

// a [64, cols] bf16 tile of shared memory to rows [row0, row0+64) of a plane
__device__ __forceinline__ void store_tile(const bf16* src, int lds, bf16* plane, int ldp,
                                           long long row0, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < kChunk * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    *reinterpret_cast<uint4*>(plane + (row0 + r) * ldp + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// lanes l and l^16 hold the even and odd rows of the same columns: their
// sum, written by lanes 0..15, is the column sum over the tile's 64 rows
template <int NT>
__device__ __forceinline__ void write_colsums(const float (&part)[NT], float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float v = part[j] + __shfl_xor_sync(0xffffffffu, part[j], 16);
    if (lane < 16) out[warp * NT * 16 + j * 16 + lane] = v;
  }
}

// dP[:, 0..N) += a [64, K] @ w [K, N] (N = 32 or 64): the dL/dPE hops of
// want_dx; warps take the 16x16 output tiles in turn
__device__ void gemm_small(const bf16* a, int lda, const bf16* w, int K, int N, float* dP,
                           float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s = scratch + warp * kScratchPerWarp;
  const int tiles = (kChunk / 16) * (N / 16);
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int i = tile % (kChunk / 16), j = tile / (kChunk / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + i * 16 * lda + k, lda);
      wmma::load_matrix_sync(fb, w + (size_t)k * N + j * 16, N);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(s, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) dP[(i * 16 + (e >> 4)) * kPeCols + j * 16 + (e & 15)] += s[e];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 2) nerf_bwd_rows_kernel(const __grid_constant__ RowParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t = carve_tiles(smem);
  float* q = reinterpret_cast<float*>(smem + kTileBytes);  // [64, 8] inputs
  float* gt = q + kChunk * 8;                              // [64, 4] fp32 cotangent
  float* red = gt + kChunk * 4;                            // [256] partial sums
  unsigned char* vmask = reinterpret_cast<unsigned char*>(red + kThreads);  // [64, W/2]
  float* dP = p.dx ? reinterpret_cast<float*>(vmask + kChunk * kWv) : nullptr;  // [64, 96]

  const NerfWeights& w = p.w;
  const int tid = threadIdx.x, D = w.D;
  const long long tile = blockIdx.x, row0 = tile * kChunk, Mp = p.Mp;
  const int valid = (int)min((long long)kChunk, p.M - row0);
  float* bp = p.bias_part + tile * bias_elems(D);
  auto H = [&](int i) { return p.ws.h + (size_t)i * Mp * kW; };
  auto DZ = [&](int i) { return p.ws.dz + (size_t)i * Mp * kW; };

  // ---- forward recompute: PE and every activation to the workspace
  point_pe(p.pts, p.dirs, row0, valid, p.S, t, q);
  store_tile(t.pe, kLdpe, p.ws.pe, kPeCols, row0, kPeCols);
  const Operand op0 = {t.pe, kLdpe, w.w0, 64};
  dense<kChunk / 16, kW / (16 * kWarps)>(&op0, 1, w.tb[0], t.x[0], kLdx, kRelu, t.scratch);
  __syncthreads();
  store_tile(t.x[0], kLdx, H(0), kW, row0, kW);
  int cur = 0;
  for (int i = 1; i < D; ++i) {
    const Operand ops[2] = {{t.x[cur], kLdx, w.tw[i], kW}, {t.pe, kLdpe, w.skip_w[i], 64}};
    dense<kChunk / 16, kW / (16 * kWarps)>(ops, ((w.skip_mask >> i) & 1u) ? 2 : 1, w.tb[i],
                                           t.x[cur ^ 1], kLdx, kRelu, t.scratch);
    __syncthreads();
    cur ^= 1;
    store_tile(t.x[cur], kLdx, H(i), kW, row0, kW);
  }
  bf16* A = t.x[cur];      // h_{D-1}, then hv, then d_feature16, then every other d_z16
  bf16* B = t.x[cur ^ 1];  // the feature, then d_zv16, then every other d_z16
  const Operand opf = {A, kLdx, w.feat_w, kW};
  dense<kChunk / 16, kW / (16 * kWarps)>(&opf, 1, w.feat_b, B, kLdx, kNone, t.scratch);
  __syncthreads();
  store_tile(B, kLdx, p.ws.feat, kW, row0, kW);
  {
    const Operand opv[2] = {{B, kLdx, w.views_wf, kW}, {t.pe + kPeViews, kLdpe, w.views_ws, 32}};
    gemm_rows<kChunk / 16, kWv / (16 * kWarps)>(opv, 2, t.scratch, [&](int r, int col, float v, int) {
      const float zv = v + w.views_b[col];
      vmask[r * kWv + col] = zv > 0.f;
      A[r * kLdx + col] = __float2bfloat16(activate(zv, kRelu));
    });
  }
  for (int e = tid; e < kChunk * 4; e += kThreads)
    gt[e] = (e >> 2) < valid ? p.g[(row0 + (e >> 2)) * 4 + (e & 3)] : 0.f;
  __syncthreads();
  store_tile(A, kLdx, p.ws.hv, kWv, row0, kWv);

  // ---- backward: the heads
  for (int e = tid; e < kChunk * kG16; e += kThreads) {
    const int r = e / kG16, c = e % kG16;
    p.ws.g16[(row0 + r) * kG16 + c] = __float2bfloat16(c < 4 ? gt[r * 4 + c] : 0.f);
  }
  if (tid < 4) {  // rgb_b and alpha_b: column sums of the fp32 cotangent
    float s = 0.f;
    for (int r = 0; r < kChunk; ++r) s += gt[r * 4 + tid];
    bp[D * kW + kW + kWv + tid] = s;
  }
  {  // d_zv = (zv > 0) * g16[:, :3] @ rgb_w: two threads per column, 32 rows each
    const int col = tid % kWv, half = tid / kWv;
    const float w0 = bf(w.rgb_w[col]), w1 = bf(w.rgb_w[kWv + col]), w2 = bf(w.rgb_w[2 * kWv + col]);
    float s = 0.f;
    for (int r = half * 32; r < half * 32 + 32; ++r) {
      const float d = rnd(gt[r * 4]) * w0 + rnd(gt[r * 4 + 1]) * w1 + rnd(gt[r * 4 + 2]) * w2;
      const float dz = vmask[r * kWv + col] ? d : 0.f;
      s += dz;
      B[r * kLdx + col] = __float2bfloat16(dz);
    }
    red[tid] = s;
  }
  __syncthreads();
  if (tid < kWv) bp[D * kW + kW + tid] = red[tid] + red[tid + kWv];
  store_tile(B, kLdx, p.ws.dzv, kWv, row0, kWv);
  if (dP) {
    for (int e = tid; e < kChunk * kPeCols; e += kThreads) dP[e] = 0.f;
    __syncthreads();
    gemm_small(B, kLdx, p.wt.views_wsT, kWv, 32, dP + kPeViews, t.scratch);
  }
  {  // d_feature = d_zv16 @ views_wf^T; its fp32 column sums are feature_b's grad
    const Operand op = {B, kLdx, p.wt.views_wfT, kWv};
    float part[kW / (16 * kWarps)] = {};
    gemm_rows<kChunk / 16, kW / (16 * kWarps)>(&op, 1, t.scratch, [&](int r, int col, float v, int j) {
      part[j] += v;
      A[r * kLdx + col] = __float2bfloat16(v);
    });
    write_colsums(part, bp + D * kW);
  }
  __syncthreads();
  store_tile(A, kLdx, p.ws.dfeat, kW, row0, kW);

  // ---- the trunk: d_h of the last layer is the alpha head's part plus the
  // feature layer's; then d_h_{i-1} = d_z16_i @ tw[i]^T down the layers
  for (int i = D - 1; i >= 0; --i) {
    // A holds the operand (d_feature16, then d_z16_{i+1}); B receives d_z16_i
    const bf16* hm = H(i) + row0 * kW;
    const bool last = i == D - 1;
    const Operand op = {A, kLdx, last ? p.wt.featT : p.wt.twT[i + 1], kW};
    float part[kW / (16 * kWarps)] = {};
    gemm_rows<kChunk / 16, kW / (16 * kWarps)>(&op, 1, t.scratch, [&](int r, int col, float v, int j) {
      if (last) v += rnd(gt[r * 4 + 3]) * bf(w.alpha_w[col]);
      const float dz = bf(hm[r * kW + col]) > 0.f ? v : 0.f;
      part[j] += dz;
      B[r * kLdx + col] = __float2bfloat16(dz);
    });
    write_colsums(part, bp + i * kW);
    __syncthreads();
    store_tile(B, kLdx, DZ(i), kW, row0, kW);
    if (dP) {  // the point embedding's share: the skip layer's rows, then w0's
      if (i > 0 && ((w.skip_mask >> i) & 1u)) gemm_small(B, kLdx, p.wt.skipT[i], kW, 64, dP, t.scratch);
      if (i == 0) gemm_small(B, kLdx, p.wt.w0T, kW, 64, dP, t.scratch);
    }
    bf16* tmp = A;
    A = B;
    B = tmp;
  }

  if (dP) {  // dL/dx through the PE, in fp32
    __syncthreads();
    for (int e = tid; e < kChunk * 6; e += kThreads) {
      const int r = e / 6, c = e % 6;
      if (r >= valid) continue;
      const int base = c < 3 ? 0 : kPeViews, k = c % 3, L = c < 3 ? (kPtsCh - 3) / 6 : (kViewCh - 3) / 6;
      const float u = q[r * 8 + c];
      const float* d = dP + r * kPeCols + base;
      float s = d[k];
      for (int f = 0; f < L; ++f) {
        const float sc = (float)(1 << f), a = u * sc;
        s += sc * (d[3 + 6 * f + k] * cosf(a) - d[6 + 6 * f + k] * sinf(a));
      }
      p.dx[(row0 + r) * 6 + c] = s;
    }
  }
}

// ---- (b) the weight grads: C[K, N] = sum over rows of A[m, k] * B[m, n]

constexpr int kMaxJobs = 40;
constexpr int kGemmThreads = 128;  // 4 warps, 32x32 of the 64x64 output tile each
constexpr int kLds = 64 + 8;       // staged tile stride (bf16)

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

__global__ void __launch_bounds__(kGemmThreads) wgrad_kernel(const __grid_constant__ WgradParams p) {
  __shared__ __align__(128) bf16 As[64 * kLds];
  __shared__ __align__(128) bf16 Bs[64 * kLds];
  __shared__ __align__(128) float stage[4 * 256];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int jid = 0;
  while (jid + 1 < p.n_jobs && p.job[jid + 1].tile0 <= (int)blockIdx.x) ++jid;
  const GemmJob& J = p.job[jid];
  const int local = blockIdx.x - J.tile0, tn = (J.N + 63) / 64;
  const int k0 = (local / tn) * 64, n0 = (local % tn) * 64;
  const long long m_begin = (long long)blockIdx.y * p.slice_rows;
  const long long m_end = min(p.rows, m_begin + p.slice_rows);
  const int wk = warp >> 1, wn = warp & 1;
  bool ok_k[2], ok_n[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    ok_k[f] = k0 + wk * 32 + f * 16 < J.K;
    ok_n[f] = n0 + wn * 32 + f * 16 < J.N;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int fi = 0; fi < 2; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj) wmma::fill_fragment(acc[fi][fj], 0.f);

  for (long long m0 = m_begin; m0 < m_end; m0 += 64) {
    for (int e = tid; e < 64 * 8; e += kGemmThreads) {
      const int r = e >> 3, c = (e & 7) * 8;
      const bool row_ok = m0 + r < m_end;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (row_ok && k0 + c < J.K) va = *reinterpret_cast<const uint4*>(J.a + (m0 + r) * J.lda + k0 + c);
      if (row_ok && n0 + c < J.N) vb = *reinterpret_cast<const uint4*>(J.b + (m0 + r) * J.ldb + n0 + c);
      *reinterpret_cast<uint4*>(As + r * kLds + c) = va;
      *reinterpret_cast<uint4*>(Bs + r * kLds + c) = vb;
    }
    __syncthreads();
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if (ok_k[f]) wmma::load_matrix_sync(fa[f], As + kk * kLds + wk * 32 + f * 16, kLds);
        if (ok_n[f]) wmma::load_matrix_sync(fb[f], Bs + kk * kLds + wn * 32 + f * 16, kLds);
      }
#pragma unroll
      for (int fi = 0; fi < 2; ++fi)
#pragma unroll
        for (int fj = 0; fj < 2; ++fj)
          if (ok_k[fi] && ok_n[fj]) wmma::mma_sync(acc[fi][fj], fa[fi], fb[fj], acc[fi][fj]);
    }
    __syncthreads();
  }

  float* s = stage + warp * 256;
  float* part = p.part + (long long)blockIdx.y * p.total + J.out;
#pragma unroll
  for (int fi = 0; fi < 2; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj) {
      if (!(ok_k[fi] && ok_n[fj])) continue;
      wmma::store_matrix_sync(s, acc[fi][fj], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int k = k0 + wk * 32 + fi * 16 + (e >> 4), n = n0 + wn * 32 + fj * 16 + (e & 15);
        part[(long long)k * J.N + n] = s[e];
      }
      __syncwarp();
    }
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
// elements. The weight-grad result has `total` elements, the sum over the
// jobs (see nst_nerf_points_bwd).
extern "C" int nst_nerf_points_bwd_sizes(long long M, int D, long long total, int slice_rows,
                                         long long* out) {
  using namespace nst;
  if (D < 1 || D > kMaxD || slice_rows < 64 || slice_rows % 64) return (int)cudaErrorInvalidValue;
  const long long Mp = (M + kChunk - 1) / kChunk * kChunk;
  out[0] = Mp * ws_elems_per_row(D);
  out[1] = Mp / kChunk * bias_elems(D);
  out[2] = (Mp + slice_rows - 1) / slice_rows * total;
  out[3] = bias_elems(D);
  return 0;
}

// ptrs, in order: pts, dirs, g, dx (or null: want_dx off), the bf16
// workspace, the bias partials, the weight-grad partials, dw (fp32 [total]:
// the matrix grads, bf16-rounded, in job order), db (fp32, bias_elems);
// then the NeRF's weights (nerf_mlp.cuh::read_weights, all heads); then
// the transposed copies: tw[i]^T for i = 1..D-1, feature_w^T, views_wf^T,
// and with dx also views_ws^T, w0^T and skip_w[i]^T for each skip layer.
// The jobs of dw, each [K, N] row-major: w0 [64, W], tw[i] [W, W] for
// i = 1..D-1, skip_w[i] [64, W] for each skip layer, feature_w [W, W],
// views_wf [W, W/2], views_ws [32, W/2], then h_{D-1}^T g16 [W, 16] (the
// alpha head's grad in column 3) and hv^T g16 [W/2, 16] (the rgb head's in
// columns 0..2). Returns a cudaError_t.
extern "C" int nst_nerf_points_bwd(const void* const* ptrs, int n_ptrs, long long M, long long S, int D,
                                   unsigned skip_mask, long long total, int slice_rows, void* stream) {
  using namespace nst;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || M % S != 0 || slice_rows < 64 || slice_rows % 64) return (int)cudaErrorInvalidValue;
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
  int k = 9;
  const int kw = read_weights(ptrs + k, D, skip_mask, false, &p.w);
  if (kw < 0) return (int)cudaErrorInvalidValue;
  k += kw;
  for (int i = 1; i < D; ++i) p.wt.twT[i] = static_cast<const bf16*>(ptrs[k++]);
  p.wt.featT = static_cast<const bf16*>(ptrs[k++]);
  p.wt.views_wfT = static_cast<const bf16*>(ptrs[k++]);
  if (p.dx) {
    p.wt.views_wsT = static_cast<const bf16*>(ptrs[k++]);
    p.wt.w0T = static_cast<const bf16*>(ptrs[k++]);
    for (int i = 1; i < D; ++i)
      if ((skip_mask >> i) & 1u) p.wt.skipT[i] = static_cast<const bf16*>(ptrs[k++]);
  }
  if (k != n_ptrs) return (int)cudaErrorInvalidValue;

  const long long Mp = (M + kChunk - 1) / kChunk * kChunk;
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
    tiles += ((K + 63) / 64) * ((N + 63) / 64);
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

  const size_t smem = kRowSmem + (p.dx ? kDxSmem : 0);
  cudaError_t err = cudaFuncSetAttribute(nerf_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  nerf_bwd_rows_kernel<<<(unsigned)(Mp / kChunk), kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (int)((Mp + slice_rows - 1) / slice_rows);
  wgrad_kernel<<<dim3((unsigned)tiles, (unsigned)n_slices), kGemmThreads, 0, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(wpart, total, n_slices, dw, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = bias_elems(D);
  reduce_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(p.bias_part, nb, (int)(Mp / kChunk), db, 0);
  return (int)cudaGetLastError();
}
