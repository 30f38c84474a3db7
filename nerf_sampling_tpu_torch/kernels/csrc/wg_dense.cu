// One dense layer on the wgmma core (mlp_wgmma.cuh), for the [core] check
// of chip_smoke.py: out = act(a @ w + a2 @ w2 + bias) in bf16, with fp32
// accumulation, over M rows in 128-row tiles (the rows past M are zero);
// its s8 mode, out = a @ wq^T as int32 sums of int8 operands (the int8
// NeRF's products, K10); and its fp32 mode, out = act(a @ w + bias) in fp32
// with 3xTF32 products (K7 in fp32) over 64-row tiles. It exercises the
// pieces the NeRF kernels build on, at a size the check can hold against a
// matmul: the swizzled activation tiles (bf16 and int8), the fp32 path's
// thread-private A fragments and permuted hi/lo slices, the ring of
// bulk-copied weight slices, the consumer warpgroups, a second operand
// accumulated into the same sums, and the register epilogue. Beside them,
// nst_pe_fill_check fills PE tiles with the render kernels' fill
// (mlp_wgmma.cuh::stage_views and pe_fill) and with the per-column formula
// it replaced, for [core] to hold the two to the same bytes;
// nst_point_fill_check does the same for the point-query kernels' fill
// (mlp_wgmma.cuh::point_fill).

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"

namespace nst {
namespace {

constexpr int kStages = 4;

struct DenseParams {
  const bf16* a;       // [M, K]
  const bf16* a2;      // [M, 64] or null
  const bf16* slices;  // the product's slices (w, then w2)
  const float* bias;   // [N]
  bf16* out;           // [M, N]
  long long M;
  int K, N, act, n_slices;
};

constexpr size_t kDenseSmem = 1024 + 5 * wg::kPanelBytes + wg::Ring<kStages>::kBytes;

// rows [row0, row0 + 128) of a [M, cols] bf16 matrix into a swizzled tile
__device__ void load_rows(const bf16* src, long long M, int cols, long long row0, unsigned char* tile) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < wg::kRows * per_row; e += wg::kConsumers) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < M) v = *reinterpret_cast<const uint4*>(src + (row0 + r) * cols + c);
    *reinterpret_cast<uint4*>(tile + wg::tile_offset(r, c)) = v;
  }
}

// rows [row0, row0 + 128) of a [M, cols] int8 matrix into a swizzled int8 tile
__device__ void load_rows_q(const int8_t* src, long long M, int cols, long long row0, unsigned char* tile) {
  const int per_row = cols / 16;
  for (int e = threadIdx.x; e < wg::kRows * per_row; e += wg::kConsumers) {
    const int r = e / per_row, c = (e - r * per_row) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < M) v = *reinterpret_cast<const uint4*>(src + (row0 + r) * cols + c);
    *reinterpret_cast<uint4*>(tile + wg::qtile_offset(r, c)) = v;
  }
}

template <int NH>
__device__ void dense_tile(const DenseParams& p, const wg::Src* ops, int n_ops, const wg::Ring<kStages>& ring,
                           long long row0) {
  wg::Cursor cur;
  float acc[NH][64];
  wg::gemm(acc, ops, n_ops, ring, cur);
  wg::bias_act(acc, p.bias, p.act);
  const long long r0 = row0 + 64 * (threadIdx.x >> 7);
  wg::for_pairs<NH>([&](int r, int col, int h, int i) {
    if (r0 + r < p.M)
      *reinterpret_cast<__nv_bfloat162*>(p.out + (r0 + r) * p.N + col) =
          __floats2bfloat162_rn(acc[h][i], acc[h][i + 1]);
  });
}

__global__ void __launch_bounds__(wg::kThreads, 1) wg_dense_kernel(const __grid_constant__ DenseParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x = base;
  unsigned char* x2 = base + 4 * wg::kPanelBytes;
  const wg::Ring<kStages> ring{wg::smem_u32(base + 5 * wg::kPanelBytes)};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= wg::kConsumers) {  // the producer warp
    const wg::Segment seg = {p.slices, p.n_slices, 1};
    wg::produce(ring, &seg, 1);
    return;
  }
  const long long row0 = (long long)blockIdx.x * wg::kRows;
  load_rows(p.a, p.M, p.K, row0, x);
  if (p.a2) load_rows(p.a2, p.M, 64, row0, x2);
  wg::fence_async_smem();
  wg::consumers_sync();
  const wg::Src ops[2] = {{wg::smem_u32(x), p.K / 64}, {wg::smem_u32(x2), 1}};
  if (p.N == 256) dense_tile<2>(p, ops, p.a2 ? 2 : 1, ring, row0);
  else dense_tile<1>(p, ops, p.a2 ? 2 : 1, ring, row0);
}

struct DenseQParams {
  const int8_t* a;     // [M, K]
  const bf16* slices;  // wq's int8 slices (fused_render.wgmma_qslices)
  int* out;            // [M, N] int32
  long long M;
  int K, N, n_slices;
};

template <int NH>
__device__ void dense_tile_q(const DenseQParams& p, const wg::Src& op, const wg::Ring<kStages>& ring,
                             long long row0) {
  wg::Cursor cur;
  int acc[NH][64];
  wg::gemm(acc, &op, 1, ring, cur);
  const long long r0 = row0 + 64 * (threadIdx.x >> 7);
  wg::for_pairs<NH>([&](int r, int col, int h, int i) {
    if (r0 + r < p.M) *reinterpret_cast<int2*>(p.out + (r0 + r) * p.N + col) = make_int2(acc[h][i], acc[h][i + 1]);
  });
}

__global__ void __launch_bounds__(wg::kThreads, 1) wg_dense_q_kernel(const __grid_constant__ DenseQParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  const wg::Ring<kStages> ring{wg::smem_u32(base + 5 * wg::kPanelBytes)};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= wg::kConsumers) {  // the producer warp
    const wg::Segment seg = {p.slices, p.n_slices, 1};
    wg::produce(ring, &seg, 1);
    return;
  }
  const long long row0 = (long long)blockIdx.x * wg::kRows;
  load_rows_q(p.a, p.M, p.K, row0, base);
  wg::fence_async_smem();
  wg::consumers_sync();
  const wg::Src op = {wg::smem_u32(base), p.K / 128};
  if (p.N == 256) dense_tile_q<2>(p, op, ring, row0);
  else dense_tile_q<1>(p, op, ring, row0);
}

struct Dense32Params {
  const float* a;      // [M, K]
  const bf16* slices;  // w's hi and lo slices (fused_render.wgmma_slices32)
  const float* bias;   // [N]
  float* out;          // [M, N]
  long long M;
  int K, N, act, n_slices;
};

constexpr size_t kDense32Smem = 1024 + wg::Tiles32<wg::kStages32>::kBytes;

template <int NH>
__device__ void dense_tile32(const Dense32Params& p, const wg::Tiles32<wg::kStages32>& t, long long row0) {
  wg::Cursor cur;
  float acc[NH][64];
  const wg::Src32 op = {t.x, p.K / 8};
  wg::gemm_tf32(acc, &op, 1, t.ring, cur);
  wg::bias_act32(acc, p.bias, p.act);
  wg::for_pairs<NH>([&](int r, int col, int h, int i) {
    if (row0 + r < p.M) *reinterpret_cast<float2*>(p.out + (row0 + r) * p.N + col) = make_float2(acc[h][i], acc[h][i + 1]);
  });
}

__global__ void __launch_bounds__(wg::kThreads32, 1) wg_dense32_kernel(const __grid_constant__ Dense32Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  const wg::Tiles32<wg::kStages32> t = wg::carve32<wg::kStages32>(base);
  if (threadIdx.x == 0) t.ring.init(wg::kConsumers32 / 32);
  __syncthreads();
  if (threadIdx.x >= wg::kConsumers32) {  // the producer warp
    const wg::Segment seg = {p.slices, p.n_slices, 1};
    wg::produce(t.ring, &seg, 1, wg::kConsumers32);
    return;
  }
  // the thread's A values, read from the rows it holds into its store
  const long long row0 = (long long)blockIdx.x * wg::kRows32;
  const int lane = threadIdx.x & 31, c = 2 * (lane & 3);
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  for (int g = 0; g < p.K / 8; ++g) {
    float e[4];
    for (int k = 0; k < 4; ++k) {
      const long long row = row0 + r0 + 8 * (k >> 1);
      e[k] = row < p.M ? p.a[row * p.K + 8 * g + c + (k & 1)] : 0.f;
    }
    t.x[g * wg::kConsumers32 + threadIdx.x] = make_float4(e[0], e[1], e[2], e[3]);
  }
  if (p.N == 256) dense_tile32<2>(p, t, row0);
  else dense_tile32<1>(p, t, row0);
}

// ---- the render kernels' PE fill against the per-column formula it replaced

constexpr int kPeMaxRays = 64;    // rays a block, as K2's
constexpr int kPeMaxRows = 1536;  // sample rows a block, as the render kernels'

struct PeCheckParams {
  const float* rays_o;  // [n, 3]
  const float* rays_d;  // [n, 3]
  const float* z;       // [n * S]
  bf16* out;            // [2, grid * tiles * 128, 128]: the fill's rows, then the per-column formula's
  long long n;
  int S, R, tiles, sigma_only;
};

constexpr size_t kPeCheckSmem = 1024 + 4 * wg::kPanelBytes + kPeMaxRays * (8 * sizeof(float) + 32 * sizeof(bf16));

// The PE tile of rows [c0, c0 + 128) as the render kernels filled it before
// stage_views and pe_fill: every element by nerf_mlp.cuh::embed, at one
// 2-byte store each; this warpgroup's rows.
__device__ void pe_fill_per_column(unsigned char* pe, const float* ray, const float* z, int c0, int rows, int Sr) {
  const int g = threadIdx.x >> 7, lt = threadIdx.x & 127;
  for (int e = lt; e < 64 * 128; e += 128) {
    const int rr = 64 * g + (e >> 7), col = e & 127, row = c0 + rr;
    float v = 0.f;
    if (row < rows && (col < kPtsCh || (col >= kPeViews && col < kPeViews + kViewCh))) {
      const float* q = ray + 8 * (row / Sr);
      float u[3];
      if (col < kPtsCh) {
        const float zr = z[row];
        for (int k = 0; k < 3; ++k) u[k] = __fadd_rn(q[k], __fmul_rn(q[3 + k], zr));
        v = embed(u, col);
      } else {
        for (int k = 0; k < 3; ++k) u[k] = __fdiv_rn(q[3 + k], q[6]);
        v = embed(u, col - kPeViews);
      }
    }
    *reinterpret_cast<bf16*>(pe + wg::tile_offset(rr, col)) = __float2bfloat16(v);
  }
}

// One block per R rays (R S sample rows in `tiles` 128-row tiles), two
// consumer warpgroups and no producer: the rays staged as the render
// kernels stage them, then per tile both fills and both tiles' rows out.
__global__ void __launch_bounds__(wg::kConsumers, 1) pe_check_kernel(const __grid_constant__ PeCheckParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* pe_new = base;
  unsigned char* pe_ref = base + 2 * wg::kPanelBytes;
  float* ray = reinterpret_cast<float*>(base + 4 * wg::kPanelBytes);
  bf16* view = reinterpret_cast<bf16*>(ray + 8 * kPeMaxRays);
  const long long ray0 = (long long)blockIdx.x * p.R;
  const int nr = (int)min((long long)p.R, p.n - ray0), rows = nr * p.S;
  // the fill's tile starts as 0xFF bytes: a column it leaves unwritten shows
  for (int e = threadIdx.x; e < 2 * wg::kPanelBytes / 16; e += wg::kConsumers)
    reinterpret_cast<uint4*>(pe_new)[e] = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int r = threadIdx.x; r < nr; r += wg::kConsumers) {
    float* q = ray + 8 * r;
    for (int c = 0; c < 3; ++c) {
      q[c] = p.rays_o[(ray0 + r) * 3 + c];
      q[3 + c] = p.rays_d[(ray0 + r) * 3 + c];
    }
    q[6] = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5]);
    q[7] = 0.f;
  }
  __syncthreads();
  const float* z = p.z + ray0 * p.S;
  const long long total = (long long)gridDim.x * p.tiles * wg::kRows;
  if (!p.sigma_only) wg::stage_views(ray, nr, view, pe_new);
  for (int t = 0; t < p.tiles; ++t) {
    wg::pe_fill(pe_new, ray, view, z, t * wg::kRows, rows, p.S, p.sigma_only);
    pe_fill_per_column(pe_ref, ray, z, t * wg::kRows, rows, p.S);
    wg::group_sync();
    const long long row0 = ((long long)blockIdx.x * p.tiles + t) * wg::kRows;
    wg::copy_rows(pe_new, 128, p.out, row0);
    wg::copy_rows(pe_ref, 128, p.out + total * 128, row0);
    wg::group_sync();
  }
}

struct PointCheckParams {
  const float* pts;   // [M, 3]
  const float* dirs;  // [M / S, 3]
  bf16* out;          // [2, Mp, 128]: point_fill's tiles, then the per-column formula's
  float* q_out;       // [2, Mp, 8]: the tiles' inputs q, likewise
  long long M, S;
  int tiles_per_block, rolled;
};

constexpr int kPointViewBytes = wg::kRows * 32 * sizeof(bf16);
constexpr size_t kPointCheckSmem = 1024 + 4 * wg::kPanelBytes + 2 * wg::kRows * 8 * sizeof(float) + 2 * kPointViewBytes;

// The PE tile of one 128-row tile of point queries as K4 and K5 filled it
// before point_fill: the tile's inputs into q (8 floats a row), then every
// element by nerf_mlp.cuh::embed from q, at one 2-byte store each; this
// warpgroup's rows, rows [valid, 128) zero.
__device__ void point_pe_per_column(const float* __restrict__ pts, const float* __restrict__ dirs, long long row0,
                                    int valid, long long S, float* q, unsigned char* pe) {
  const int g = threadIdx.x >> 7, lt = threadIdx.x & 127;
  wg::group_sync();
  for (int e = lt; e < 64 * 8; e += 128) {
    const int rr = 64 * g + (e >> 3), c = e & 7;
    float v = 0.f;
    if (rr < valid && c < 6) {
      const long long row = row0 + rr;
      v = c < 3 ? pts[row * 3 + c] : dirs[(row / S) * 3 + (c - 3)];
    }
    q[rr * 8 + c] = v;
  }
  wg::group_sync();
  for (int e = lt; e < 64 * 128; e += 128) {
    const int rr = 64 * g + (e >> 7), col = e & 127;
    float v = 0.f;
    if (rr < valid) {
      if (col < kPtsCh) v = embed(q + rr * 8, col);
      else if (col >= kPeViews && col < kPeViews + kViewCh) v = embed(q + rr * 8 + 3, col - kPeViews);
    }
    *reinterpret_cast<bf16*>(pe + wg::tile_offset(rr, col)) = __float2bfloat16(v);
  }
  wg::fence_async_smem();
  wg::group_sync();
}

// K4's walk of the tiles (tiles_per_block consecutive 128-row tiles a
// block, its two view stagings in turn), two consumer warpgroups and no
// producer: per tile both fills (point_fill unrolled as K4's, or rolled as
// K5's) and both tiles' rows and inputs out.
__global__ void __launch_bounds__(wg::kConsumers, 1) point_check_kernel(const __grid_constant__ PointCheckParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* pe_new = base;
  unsigned char* pe_ref = base + 2 * wg::kPanelBytes;
  float* q_new = reinterpret_cast<float*>(base + 4 * wg::kPanelBytes);
  float* q_ref = q_new + wg::kRows * 8;
  bf16* view = reinterpret_cast<bf16*>(q_ref + wg::kRows * 8);
  const long long tiles = (p.M + wg::kRows - 1) / wg::kRows, tile0 = (long long)blockIdx.x * p.tiles_per_block;
  const int n_tiles = (int)min((long long)p.tiles_per_block, tiles - tile0);
  const long long Mp = tiles * wg::kRows;
  // the fill's tile and inputs start as 0xFF bytes: a column it leaves unwritten shows
  for (int e = threadIdx.x; e < 2 * wg::kPanelBytes / 16; e += wg::kConsumers)
    reinterpret_cast<uint4*>(pe_new)[e] = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int e = threadIdx.x; e < wg::kRows * 8; e += wg::kConsumers) q_new[e] = __int_as_float(~0);
  __syncthreads();
  for (int k = 0; k < n_tiles; ++k) {
    const long long row0 = (tile0 + k) * wg::kRows;
    const int valid = (int)min((long long)wg::kRows, p.M - row0);
    bf16* v = view + (k & 1) * (kPointViewBytes / 2);
    if (p.rolled) wg::point_fill<true>(p.pts, p.dirs, row0, valid, p.S, v, q_new, pe_new);
    else wg::point_fill(p.pts, p.dirs, row0, valid, p.S, v, q_new, pe_new);
    point_pe_per_column(p.pts, p.dirs, row0, valid, p.S, q_ref, pe_ref);
    wg::copy_rows(pe_new, 128, p.out, row0);
    wg::copy_rows(pe_ref, 128, p.out + Mp * 128, row0);
    for (int e = threadIdx.x & 127; e < 64 * 8; e += 128) {
      const int rr = 64 * (threadIdx.x >> 7) + (e >> 3), c = e & 7;
      p.q_out[(row0 + rr) * 8 + c] = q_new[rr * 8 + c];
      p.q_out[(Mp + row0 + rr) * 8 + c] = q_ref[rr * 8 + c];
    }
    wg::group_sync();
  }
}

}  // namespace
}  // namespace nst

// The PE fill check. ptrs: rays_o [n, 3], rays_d [n, 3], z [n * S] (row
// s of ray i at i * S + s), out [2, grid * tiles * 128, 128] bf16 with grid
// = ceil(n / R) and tiles = ceil(R * S / 128): block b's rays [b R, b R +
// R), its tile t's rows at (b tiles + t) * 128, the render kernels' fill
// first, the per-column formula's second (rows past a block's R S, and past
// its last ray, zero). sigma_only: the fill leaves the view panel (columns
// 64-127) as it found it, 0xFF bytes. R S <= 1536, R <= 64. Returns a
// cudaError_t.
extern "C" int nst_pe_fill_check(const void* const* ptrs, int n_ptrs, long long n, int S, int R, int sigma_only,
                                 void* stream) {
  using namespace nst;
  if (n_ptrs != 4 || S < 1 || R < 1 || R > kPeMaxRays || R * S > kPeMaxRows) return (int)cudaErrorInvalidValue;
  PeCheckParams p = {};
  p.rays_o = static_cast<const float*>(ptrs[0]);
  p.rays_d = static_cast<const float*>(ptrs[1]);
  p.z = static_cast<const float*>(ptrs[2]);
  p.out = static_cast<bf16*>(const_cast<void*>(ptrs[3]));
  p.n = n;
  p.S = S;
  p.R = R;
  p.tiles = (R * S + wg::kRows - 1) / wg::kRows;
  p.sigma_only = sigma_only;
  cudaError_t err = cudaFuncSetAttribute(pe_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kPeCheckSmem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  pe_check_kernel<<<(unsigned)((n + R - 1) / R), wg::kConsumers, kPeCheckSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The point-query PE fill check. ptrs: pts [M, 3], dirs [M / S, 3], out [2,
// Mp, 128] bf16 and q_out [2, Mp, 8] fp32 with Mp = M rounded up to 128:
// tile t's rows at t * 128, K4's and K5's fill (point_fill; rolled: K5's
// form) first, the per-column formula it replaced second (rows from M on
// zero); blocks walk tiles_per_block tiles, as K4's. Returns a cudaError_t.
extern "C" int nst_point_fill_check(const void* const* ptrs, int n_ptrs, long long M, long long S,
                                    int tiles_per_block, int rolled, void* stream) {
  using namespace nst;
  if (n_ptrs != 4 || S < 1 || M % S != 0 || tiles_per_block < 1) return (int)cudaErrorInvalidValue;
  PointCheckParams p = {};
  p.pts = static_cast<const float*>(ptrs[0]);
  p.dirs = static_cast<const float*>(ptrs[1]);
  p.out = static_cast<bf16*>(const_cast<void*>(ptrs[2]));
  p.q_out = static_cast<float*>(const_cast<void*>(ptrs[3]));
  p.M = M;
  p.S = S;
  p.tiles_per_block = tiles_per_block;
  p.rolled = rolled;
  cudaError_t err = cudaFuncSetAttribute(point_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kPointCheckSmem);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  const long long tiles = (M + wg::kRows - 1) / wg::kRows;
  point_check_kernel<<<(unsigned)((tiles + tiles_per_block - 1) / tiles_per_block), wg::kConsumers, kPointCheckSmem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: a [M, K], a2 [M, 64] or null, the slices of w [K, N] then (with
// a2) of w2 [64, N] (fused_render.wgmma_slices), bias [N], out [M, N].
// K in {64, 128, 192, 256}, N in {128, 256}. Returns a cudaError_t.
extern "C" int nst_wg_dense(const void* const* ptrs, int n_ptrs, long long M, int K, int N, int act,
                            void* stream) {
  using namespace nst;
  if (n_ptrs != 5 || K < 64 || K > 256 || K % 64 || (N != 128 && N != 256) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  DenseParams p = {};
  p.a = static_cast<const bf16*>(ptrs[0]);
  p.a2 = static_cast<const bf16*>(ptrs[1]);
  p.slices = static_cast<const bf16*>(ptrs[2]);
  p.bias = static_cast<const float*>(ptrs[3]);
  p.out = static_cast<bf16*>(const_cast<void*>(ptrs[4]));
  p.M = M;
  p.K = K;
  p.N = N;
  p.act = act;
  p.n_slices = (K / 64 + (p.a2 ? 1 : 0)) * (N / 128);
  cudaError_t err = cudaFuncSetAttribute(wg_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kDenseSmem);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  wg_dense_kernel<<<(unsigned)((M + wg::kRows - 1) / wg::kRows), wg::kThreads, kDenseSmem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The s8 mode. ptrs: a [M, K] int8, wq's int8 slices (fused_render.
// wgmma_qslices of wq [N, K], [out, in] as the int8 NeRF's matrices), out
// [M, N] int32: the exact sums a @ wq^T. K in {128, 256}, N in {128, 256}.
// Returns a cudaError_t.
extern "C" int nst_wg_dense_q(const void* const* ptrs, int n_ptrs, long long M, int K, int N, void* stream) {
  using namespace nst;
  if (n_ptrs != 3 || (K != 128 && K != 256) || (N != 128 && N != 256)) return (int)cudaErrorInvalidValue;
  DenseQParams p = {};
  p.a = static_cast<const int8_t*>(ptrs[0]);
  p.slices = static_cast<const bf16*>(ptrs[1]);
  p.out = static_cast<int*>(const_cast<void*>(ptrs[2]));
  p.M = M;
  p.K = K;
  p.N = N;
  p.n_slices = (K / 128) * (N / 128);
  cudaError_t err = cudaFuncSetAttribute(wg_dense_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kDenseSmem);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  wg_dense_q_kernel<<<(unsigned)((M + wg::kRows - 1) / wg::kRows), wg::kThreads, kDenseSmem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The fp32 mode. ptrs: a [M, K] fp32, w's hi and lo slices
// (fused_render.wgmma_slices32 of w [K, N]), bias [N], out [M, N] fp32:
// act(a @ w + bias) with 3xTF32 products and fp32 sums. K in {32, 64, ...,
// 256}, N in {128, 256}. Returns a cudaError_t.
extern "C" int nst_wg_dense32(const void* const* ptrs, int n_ptrs, long long M, int K, int N, int act,
                              void* stream) {
  using namespace nst;
  if (n_ptrs != 4 || K < 32 || K > 256 || K % 32 || (N != 128 && N != 256) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  Dense32Params p = {};
  p.a = static_cast<const float*>(ptrs[0]);
  p.slices = static_cast<const bf16*>(ptrs[1]);
  p.bias = static_cast<const float*>(ptrs[2]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[3]));
  p.M = M;
  p.K = K;
  p.N = N;
  p.act = act;
  p.n_slices = 2 * (K / 32) * (N / 128);
  cudaError_t err = cudaFuncSetAttribute(wg_dense32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kDense32Smem);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  wg_dense32_kernel<<<(unsigned)((M + wg::kRows32 - 1) / wg::kRows32), wg::kThreads32, kDense32Smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
