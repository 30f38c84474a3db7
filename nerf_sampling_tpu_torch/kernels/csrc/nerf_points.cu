// K4: the NeRF MLP over point queries, points + view dirs -> raw (rgb, sigma).
//
// Replaces nerf_sampling_tpu/kernels/fused_nerf.py::_fused_call (the
// pl.pallas_call at :301; fused_nerf_apply, and the forward of
// fused_nerf_vjp.py::_packed_apply, :297-300): per row, the fp32 positional
// encoding of the point and of its unit view direction (accurate sinf/cosf:
// the argument reaches 2^9*|x|), rounded to bf16 into one PE row [pts emb
// 63 | 0 | view emb 27 | 0]; the viewdirs NeRF MLP (bf16 operands and
// activations, fp32 accumulation); the raw logits written out, no sigmoid
// (fused_nerf.py:281-285). The TPU kernel's frequency-selector matmul and
// cos-as-shifted-sin are Mosaic devices and are not ported: the embedding
// takes one accurate sincosf per (row, frequency, axis), and the view
// embedding one per (ray, frequency, axis) in each tile the ray touches.
//
// Input: pts [M, 3] and dirs [M / S, 3], row r's direction dirs[r / S]
// (S = 1: one direction per row; S = samples per ray: the train step's
// per-ray directions, never expanded). Output: raw [M, 4] row-major (r, g,
// b logits, sigma), the layout K5 takes its cotangent in.
//
// What bounds it on the H100: about 1.19 MFLOP per row on the tensor cores
// (0.236 ms for the fine query's 196,608 rows at 989 TFLOP/s), against
// 1.2 MB of bf16 weight slices streamed from L2 per 128-row tile; 40 bytes
// of device memory per row. Design: the wgmma core (mlp_wgmma.cuh), as K2
// runs it: 288 threads, a producer warp streaming the NeRF's full-forward
// slices (fused_render.pack_slices, made once per step by the caller and
// shared with K5's recompute) into a 5-stage ring, two consumer warpgroups
// on 128-row tiles filling their PE tile from the points (wg::point_fill,
// the view embeddings staged in two buffers a tile in turn) and running
// nerf_forward with raw logits. One block per SM walks
// tiles_per_block consecutive tiles (the caller sizes it from M and the SM
// count: 4 tiles for the coarse query's 512, 12 for the fine query's 1536,
// 128 blocks on 132 SMs), so the small query fills the card as the large
// one does.

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"

namespace nst {
namespace {

constexpr int kStages = wg::kRenderStages;

struct PointParams {
  const float* pts;   // [M, 3]
  const float* dirs;  // [M / S, 3]
  float* out;         // [M, 4]
  long long M, S;
  int tiles_per_block;
  NerfWeights w;
  const bf16* slices;  // the full forward's slices (mlp_wgmma.cuh: forward_slices)
  int n_slices;
};

constexpr int kViewBytes = wg::kRows * 32 * sizeof(bf16);  // a tile's staged view embeddings
constexpr size_t kSmemBytes = 1024 + wg::Tiles<kStages>::kBytes + 2 * kViewBytes;

__global__ void __launch_bounds__(wg::kThreads, 1) nerf_points_kernel(const __grid_constant__ PointParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  const wg::Tiles<kStages> t = wg::carve<kStages>(base);
  bf16* view = reinterpret_cast<bf16*>(base + wg::Tiles<kStages>::kBytes);  // two [128 rays, 32] stagings
  const long long tiles = (p.M + wg::kRows - 1) / wg::kRows, tile0 = (long long)blockIdx.x * p.tiles_per_block;
  const int n_tiles = (int)min((long long)p.tiles_per_block, tiles - tile0);
  if (threadIdx.x == 0) t.ring.init();
  __syncthreads();
  if (threadIdx.x >= wg::kConsumers) {  // the producer warp: the forward's slices, once per tile
    const wg::Segment seg = {p.slices, p.n_slices, n_tiles};
    wg::produce(t.ring, &seg, 1);
    return;
  }
  wg::Cursor cur;
  for (int k = 0; k < n_tiles; ++k) {
    const long long row0 = (tile0 + k) * wg::kRows;
    const int valid = (int)min((long long)wg::kRows, p.M - row0);
    wg::point_fill(p.pts, p.dirs, row0, valid, p.S, view + (k & 1) * (kViewBytes / 2), nullptr, t.pe);
    float* out = p.out + row0 * 4;
    float* rgb[3] = {out, out + 1, out + 2};
    wg::nerf_forward(p.w, t, cur, valid, false, out + 3, rgb, true, 4);
  }
}

}  // namespace
}  // namespace nst

// ptrs, in order: pts, dirs, out, then the NeRF's full-forward weight
// slices, then its epilogue vectors (nerf_mlp.cuh::read_weights, all
// heads); a launch without the slices is refused. tiles_per_block: 128-row
// tiles a block walks (fused_nerf.tiles_per_block). Returns a cudaError_t.
extern "C" int nst_nerf_points(const void* const* ptrs, int n_ptrs, long long M, long long S, int D,
                               unsigned skip_mask, int tiles_per_block, void* stream) {
  using namespace nst;
  if (S < 1 || M % S != 0 || tiles_per_block < 1) return (int)cudaErrorInvalidValue;
  PointParams p = {};
  p.pts = static_cast<const float*>(ptrs[0]);
  p.dirs = static_cast<const float*>(ptrs[1]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[2]));
  p.slices = static_cast<const bf16*>(ptrs[3]);
  const int k = read_weights(ptrs + 4, D, skip_mask, false, &p.w);
  if (k < 0 || n_ptrs != 4 + k || !p.slices) return (int)cudaErrorInvalidValue;
  p.n_slices = wg::forward_slices(D, skip_mask, false);
  p.M = M;
  p.S = S;
  p.tiles_per_block = tiles_per_block;
  cudaError_t err = cudaFuncSetAttribute(nerf_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  const long long tiles = (M + wg::kRows - 1) / wg::kRows;
  const unsigned grid = (unsigned)((tiles + tiles_per_block - 1) / tiles_per_block);
  nerf_points_kernel<<<grid, wg::kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K4's launch shape: out[0] resident blocks per SM, out[1] threads per
// block, out[2] dynamic shared memory. Returns a cudaError_t.
extern "C" int nst_nerf_points_occupancy(int* out) {
  using namespace nst;
  cudaError_t err = cudaFuncSetAttribute(nerf_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  out[1] = wg::kThreads;
  out[2] = (int)kSmemBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, nerf_points_kernel, out[1], kSmemBytes);
}
