// K4: the NeRF MLP over point queries, points + view dirs -> raw (rgb, sigma).
//
// Replaces nerf_sampling_tpu/kernels/fused_nerf.py::_fused_call (the
// pl.pallas_call at :301; fused_nerf_apply, and the forward of
// fused_nerf_vjp.py::_packed_apply, :297-300): per row, the fp32 positional
// encoding of the point and of its unit view direction (accurate sinf/cosf:
// the argument reaches 2^9*|x|), rounded to bf16 into one PE row [pts emb
// 63 | 0 | view emb 27 | 0 x5]; the viewdirs NeRF MLP (nerf_mlp.cuh:
// bf16 operands and activations, fp32 accumulation); the raw logits
// written out, no sigmoid (fused_nerf.py:281-285). The TPU kernel's
// frequency-selector matmul and cos-as-shifted-sin are Mosaic devices and
// are not ported: the embedding is computed column by column.
//
// Input: pts [M, 3] and dirs [M / S, 3], row r's direction dirs[r / S]
// (S = 1: one direction per row; S = samples per ray: the train step's
// per-ray directions, never expanded). Output: raw [M, 4] row-major (r, g,
// b logits, sigma), the layout K5 takes its cotangent in.
//
// What bounds it on the H100: about 1.19 MFLOP per row on the tensor
// cores against 1.2 MB of bf16 weights streamed from L2 per 64-row chunk;
// 40 bytes of device memory per row. Design: one block per 64-row chunk,
// two blocks per SM (K2's tiles), the weights read through wmma fragments.

#include <cuda_runtime.h>

#include "nerf_mlp.cuh"

namespace nst {
namespace {

struct PointParams {
  const float* pts;   // [M, 3]
  const float* dirs;  // [M / S, 3]
  float* out;         // [M, 4]
  long long M, S;
  NerfWeights w;
};

constexpr size_t kSmemBytes = kTileBytes + kChunk * 8 * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2) nerf_points_kernel(const __grid_constant__ PointParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t = carve_tiles(smem);
  float* q = reinterpret_cast<float*>(smem + kTileBytes);
  const long long row0 = (long long)blockIdx.x * kChunk;
  const int valid = (int)min((long long)kChunk, p.M - row0);
  point_pe(p.pts, p.dirs, row0, valid, p.S, t, q);
  float* out = p.out + row0 * 4;
  float* rgb[3] = {out, out + 1, out + 2};
  mlp_chunk(p.w, t, valid, false, true, out + 3, rgb, 4);
}

}  // namespace
}  // namespace nst

// ptrs, in order: pts, dirs, out, then the NeRF's weights
// (nerf_mlp.cuh::read_weights, all heads). Returns a cudaError_t.
extern "C" int nst_nerf_points(const void* const* ptrs, int n_ptrs, long long M, long long S, int D,
                               unsigned skip_mask, void* stream) {
  using namespace nst;
  if (S < 1 || M % S != 0) return (int)cudaErrorInvalidValue;
  PointParams p = {};
  p.pts = static_cast<const float*>(ptrs[0]);
  p.dirs = static_cast<const float*>(ptrs[1]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[2]));
  const int k = read_weights(ptrs + 3, D, skip_mask, false, &p.w);
  if (k < 0 || n_ptrs != 3 + k) return (int)cudaErrorInvalidValue;
  p.M = M;
  p.S = S;
  cudaError_t err = cudaFuncSetAttribute(nerf_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  const unsigned grid = (unsigned)((M + kChunk - 1) / kChunk);
  nerf_points_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
