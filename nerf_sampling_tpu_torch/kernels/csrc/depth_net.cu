// K1: DepthNet forward, embedded ray features -> depth.
//
// Replaces nerf_sampling_tpu/kernels/fused_depth_net.py::_fused_call (the
// pl.pallas_call at :181, body :118-168). It computes what that kernel
// computes: three skip towers with NO activation (origin and direction read
// buffer A, the sphere intersections buffer B), a LeakyReLU(0.01) trunk
// over [o_out, d_out, i_out, o_emb, d_emb, i_emb], and a sigmoid head
// scaled to [near, far]. Buffers A and B ([N, 128] bf16) are built outside
// the kernel, by the Python wrapper, from the positional encoding and the
// ray-sphere intersection, as the JAX wrapper does (:207-227).
//
// What bounds it on the H100: 3.33M multiply-adds per ray on the tensor
// cores (1.07 TFLOP per 160,064-ray frame: 1.08 ms at 989 TFLOP/s in bf16,
// 6.5 ms as 3xTF32 in fp32, three tf32 products at 494.7 TFLOP/s) against
// 6.7 MB of bf16 weights (13.4 MB fp32), which do not fit a block's shared
// memory but stay resident in the 50 MB L2: every tile streams them from
// L2, so the weight bytes a tile's rows share bound it beside the tensor
// cores.
//
// Design (both types on the wgmma core, mlp_wgmma.cuh): 160 threads, one
// consumer warpgroup on 64-row tiles and a producer warp streaming the
// DepthNet's weight slices (fused_depth_net.depth_slices: bf16 slices, or
// fp32 hi and lo slices) into a 6-stage ring, one block per SM walking
// tiles_per_block tiles (19 at 160,064 rays on 132 SMs: one wave); the
// ragged last tile is masked, nothing is padded in device memory. Trunk
// layer 0 reads three 256-wide tower outputs and both embeddings, 256 KB at
// 128 bf16 rows, so no two-warpgroup 128-row tile fits: each tower's share
// of it is summed onto a 64 KB fp32 partial as the tower ends, and the
// tile's activations, partial, embeddings and ring fit in 230,496 bytes.
// - bf16 (depth_forward): the products on the bf16 tensor cores from
//   swizzled tiles in shared memory (A and B copied in per tile), the bias
//   added in fp32 and every layer rounded to bf16, as in the TPU kernel;
//   440 slices (7.2 MB) a tile of the committed 10x256 net, 18 GB of L2
//   reads a frame. ptxas (sm_90a, CUDA 12.8): 255 registers, 1,648 bytes
//   of spill stores and 1,664 of loads.
// - fp32 (depth_forward32, the COMPARE mode's depth, JAX dtype=float32):
//   A, B, the weights and every activation in fp32, no rounding; the
//   products as 3xTF32, the activations kept with the thread that computed
//   them, A and B read from device memory in the thread-fragment order
//   (fused_depth_net.fragment_tiles); 1,760 slices (28.8 MB) a tile; 255
//   registers, 1,312 / 1,304 bytes of spill stores and loads.
// The NaN rules are explicit comparisons; a NaN row of A or B stays in its
// own rows of every product, so a ray that misses the sphere comes out NaN.

#include <cuda_runtime.h>

#include "mlp_wgmma.cuh"

namespace nst {
namespace {

constexpr int kMaxLayers = 16;

template <typename T>
struct DepthNetParams {
  const T* a;  // bf16: [n, 128]; fp32: in fragment order, [tiles, 16, 128] float4
  const T* b;
  float* out;
  long long n;
  int tiles_per_block;             // 64-row tiles a block walks
  const bf16* slices;              // the weight slices (fp32: wgmma_slices32's; the type is nominal)
  int n_slices;
  int n_layers;  // per tower
  int n_cat;     // trunk layers
  float near_, far_;
  const float* tb[3][kMaxLayers];  // [H]
  const float* cb[kMaxLayers];     // [H]
  const T* head_w;                 // [H]
  const float* head_b;             // [1]
};

template <typename T>
using DepthTiles = std::conditional_t<std::is_same_v<T, float>, wg::DepthTiles32<wg::kStages32>,
                                      wg::DepthTiles<wg::kStages32>>;
template <typename T>
constexpr size_t kSmemBytes = 1024 + DepthTiles<T>::kBytes;  // + the 1024-byte alignment

template <typename T>
__global__ void __launch_bounds__(wg::kThreads32, 1) depth_net_kernel(const __grid_constant__ DepthNetParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool fp32 = std::is_same_v<T, float>;
  unsigned char* base = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  DepthTiles<T> t;
  if constexpr (fp32) t = wg::carve_depth32<wg::kStages32>(base);
  else t = wg::carve_depth<wg::kStages32>(base);
  const long long tiles = (p.n + wg::kRows32 - 1) / wg::kRows32, tile0 = (long long)blockIdx.x * p.tiles_per_block;
  const int n_tiles = (int)min((long long)p.tiles_per_block, tiles - tile0);
  if (threadIdx.x == 0) t.ring.init(wg::kConsumers32 / 32);
  __syncthreads();
  if (threadIdx.x >= wg::kConsumers32) {  // the producer: the slices once per tile of the block's
    const wg::Segment seg = {p.slices, p.n_slices, n_tiles};
    wg::produce(t.ring, &seg, 1, wg::kConsumers32);
    return;
  }
  wg::Cursor cur;
  for (int k = 0; k < n_tiles; ++k) {
    const long long tile = tile0 + k, row0 = tile * wg::kRows32;
    const int valid = (int)min((long long)wg::kRows32, p.n - row0);
    if constexpr (fp32) {
      constexpr int kTileVecs = wg::kEmbGroups32 * wg::kConsumers32;  // float4s of one tile's A (or B)
      const float4* a = reinterpret_cast<const float4*>(p.a) + tile * kTileVecs;
      const float4* b = reinterpret_cast<const float4*>(p.b) + tile * kTileVecs;
      wg::depth_forward32(p, t, cur, a, b, valid, p.out + row0);
    } else {
      wg::depth_forward(p, t, cur, p.a + row0 * wg::kEmb, p.b + row0 * wg::kEmb, valid, p.out + row0);
    }
  }
}

// ptrs, in order: A, B, out; the weight slices (refused without them);
// the epilogue vectors: per tower (origin, direction, intersection)
// tb[0..L-1]; cb[0..C-1]; head_w; head_b.
template <typename T>
int launch(const void* const* ptrs, int n_ptrs, long long n, int n_layers, int n_cat, float near_,
           float far_, int tiles_per_block, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_cat < 1 || n_cat > kMaxLayers || tiles_per_block < 1)
    return (int)cudaErrorInvalidValue;
  if (n_ptrs != 4 + 3 * n_layers + n_cat + 2) return (int)cudaErrorInvalidValue;
  DepthNetParams<T> p = {};
  int k = 0;
  p.a = static_cast<const T*>(ptrs[k++]);
  p.b = static_cast<const T*>(ptrs[k++]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[k++]));
  p.slices = static_cast<const bf16*>(ptrs[k++]);
  if (!p.slices) return (int)cudaErrorInvalidValue;
  p.n = n;
  p.n_layers = n_layers;
  p.n_cat = n_cat;
  p.near_ = near_;
  p.far_ = far_;
  for (int t = 0; t < 3; ++t)
    for (int l = 0; l < n_layers; ++l) p.tb[t][l] = static_cast<const float*>(ptrs[k++]);
  for (int l = 0; l < n_cat; ++l) p.cb[l] = static_cast<const float*>(ptrs[k++]);
  p.head_w = static_cast<const T*>(ptrs[k++]);
  p.head_b = static_cast<const float*>(ptrs[k++]);
  p.n_slices = std::is_same_v<T, float> ? wg::depth_slices32(n_layers, n_cat) : wg::depth_slices16(n_layers, n_cat);
  p.tiles_per_block = tiles_per_block;
  const long long tiles = (n + wg::kRows32 - 1) / wg::kRows32;
  const unsigned grid = (unsigned)((tiles + tiles_per_block - 1) / tiles_per_block);

  constexpr size_t smem = kSmemBytes<T>;
  cudaError_t err = cudaFuncSetAttribute(depth_net_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  depth_net_kernel<T><<<grid, wg::kThreads32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
  constexpr size_t smem = kSmemBytes<T>;
  cudaError_t err = cudaFuncSetAttribute(depth_net_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  out[1] = wg::kThreads32;
  out[2] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, depth_net_kernel<T>, out[1], smem);
}

}  // namespace
}  // namespace nst

// bf16: A and B [n, 128], the slices and vectors of pack_depth_net(model);
// fp32: A and B in fragment order (fused_depth_net.fragment_tiles), the
// slices and vectors of pack_depth_net(model, torch.float32).
// tiles_per_block: the 64-row tiles a block walks
// (fused_depth_net.tiles_per_block). Returns a cudaError_t (0 on success).
extern "C" int nst_depth_net_forward(const void* const* ptrs, int n_ptrs, long long n, int n_layers,
                                     int n_cat, float near_, float far_, int fp32, int tiles_per_block,
                                     void* stream) {
  return fp32 ? nst::launch<float>(ptrs, n_ptrs, n, n_layers, n_cat, near_, far_, tiles_per_block, stream)
              : nst::launch<nst::bf16>(ptrs, n_ptrs, n, n_layers, n_cat, near_, far_, tiles_per_block, stream);
}

// The launch shape of the bf16 kernel or, with fp32, of the fp32 one:
// out[0] resident blocks per SM, out[1] threads per block, out[2] dynamic
// shared memory. Returns a cudaError_t.
extern "C" int nst_depth_net_occupancy(int fp32, int* out) {
  return fp32 ? nst::occupancy<float>(out) : nst::occupancy<nst::bf16>(out);
}
