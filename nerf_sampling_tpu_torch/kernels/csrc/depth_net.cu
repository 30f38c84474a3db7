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
// What bounds it on the H100: about 7 MFLOP per ray on the tensor cores
// (1.1 TFLOP per 400x400 frame) against 6.7 MB of bf16 weights, which do
// not fit a block's shared memory but stay resident in the 50 MB L2. Every
// block of 32 rays streams all weights from L2 once, so L2 bandwidth and
// the latency of the fragment loads bound this simple design, not HBM. In
// fp32 the frame is 1.07 TFLOP: 15.9 ms on the FMA units (67 TFLOP/s), 6.5
// ms as 3xTF32 on the tensor cores (three tf32 products at 494.7 TFLOP/s),
// from 28.8 MB of hi and lo weight slices per 64-row tile.
//
// Design in bf16 (mlp_tile.cuh's wmma core): one block per 32-row tile of
// rays (the ragged last tile is masked, nothing is padded in device
// memory); all activations of the tile
// stay in shared memory as bf16 (four [32, 256] buffers: the three tower
// outputs and a ping-pong partner), fp32 accumulation, the bias added in
// fp32 and the activation rounded to bf16 after every layer, as in the TPU
// kernel. A concatenation becomes a second operand of the same fp32 sum.
// NaN from a ray that misses the sphere propagates to its depth.
//
// fp32 mode (the COMPARE mode's depth, JAX dtype=float32): A, B, the
// weights and every activation in fp32, no rounding, on the fp32 path of
// the wgmma core (mlp_wgmma.cuh's depth_forward32): the products as 3xTF32
// on the tensor cores, the sums and activations fp32. 160 threads, one
// consumer warpgroup on 64-row tiles and a producer warp streaming the
// DepthNet's weight slices (fused_depth_net.depth_slices) into a 6-stage
// ring; the activations stay with the thread that computed them, and trunk
// layer 0 is summed tower by tower into a partial (226 KB of shared memory,
// one block per SM). A and B come in the thread-fragment order
// (fused_depth_net.fragment_tiles). A block walks tiles_per_block tiles (19
// at 160,064 rays on 132 SMs: one wave). The NaN rules are the same
// explicit comparisons; a NaN row of A or B stays in its own rows of every
// product.

#include <cuda_runtime.h>

#include "mlp_tile.cuh"
#include "mlp_wgmma.cuh"

namespace nst {
namespace {

constexpr int kH = 256;     // hidden width the kernel is built for
constexpr int kEmb = 128;   // width of the A and B buffers
constexpr int kRows = 32;   // rays per block
constexpr int kLdh = kH + 8;    // padded strides: fewer shared-memory bank conflicts
constexpr int kLde = kEmb + 8;
constexpr int kMaxLayers = 16;

template <typename T>
struct DepthNetParams {
  const T* a;  // fp32: in fragment order, [tiles, 16, 128] float4
  const T* b;
  float* out;
  long long n;
  int tiles_per_block;             // fp32: 64-row tiles a block walks
  const bf16* slices;              // fp32: the weight slices (wgmma_slices32's; the type is nominal)
  int n_slices;
  int n_layers;  // per tower
  int n_cat;     // trunk layers
  float near_, far_;
  const T* te[3][kMaxLayers];      // [128, H]: embedding part (layer 0: folded W[:e]+W[e:])
  const T* th[3][kMaxLayers];      // [H, H]: hidden part of layers >= 1
  const float* tb[3][kMaxLayers];  // [H]
  const T* cat0[5];                // o, d, i: [H, H]; A, B: [128, H]
  const T* cw[kMaxLayers];         // trunk layers >= 1: [H, H]
  const float* cb[kMaxLayers];     // [H]
  const T* head_w;                 // [H]
  const float* head_b;             // [1]
};

template <typename T>
constexpr int kBlockThreads = std::is_same_v<T, float> ? wg::kThreads32 : kThreads;

template <typename T>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same_v<T, float>) return 1024 + wg::DepthTiles32<wg::kStages32>::kBytes;
  else return (2 * kRows * kLde + 4 * kRows * kLdh) * sizeof(T) + kWarps * kScratchPerWarp * sizeof(float);
}

// The fp32 kernel on the core: the producer streams the slices once per tile
// of the block's, the consumer warpgroup runs depth_forward32 tile by tile.
__device__ __forceinline__ void depth_net_core32(const DepthNetParams<float>& p, unsigned char* smem) {
  const auto t = wg::carve_depth32<wg::kStages32>(smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023));
  const long long tiles = (p.n + wg::kRows32 - 1) / wg::kRows32, tile0 = (long long)blockIdx.x * p.tiles_per_block;
  const int n_tiles = (int)min((long long)p.tiles_per_block, tiles - tile0);
  if (threadIdx.x == 0) t.ring.init(wg::kConsumers32 / 32);
  __syncthreads();
  if (threadIdx.x >= wg::kConsumers32) {
    const wg::Segment seg = {p.slices, p.n_slices, n_tiles};
    wg::produce(t.ring, &seg, 1, wg::kConsumers32);
    return;
  }
  constexpr int kTileVecs = wg::kEmbGroups32 * wg::kConsumers32;  // float4s of one tile's A (or B)
  const float4* a = reinterpret_cast<const float4*>(p.a);
  const float4* b = reinterpret_cast<const float4*>(p.b);
  wg::Cursor cur;
  for (int k = 0; k < n_tiles; ++k) {
    const long long tile = tile0 + k, row0 = tile * wg::kRows32;
    wg::depth_forward32(p, t, cur, a + tile * kTileVecs, b + tile * kTileVecs,
                        (int)min((long long)wg::kRows32, p.n - row0), p.out + row0);
  }
}

// The bf16 kernel: mlp_tile.cuh's wmma layers over one 32-row tile.
__device__ __forceinline__ void depth_net_wmma(const DepthNetParams<bf16>& p, unsigned char* smem) {
  bf16* ea = reinterpret_cast<bf16*>(smem);
  bf16* eb = ea + kRows * kLde;
  bf16* hb = eb + kRows * kLde;
  float* scratch = reinterpret_cast<float*>(hb + 4 * kRows * kLdh);
  bf16* buf[4] = {hb, hb + kRows * kLdh, hb + 2 * kRows * kLdh, hb + 3 * kRows * kLdh};

  const long long row0 = (long long)blockIdx.x * kRows;
  // A and B tiles, 16 bytes per thread and step; rows past n are zero
  constexpr int kVecPerRow = kEmb * sizeof(bf16) / sizeof(uint4);
  for (int v = threadIdx.x; v < 2 * kRows * kVecPerRow; v += kThreads) {
    const int which = v / (kRows * kVecPerRow);
    const int rem = v % (kRows * kVecPerRow);
    const int r = rem / kVecPerRow, c = rem % kVecPerRow;
    const bf16* src = which ? p.b : p.a;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.n) val = reinterpret_cast<const uint4*>(src + (row0 + r) * kEmb)[c];
    reinterpret_cast<uint4*>((which ? eb : ea) + r * kLde)[c] = val;
  }
  __syncthreads();

  // towers: layer l writes buf[t] or buf[3] so that the last layer lands in buf[t]
  const bf16* emb[3] = {ea, ea, eb};
  const int L = p.n_layers;
  for (int t = 0; t < 3; ++t) {
    for (int l = 0; l < L; ++l) {
      const bool odd = (L - 1 - l) & 1;
      Operand ops[2];
      ops[0] = {emb[t], kLde, p.te[t][l], kEmb};
      ops[1] = {odd ? buf[t] : buf[3], kLdh, p.th[t][l], kH};
      dense<kRows / 16, kH / (16 * kWarps)>(ops, l > 0 ? 2 : 1, p.tb[t][l], odd ? buf[3] : buf[t],
                                            kLdh, kNone, scratch);
      __syncthreads();
    }
  }

  // trunk
  const Operand ops0[5] = {{buf[0], kLdh, p.cat0[0], kH},
                           {buf[1], kLdh, p.cat0[1], kH},
                           {buf[2], kLdh, p.cat0[2], kH},
                           {ea, kLde, p.cat0[3], kEmb},
                           {eb, kLde, p.cat0[4], kEmb}};
  dense<kRows / 16, kH / (16 * kWarps)>(ops0, 5, p.cb[0], buf[3], kLdh, kLeaky, scratch);
  __syncthreads();
  int cur = 3, other = 0;
  for (int l = 1; l < p.n_cat; ++l) {
    const Operand op = {buf[cur], kLdh, p.cw[l], kH};
    dense<kRows / 16, kH / (16 * kWarps)>(&op, 1, p.cb[l], buf[other], kLdh, kLeaky, scratch);
    __syncthreads();
    const int tmp = cur;
    cur = other;
    other = tmp;
  }

  // head: 8 threads per row, each a 32-wide partial dot, reduced by shuffles
  const int r = threadIdx.x >> 3, part = threadIdx.x & 7;
  const bf16* h = buf[cur] + r * kLdh;
  float s = 0.f;
  for (int c = part * (kH / 8); c < (part + 1) * (kH / 8); ++c) s += to_f(h[c]) * to_f(p.head_w[c]);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (part == 0 && row0 + r < p.n) {
    const float sg = 1.f / (1.f + expf(-(s + p.head_b[0])));
    p.out[row0 + r] = p.near_ * (1.f - sg) + p.far_ * sg;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads<T>) depth_net_kernel(const __grid_constant__ DepthNetParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (std::is_same_v<T, float>) depth_net_core32(p, smem);
  else depth_net_wmma(p, smem);
}

// ptrs, in order: A, B, out; per tower (origin, direction, intersection):
// te[0..L-1], th[1..L-1], tb[0..L-1]; cat0 o, d, i, A, B; cw[1..C-1];
// cb[0..C-1]; head_w; head_b; for fp32 then the weight slices (refused
// without them).
template <typename T>
int launch(const void* const* ptrs, int n_ptrs, long long n, int n_layers, int n_cat, float near_,
           float far_, int tiles_per_block, void* stream) {
  constexpr bool core = std::is_same_v<T, float>;
  if (n_layers < 1 || n_layers > kMaxLayers || n_cat < 1 || n_cat > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  const int n_weights = 3 * (3 * n_layers - 1) + 5 + (n_cat - 1) + n_cat + 2;
  if (n_ptrs != 3 + n_weights + (core ? 1 : 0)) return (int)cudaErrorInvalidValue;
  DepthNetParams<T> p = {};
  int k = 0;
  p.a = static_cast<const T*>(ptrs[k++]);
  p.b = static_cast<const T*>(ptrs[k++]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[k++]));
  p.n = n;
  p.n_layers = n_layers;
  p.n_cat = n_cat;
  p.near_ = near_;
  p.far_ = far_;
  for (int t = 0; t < 3; ++t) {
    for (int l = 0; l < n_layers; ++l) p.te[t][l] = static_cast<const T*>(ptrs[k++]);
    for (int l = 1; l < n_layers; ++l) p.th[t][l] = static_cast<const T*>(ptrs[k++]);
    for (int l = 0; l < n_layers; ++l) p.tb[t][l] = static_cast<const float*>(ptrs[k++]);
  }
  for (int i = 0; i < 5; ++i) p.cat0[i] = static_cast<const T*>(ptrs[k++]);
  for (int l = 1; l < n_cat; ++l) p.cw[l] = static_cast<const T*>(ptrs[k++]);
  for (int l = 0; l < n_cat; ++l) p.cb[l] = static_cast<const float*>(ptrs[k++]);
  p.head_w = static_cast<const T*>(ptrs[k++]);
  p.head_b = static_cast<const float*>(ptrs[k++]);
  unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  if constexpr (core) {
    p.slices = static_cast<const bf16*>(ptrs[k++]);
    if (!p.slices || tiles_per_block < 1) return (int)cudaErrorInvalidValue;
    p.n_slices = wg::depth_slices32(n_layers, n_cat);
    p.tiles_per_block = tiles_per_block;
    const long long tiles = (n + wg::kRows32 - 1) / wg::kRows32;
    grid = (unsigned)((tiles + tiles_per_block - 1) / tiles_per_block);
  }

  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(depth_net_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  depth_net_kernel<T><<<grid, kBlockThreads<T>, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace nst

// fp32: A and B in fragment order (fused_depth_net.fragment_tiles), the
// weights of pack_depth_net(model, torch.float32) and their slices;
// tiles_per_block: the 64-row tiles a block walks
// (fused_depth_net.tiles_per_block; the bf16 kernel takes one 32-row tile a
// block and reads none). Returns a cudaError_t (0 on success).
extern "C" int nst_depth_net_forward(const void* const* ptrs, int n_ptrs, long long n, int n_layers,
                                     int n_cat, float near_, float far_, int fp32, int tiles_per_block,
                                     void* stream) {
  return fp32 ? nst::launch<float>(ptrs, n_ptrs, n, n_layers, n_cat, near_, far_, tiles_per_block, stream)
              : nst::launch<nst::bf16>(ptrs, n_ptrs, n, n_layers, n_cat, near_, far_, 0, stream);
}

// The fp32 kernel's launch shape (K1 in COMPARE): out[0] resident blocks per
// SM, out[1] threads per block, out[2] dynamic shared memory. Returns a
// cudaError_t.
extern "C" int nst_depth_net_occupancy(int* out) {
  using namespace nst;
  constexpr size_t smem = smem_bytes<float>();
  cudaError_t err = cudaFuncSetAttribute(depth_net_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  out[1] = kBlockThreads<float>;
  out[2] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, depth_net_kernel<float>, out[1], smem);
}
