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
// the latency of the fragment loads bound this simple design, not HBM.
//
// Design: one block per 32-row tile of rays (the ragged last tile is
// masked, nothing is padded in device memory); all activations of the tile
// stay in shared memory as bf16 (four [32, 256] buffers: the three tower
// outputs and a ping-pong partner), fp32 accumulation, the bias added in
// fp32 and the activation rounded to bf16 after every layer, as in the TPU
// kernel. A concatenation becomes a second operand of the same fp32 sum.
// NaN from a ray that misses the sphere propagates to its depth.
//
// fp32 mode (the COMPARE mode's depth, JAX dtype=float32): A, B, the
// weights and every activation in fp32, no rounding, the products on the
// FMA units (mlp_tile.cuh's fp32 dense); the tiles take 166 KB, one block
// per SM. The NaN rules are the same explicit comparisons.

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

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
  const T* a;
  const T* b;
  float* out;
  long long n;
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
constexpr size_t smem_bytes() {
  return (2 * kRows * kLde + 4 * kRows * kLdh) * sizeof(T) +
         (sizeof(T) == sizeof(bf16) ? kWarps * kScratchPerWarp * sizeof(float) : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) depth_net_kernel(const DepthNetParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ea = reinterpret_cast<T*>(smem);
  T* eb = ea + kRows * kLde;
  T* hb = eb + kRows * kLde;
  float* scratch = reinterpret_cast<float*>(hb + 4 * kRows * kLdh);  // bf16 only
  T* buf[4] = {hb, hb + kRows * kLdh, hb + 2 * kRows * kLdh, hb + 3 * kRows * kLdh};

  const long long row0 = (long long)blockIdx.x * kRows;
  // A and B tiles, 16 bytes per thread and step; rows past n are zero
  constexpr int kVecPerRow = kEmb * sizeof(T) / sizeof(uint4);
  for (int v = threadIdx.x; v < 2 * kRows * kVecPerRow; v += kThreads) {
    const int which = v / (kRows * kVecPerRow);
    const int rem = v % (kRows * kVecPerRow);
    const int r = rem / kVecPerRow, c = rem % kVecPerRow;
    const T* src = which ? p.b : p.a;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.n) val = reinterpret_cast<const uint4*>(src + (row0 + r) * kEmb)[c];
    reinterpret_cast<uint4*>((which ? eb : ea) + r * kLde)[c] = val;
  }
  __syncthreads();

  // towers: layer l writes buf[t] or buf[3] so that the last layer lands in buf[t]
  const T* emb[3] = {ea, ea, eb};
  const int L = p.n_layers;
  for (int t = 0; t < 3; ++t) {
    for (int l = 0; l < L; ++l) {
      const bool odd = (L - 1 - l) & 1;
      OperandT<T> ops[2];
      ops[0] = {emb[t], kLde, p.te[t][l], kEmb};
      ops[1] = {odd ? buf[t] : buf[3], kLdh, p.th[t][l], kH};
      dense<kRows / 16, kH / (16 * kWarps)>(ops, l > 0 ? 2 : 1, p.tb[t][l], odd ? buf[3] : buf[t],
                                            kLdh, kNone, scratch);
      __syncthreads();
    }
  }

  // trunk
  const OperandT<T> ops0[5] = {{buf[0], kLdh, p.cat0[0], kH},
                               {buf[1], kLdh, p.cat0[1], kH},
                               {buf[2], kLdh, p.cat0[2], kH},
                               {ea, kLde, p.cat0[3], kEmb},
                               {eb, kLde, p.cat0[4], kEmb}};
  dense<kRows / 16, kH / (16 * kWarps)>(ops0, 5, p.cb[0], buf[3], kLdh, kLeaky, scratch);
  __syncthreads();
  int cur = 3, other = 0;
  for (int l = 1; l < p.n_cat; ++l) {
    const OperandT<T> op = {buf[cur], kLdh, p.cw[l], kH};
    dense<kRows / 16, kH / (16 * kWarps)>(&op, 1, p.cb[l], buf[other], kLdh, kLeaky, scratch);
    __syncthreads();
    const int tmp = cur;
    cur = other;
    other = tmp;
  }

  // head: 8 threads per row, each a 32-wide partial dot, reduced by shuffles
  const int r = threadIdx.x >> 3, part = threadIdx.x & 7;
  const T* h = buf[cur] + r * kLdh;
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

// ptrs, in order: A, B, out; per tower (origin, direction, intersection):
// te[0..L-1], th[1..L-1], tb[0..L-1]; cat0 o, d, i, A, B; cw[1..C-1];
// cb[0..C-1]; head_w; head_b.
template <typename T>
int launch(const void* const* ptrs, int n_ptrs, long long n, int n_layers, int n_cat, float near_,
           float far_, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_cat < 1 || n_cat > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  if (n_ptrs != 3 + 3 * (3 * n_layers - 1) + 5 + (n_cat - 1) + n_cat + 2)
    return (int)cudaErrorInvalidValue;
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

  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(depth_net_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  depth_net_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace nst

// fp32: A, B and the weights of pack_depth_net(model, torch.float32).
// Returns a cudaError_t (0 on success).
extern "C" int nst_depth_net_forward(const void* const* ptrs, int n_ptrs, long long n, int n_layers,
                                     int n_cat, float near_, float far_, int fp32, void* stream) {
  return fp32 ? nst::launch<float>(ptrs, n_ptrs, n, n_layers, n_cat, near_, far_, stream)
              : nst::launch<nst::bf16>(ptrs, n_ptrs, n, n_layers, n_cat, near_, far_, stream);
}
