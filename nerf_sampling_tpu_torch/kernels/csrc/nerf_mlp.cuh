// The NeRF MLP over a block's sample rows, shared by K2/K3/K8/K9
// (render_around_depth.cu), K6/K7 (render_hier.cu) and K4 (nerf_points.cu).
//
// A block holds, in shared memory, the per-ray data of its R rays (o, d,
// |d|, one spare float each, 8 floats a ray) and a plane of depths z[row]
// whose ray is row / S. nerf_rows walks the rows in chunks of 64: the fp32
// positional encoding of the chunk (accurate sinf/cosf: the argument
// reaches 2^9*|x|, so __sinf is not acceptable) goes to a bf16 tile
// [pts emb 63 | 0 | view emb 27 | 0 x5], the MLP runs layer by layer
// between two bf16 activation tiles (mlp_tile.cuh::dense: wmma bf16, fp32
// accumulation), and sigma and sigmoid(rgb) land in per-row fp32 planes
// (mlp_chunk: one chunk, whatever filled its PE tile; K4 keeps the rgb
// logits). sigma_only runs the trunk and the alpha head alone (JAX
// heads="sigma"). The weights, the PE tile and the activations are all of
// one element type T: bf16 as above, or fp32 for the COMPARE mode's
// kernels (no rounding anywhere; mlp_tile.cuh's fp32 dense). fp32 tiles
// are twice the bytes, so an fp32 kernel runs one block per SM.
//
// sort_rows is the stable per-ray sort of a plane, by rank, that K3 and K6
// run before shading: ties keep index order and NaN goes last, compared
// explicitly (fminf/fmaxf and plain < would drop or misplace NaN).
#pragma once

#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace nst {

constexpr int kW = 256;          // NeRF width the kernels are built for
constexpr int kWv = kW / 2;      // views-layer width
constexpr int kChunk = 64;       // sample rows per MLP pass
constexpr int kLdx = kW + 8;     // padded activation stride
constexpr int kPeCols = 96;      // [pts emb 63 | 0 | view emb 27 | 0 x5]
constexpr int kPeViews = 64;     // first column of the view embedding
constexpr int kLdpe = kPeCols + 8;
constexpr int kPtsCh = 63;       // 3 * (1 + 2 * 10)
constexpr int kViewCh = 27;      // 3 * (1 + 2 * 4)
constexpr int kMaxD = 16;

template <typename T>
struct NerfWeightsT {
  int D;
  unsigned skip_mask;           // bit i: layer i also reads the point embedding
  const T* w0;                  // [64, W] point-embedding rows, zero-padded
  const T* tw[kMaxD];           // layers >= 1: [W, W]
  const float* tb[kMaxD];       // [W]
  const T* skip_w[kMaxD];       // [64, W] for the layers in skip_mask
  const T* feat_w;              // [W, W]
  const float* feat_b;          // [W]
  const T* alpha_w;             // [W]
  const float* alpha_b;         // [1]
  const T* views_wf;            // [W, W/2]
  const T* views_ws;            // [32, W/2] view-embedding rows, zero-padded
  const float* views_b;         // [W/2]
  const T* rgb_w;               // [3, W/2]
  const float* rgb_b;           // [3]
};
using NerfWeights = NerfWeightsT<bf16>;

// Reads a pack_nerf layout from ptrs[k...] (see fused_render._flat_weights):
// w0, tw[1..D-1], tb[0..D-1], skip_w[i] for each set bit of skip_mask,
// then the alpha head alone (sigma_only) or all the heads. Returns the
// number of pointers read, or -1 on a bad D / skip_mask.
template <typename T>
inline int read_weights(const void* const* ptrs, int D, unsigned skip_mask, bool sigma_only,
                        NerfWeightsT<T>* w) {
  if (D < 1 || D > kMaxD || (skip_mask & 1u) || (skip_mask >> D)) return -1;
  *w = NerfWeightsT<T>{};
  w->D = D;
  w->skip_mask = skip_mask;
  int k = 0;
  w->w0 = static_cast<const T*>(ptrs[k++]);
  for (int i = 1; i < D; ++i) w->tw[i] = static_cast<const T*>(ptrs[k++]);
  for (int i = 0; i < D; ++i) w->tb[i] = static_cast<const float*>(ptrs[k++]);
  for (int i = 1; i < D; ++i)
    if ((skip_mask >> i) & 1u) w->skip_w[i] = static_cast<const T*>(ptrs[k++]);
  if (sigma_only) {
    w->alpha_w = static_cast<const T*>(ptrs[k++]);
    w->alpha_b = static_cast<const float*>(ptrs[k++]);
    return k;
  }
  w->feat_w = static_cast<const T*>(ptrs[k++]);
  w->feat_b = static_cast<const float*>(ptrs[k++]);
  w->alpha_w = static_cast<const T*>(ptrs[k++]);
  w->alpha_b = static_cast<const float*>(ptrs[k++]);
  w->views_wf = static_cast<const T*>(ptrs[k++]);
  w->views_ws = static_cast<const T*>(ptrs[k++]);
  w->views_b = static_cast<const float*>(ptrs[k++]);
  w->rgb_w = static_cast<const T*>(ptrs[k++]);
  w->rgb_b = static_cast<const float*>(ptrs[k++]);
  return k;
}

// Shared memory of the MLP: two activation tiles, the PE tile and, for
// bf16, the per-warp epilogue scratch of wmma. Every offset is a multiple
// of 32 bytes (wmma).
template <typename T>
__host__ __device__ constexpr size_t tile_bytes() {
  return (2 * kChunk * kLdx + kChunk * kLdpe) * sizeof(T) +
         (sizeof(T) == sizeof(bf16) ? kWarps * kScratchPerWarp * sizeof(float) : 0);
}
constexpr size_t kTileBytes = tile_bytes<bf16>();

template <typename T>
struct TilesT {
  T* x[2];
  T* pe;
  float* scratch;  // bf16 only
};
using Tiles = TilesT<bf16>;

template <typename T = bf16>
__device__ __forceinline__ TilesT<T> carve_tiles(unsigned char* smem) {
  TilesT<T> t;
  t.x[0] = reinterpret_cast<T*>(smem);
  t.x[1] = t.x[0] + kChunk * kLdx;
  t.pe = t.x[1] + kChunk * kLdx;
  t.scratch = sizeof(T) == sizeof(bf16) ? reinterpret_cast<float*>(t.pe + kChunk * kLdpe) : nullptr;
  return t;
}

// Column col of the reference embedding [x, sin(x f0), cos(x f0), ...]
// of a 3-vector x (x = v[0..2]).
__device__ __forceinline__ float embed(const float* v, int col) {
  if (col < 3) return v[col];
  const int c = col - 3, f = c / 6, k = c % 6;
  const float a = v[k % 3] * (float)(1 << f);
  return k < 3 ? sinf(a) : cosf(a);
}

// The MLP over the 64 rows of one chunk whose PE tile t.pe is filled;
// rows [0, valid) are written: sigma[r * stride] and, unless sigma_only,
// rgb[ch][r * stride], the logits when raw_rgb, else sigmoid(logits).
// Every thread of the block calls it; it ends on a barrier.
template <typename T>
__device__ __forceinline__ void mlp_chunk(const NerfWeightsT<T>& w, const TilesT<T>& t, int valid,
                                          bool sigma_only, bool raw_rgb, float* sigma,
                                          float* const* rgb, int stride) {
  const int tid = threadIdx.x;
  const OperandT<T> op0 = {t.pe, kLdpe, w.w0, 64};
  dense<kChunk / 16, kW / (16 * kWarps)>(&op0, 1, w.tb[0], t.x[0], kLdx, kRelu, t.scratch);
  __syncthreads();
  int cur = 0;
  for (int i = 1; i < w.D; ++i) {
    const OperandT<T> ops[2] = {{t.x[cur], kLdx, w.tw[i], kW}, {t.pe, kLdpe, w.skip_w[i], 64}};
    dense<kChunk / 16, kW / (16 * kWarps)>(ops, ((w.skip_mask >> i) & 1u) ? 2 : 1, w.tb[i],
                                           t.x[cur ^ 1], kLdx, kRelu, t.scratch);
    __syncthreads();
    cur ^= 1;
  }

  {  // sigma = h @ alpha_w + alpha_b: four threads per row
    const int rr = tid >> 2, part = tid & 3;
    const T* h = t.x[cur] + rr * kLdx;
    float s = 0.f;
    for (int c = part * (kW / 4); c < (part + 1) * (kW / 4); ++c) s += to_f(h[c]) * to_f(w.alpha_w[c]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0 && rr < valid) sigma[rr * stride] = s + w.alpha_b[0];
  }
  if (sigma_only) {
    __syncthreads();  // the next chunk's first layer overwrites x[cur]
    return;
  }
  const OperandT<T> opf = {t.x[cur], kLdx, w.feat_w, kW};
  dense<kChunk / 16, kW / (16 * kWarps)>(&opf, 1, w.feat_b, t.x[cur ^ 1], kLdx, kNone, t.scratch);
  __syncthreads();
  const OperandT<T> opv[2] = {{t.x[cur ^ 1], kLdx, w.views_wf, kW},
                              {t.pe + kPeViews, kLdpe, w.views_ws, 32}};
  dense<kChunk / 16, kWv / (16 * kWarps)>(opv, 2, w.views_b, t.x[cur], kLdx, kRelu, t.scratch);
  __syncthreads();

  for (int e = tid; e < kChunk * 3; e += kThreads) {
    const int rr = e / 3, ch = e % 3;
    const T* hv = t.x[cur] + rr * kLdx;
    float s = 0.f;
    for (int c = 0; c < kWv; ++c) s += to_f(hv[c]) * to_f(w.rgb_w[ch * kWv + c]);
    if (rr < valid) {
      const float logit = s + w.rgb_b[ch];
      rgb[ch][rr * stride] = raw_rgb ? logit : 1.f / (1.f + expf(-logit));
    }
  }
  __syncthreads();
}

// The MLP over rows [0, rows) of the plane z (row's ray: row / S); writes
// sigma[row] and, unless sigma_only, sigmoid(rgb) to rgb[0..2][row].
// Every thread of the block calls it; it ends on a barrier.
template <typename T>
__device__ __forceinline__ void nerf_rows(const NerfWeightsT<T>& w, const TilesT<T>& t, const float* ray,
                                          const float* z, int rows, int S, bool sigma_only,
                                          float* sigma, float* const* rgb) {
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < rows; c0 += kChunk) {
    // positional encoding of the chunk; rows past the block's rays are zero
    for (int e = tid; e < kChunk * kPeCols; e += kThreads) {
      const int rr = e / kPeCols, col = e % kPeCols, row = c0 + rr;
      float v = 0.f;
      if (row < rows && (col < kPtsCh || (col >= kPeViews && col < kPeViews + kViewCh))) {
        const float* q = ray + 8 * (row / S);
        float u[3];
        if (col < kPtsCh) {
          const float zr = z[row];
          // o + d*z rounded like the plain version: no fused multiply-add
          for (int k = 0; k < 3; ++k) u[k] = __fadd_rn(q[k], __fmul_rn(q[3 + k], zr));
          v = embed(u, col);
        } else {
          for (int k = 0; k < 3; ++k) u[k] = __fdiv_rn(q[3 + k], q[6]);
          v = embed(u, col - kPeViews);
        }
      }
      t.pe[rr * kLdpe + col] = from_f<T>(v);
    }
    __syncthreads();
    float* rgb_c[3] = {nullptr, nullptr, nullptr};
    if (!sigma_only)
      for (int k = 0; k < 3; ++k) rgb_c[k] = rgb[k] + c0;
    mlp_chunk(w, t, rows - c0, sigma_only, false, sigma + c0, rgb_c, 1);
  }
}

// The PE tile of one chunk of point queries: row r of the chunk is the
// point pts[row0 + r] and the unit view direction dirs[(row0 + r) / S]
// (given, not normalized here). q holds the chunk's inputs, 8 floats a row
// (pts[3], dirs[3], 0, 0). Rows [valid, 64) are zero. Ends on a barrier.
__device__ __forceinline__ void point_pe(const float* __restrict__ pts, const float* __restrict__ dirs,
                                         long long row0, int valid, long long S, const Tiles& t,
                                         float* q) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kChunk * 8; e += kThreads) {
    const int rr = e >> 3, c = e & 7;
    float v = 0.f;
    if (rr < valid && c < 6) {
      const long long row = row0 + rr;
      v = c < 3 ? pts[row * 3 + c] : dirs[(row / S) * 3 + (c - 3)];
    }
    q[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < kChunk * kPeCols; e += kThreads) {
    const int rr = e / kPeCols, col = e % kPeCols;
    float v = 0.f;
    if (rr < valid) {
      if (col < kPtsCh) v = embed(q + rr * 8, col);
      else if (col >= kPeViews && col < kPeViews + kViewCh) v = embed(q + rr * 8 + 3, col - kPeViews);
    }
    t.pe[rr * kLdpe + col] = __float2bfloat16(v);
  }
  __syncthreads();
}

// a before b in the stable order: ascending, NaN last, ties by index
__device__ __forceinline__ bool sorts_before(float a, int i, float b, int j) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na ? (nb && i < j) : true;
  return a < b || (a == b && i < j);
}

// Stable sort of each of nr rays' S values src[r*S ..] into dst[r*S ..]:
// every element finds its rank in its ray (S compares, all threads busy).
__device__ __forceinline__ void sort_rows(const float* src, float* dst, int nr, int S) {
  for (int e = threadIdx.x; e < nr * S; e += kThreads) {
    const int base = (e / S) * S, i = e - base;
    const float v = src[e];
    int rank = 0;
    for (int j = 0; j < S; ++j) rank += sorts_before(src[base + j], j, v, i) ? 1 : 0;
    dst[base + rank] = v;
  }
}

}  // namespace nst
