// The NeRF MLP over a block's sample rows of K2/K3/K8/K9 in int8
// (render_around_depth.cu); the bf16 and fp32 render kernels, K6/K7 in
// every type, K4 and K5 run mlp_wgmma.cuh's core instead, which reads the
// weights through NerfWeightsT and read_pack below, whose PE calls embed,
// whose int8 epilogue calls quant_f32 and requant_int, and whose render
// kernels sort with sort_rows.
//
// A block holds, in shared memory, the per-ray data of its R rays (o, d,
// |d|, one spare float each, 8 floats a ray) and a plane of depths z[row]
// whose ray is row / S. nerf_rows walks the rows in chunks of 64: the fp32
// positional encoding of the chunk (accurate sinf/cosf: the argument
// reaches 2^9*|x|, so __sinf is not acceptable), rounded to bf16, goes to a
// PE tile [pts emb 63 | 0 | view emb 27 | 0 x5], the MLP runs layer by layer
// between two activation tiles, and sigma and sigmoid(rgb) land in per-row
// fp32 planes (mlp_chunk: one chunk, whatever filled its PE tile).
// sigma_only runs the trunk and the alpha head alone (JAX heads="sigma").
//
// The MLP is the W8A8 one (K10, kernels/quant.py): NerfWeightsQ holds an
// int8 pack (qpack_nerf) and its requant constants, the activation tiles
// hold int8 (stride kLdq), the PE tile bf16, and mlp_chunk runs layer 0 in
// bf16 with an fp32 -> int8 requant, the int layers as int8 x int8 ->
// int32 products with an integer requant, the skip layer and the views
// layer as the int32 product dequantized plus a bf16 product of the PE
// tile, and the alpha head on the int8 activations. The rounding points are
// JAX's: h*inv_sh + 0.5 in two rounded fp32 steps (__fmul_rn/__fadd_rn: no
// FMA) and a truncating float -> int8 cast; a NaN activation quantizes to 0
// (the plain version's choice).
//
// sort_rows is the stable per-ray sort of a plane, by rank, that K3 and K6
// run before shading: ties keep index order and NaN goes last, compared
// explicitly (fminf/fmaxf and plain < would drop or misplace NaN).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "mlp_tile.cuh"

namespace nst {

constexpr int kW = 256;          // NeRF width the kernels are built for
constexpr int kWv = kW / 2;      // views-layer width
constexpr int kChunk = 64;       // sample rows per MLP pass
constexpr int kPeCols = 96;      // [pts emb 63 | 0 | view emb 27 | 0 x5]
constexpr int kPeViews = 64;     // first column of the view embedding
constexpr int kLdpe = kPeCols + 8;
constexpr int kPtsCh = 63;       // 3 * (1 + 2 * 10)
constexpr int kViewCh = 27;      // 3 * (1 + 2 * 4)
constexpr int kMaxD = 16;
constexpr int kLdq = kW + 32;    // int8 activation stride: gemm_rows_q's 8-byte loads hit 32 banks
constexpr int kLdv = kWv + 8;    // bf16 stride of the int8 MLP's views-layer output

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

// The int8 pack (kernels/quant.py::qpack_nerf) and its requant constants.
template <>
struct NerfWeightsT<int8_t> {
  int D;
  unsigned skip_mask;
  const bf16* w0;               // [64, W]
  const float* b0;              // [W]
  const int8_t* tw[kMaxD];      // layers >= 1: [W, W], [out, in] as every int8 matrix here
  const void* trow[kMaxD];      // int32 bias [W], or the fp32 dequant row [W] at a skip layer
  const bf16* skip_w[kMaxD];    // [64, W] for the layers in skip_mask
  const float* skip_b[kMaxD];   // [W]
  const int8_t* feat_w;         // [W, W]
  const int* feat_b;            // [W] int32
  const bf16* alpha_w;          // [W], the last trunk scales folded in
  const float* alpha_b;         // [1]
  const int8_t* views_wf;       // [W/2, W]
  const float* views_sw;        // [W/2] dequant row
  const bf16* views_ws;         // [32, W/2]
  const float* views_b;         // [W/2]
  const bf16* rgb_w;            // [3, W/2]
  const float* rgb_b;           // [3]
  float inv_sh0;                // layer 0's fp32 requant
  int p[kMaxD], q[kMaxD], m[kMaxD];  // the int layers' requant
  float inv_sh[kMaxD];          // the skip layers' fp32 requant
  int fp, fq, fm;               // the feature layer's requant
};
using NerfWeightsQ = NerfWeightsT<int8_t>;

// Reads an int8 pack from ptrs[k...] (fused_render._flat_qweights): w0, b0,
// tw[1..D-1], trow[1..D-1], (skip_w[i], skip_b[i]) for each set bit of
// skip_mask, then the alpha head alone (sigma_only) or feat_w, feat_b,
// alpha_w, alpha_b, views_wf, views_sw, views_ws, views_b, rgb_w, rgb_b;
// the constants from plan (quant.quant_plan: bits of inv_sh0, then (p, q,
// m, bits of inv_sh) per layer 1..D-1, then the feature layer's (p, q, m)).
// Returns the number of pointers read, or -1 on a bad D / skip_mask / plan.
inline int read_weights_q(const void* const* ptrs, int D, unsigned skip_mask, bool sigma_only,
                          const int* plan, NerfWeightsQ* w) {
  if (D < 1 || D > kMaxD || (skip_mask & 1u) || (skip_mask >> D) || plan == nullptr) return -1;
  *w = NerfWeightsQ{};
  w->D = D;
  w->skip_mask = skip_mask;
  int k = 0;
  w->w0 = static_cast<const bf16*>(ptrs[k++]);
  w->b0 = static_cast<const float*>(ptrs[k++]);
  for (int i = 1; i < D; ++i) w->tw[i] = static_cast<const int8_t*>(ptrs[k++]);
  for (int i = 1; i < D; ++i) w->trow[i] = ptrs[k++];
  for (int i = 1; i < D; ++i)
    if ((skip_mask >> i) & 1u) {
      w->skip_w[i] = static_cast<const bf16*>(ptrs[k++]);
      w->skip_b[i] = static_cast<const float*>(ptrs[k++]);
    }
  if (!sigma_only) {
    w->feat_w = static_cast<const int8_t*>(ptrs[k++]);
    w->feat_b = static_cast<const int*>(ptrs[k++]);
  }
  w->alpha_w = static_cast<const bf16*>(ptrs[k++]);
  w->alpha_b = static_cast<const float*>(ptrs[k++]);
  if (!sigma_only) {
    w->views_wf = static_cast<const int8_t*>(ptrs[k++]);
    w->views_sw = static_cast<const float*>(ptrs[k++]);
    w->views_ws = static_cast<const bf16*>(ptrs[k++]);
    w->views_b = static_cast<const float*>(ptrs[k++]);
    w->rgb_w = static_cast<const bf16*>(ptrs[k++]);
    w->rgb_b = static_cast<const float*>(ptrs[k++]);
  }
  memcpy(&w->inv_sh0, plan, sizeof(float));
  for (int i = 1; i < D; ++i) {
    const int* s = plan + 1 + 4 * (i - 1);
    w->p[i] = s[0];
    w->q[i] = s[1];
    w->m[i] = s[2];
    memcpy(&w->inv_sh[i], s + 3, sizeof(float));
    const bool skip = (skip_mask >> i) & 1u;
    if (skip ? !(w->inv_sh[i] > 0.f) : (s[0] < 0 || s[1] < 0 || s[1] > 30 || s[2] < 1 || s[2] >= (1 << 15)))
      return -1;
  }
  const int* f = plan + 1 + 4 * (D - 1);
  w->fp = f[0];
  w->fq = f[1];
  w->fm = f[2];
  return k;
}

// A pack of element type T from ptrs: read_weights_q with the int8 plan,
// read_weights (and no plan) otherwise; -1 on a bad pack or plan.
template <typename T>
inline int read_pack(const void* const* ptrs, int D, unsigned skip_mask, bool sigma_only, const int* plan,
                     NerfWeightsT<T>* w) {
  if constexpr (std::is_same_v<T, int8_t>) {
    return read_weights_q(ptrs, D, skip_mask, sigma_only, plan, w);
  } else {
    return plan ? -1 : read_weights(ptrs, D, skip_mask, sigma_only, w);
  }
}

// Shared memory of the int8 MLP: two int8 activation tiles, the bf16 PE
// tile and the per-warp fp32 epilogue scratch of wmma. Every offset is a
// multiple of 32 bytes (wmma).
__host__ __device__ constexpr size_t tile_bytes_q() {
  return 2 * kChunk * kLdq + kChunk * kLdpe * sizeof(bf16) + kWarps * kScratchPerWarp * sizeof(float);
}

struct TilesQ {
  int8_t* x[2];    // [64, kLdq] int8 activations; x[cur] also holds the views output, bf16 [64, kLdv]
  bf16* pe;
  float* scratch;  // kWarps fp32 16x16 tiles
};
static_assert(kChunk * kLdv * sizeof(bf16) <= kChunk * kLdq, "the views output must fit an int8 tile");

__device__ __forceinline__ TilesQ carve_tiles(unsigned char* smem) {
  TilesQ t;
  t.x[0] = reinterpret_cast<int8_t*>(smem);
  t.x[1] = t.x[0] + kChunk * kLdq;
  t.pe = reinterpret_cast<bf16*>(t.x[1] + kChunk * kLdq);
  t.scratch = reinterpret_cast<float*>(t.pe + kChunk * kLdpe);
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

// Nonneg fp32 -> int8 by a scalar scale: trunc(min(h*inv + 0.5, 127)) in
// two rounded fp32 steps, as JAX's _requant_fp32; NaN -> 0.
__device__ __forceinline__ int8_t quant_f32(float h, float inv) {
  const float x = __fadd_rn(__fmul_rn(h, inv), 0.5f);
  if (isnan(x)) return 0;
  return (int8_t)(x < 127.f ? (int)x : 127);
}

// clip(((a >> p) + round bit, clamped to +-2^15) * m, rounded >> q, lo, 127):
// JAX's _requant_int (arithmetic shifts; the clamp keeps t*m inside int32).
__device__ __forceinline__ int requant_int(int a, int p, int q, int m, int lo) {
  if (p > 0) a = (a >> p) + ((a >> (p - 1)) & 1);
  a = min(max(a, -(1 << 15)), (1 << 15) - 1) * m;
  if (q > 0) a = (a + (1 << (q - 1))) >> q;
  return min(max(a, lo), 127);
}

// The int8 MLP (K10) over the 64 rows of one chunk whose (bf16) PE tile is
// filled; rows [0, valid) are written: sigma[r] and, unless sigma_only,
// sigmoid(rgb logits) to rgb[ch][r]. Every thread of the block calls it; it
// ends on a barrier.
__device__ __forceinline__ void mlp_chunk(const NerfWeightsQ& w, const TilesQ& t, int valid,
                                          bool sigma_only, float* sigma, float* const* rgb) {
  constexpr int MT = kChunk / 16, NT = kW / (16 * kWarps), NTv = kWv / (16 * kWarps);
  const int tid = threadIdx.x;
  {  // layer 0: bf16 PE @ w0 + b0, relu, fp32 -> int8
    const Operand op0 = {t.pe, kLdpe, w.w0, 64};
    int8_t* out = t.x[0];
    gemm_rows<MT, NT>(&op0, 1, t.scratch, [&](int r, int col, float v, int) {
      out[r * kLdq + col] = quant_f32(activate(v + w.b0[col], kRelu), w.inv_sh0);
    });
  }
  __syncthreads();
  int cur = 0;
  for (int i = 1; i < w.D; ++i) {
    int8_t* out = t.x[cur ^ 1];
    const QOperand qa = {t.x[cur], kLdq, w.tw[i], kW};
    if ((w.skip_mask >> i) & 1u) {
      // (hq @ Wq) * sw + pe @ skip_w + b, relu, fp32 -> int8; in two row
      // halves, so the int32 and fp32 accumulators fit the registers together
      const float* sw = static_cast<const float*>(w.trow[i]);
      const float* b = w.skip_b[i];
      const float inv = w.inv_sh[i];
      const Operand fa = {t.pe, kLdpe, w.skip_w[i], 64};
      for (int r0 = 0; r0 < kChunk; r0 += kChunk / 2)
        gemm_rows_q<MT / 2, NT, true>(qa, fa, r0, t.scratch, [&](int r, int col, int zi, float zf) {
          const float v = __fadd_rn(__fadd_rn(__fmul_rn((float)zi, sw[col]), zf), b[col]);
          out[r * kLdq + col] = quant_f32(activate(v, kRelu), inv);
        });
    } else {
      const int* bz = static_cast<const int*>(w.trow[i]);
      const int p = w.p[i], q = w.q[i], m = w.m[i];
      gemm_rows_q<MT, NT, false>(qa, Operand{}, 0, t.scratch, [&](int r, int col, int zi, float) {
        const int a = zi + bz[col];
        out[r * kLdq + col] = (int8_t)requant_int(a < 0 ? 0 : a, p, q, m, 0);
      });
    }
    __syncthreads();
    cur ^= 1;
  }

  {  // sigma = hq @ alpha_w + alpha_b (exact products): four threads per row
    const int rr = tid >> 2, part = tid & 3;
    const int8_t* h = t.x[cur] + rr * kLdq;
    float s = 0.f;
    for (int c = part * (kW / 4); c < (part + 1) * (kW / 4); ++c) s += (float)h[c] * to_f(w.alpha_w[c]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0 && rr < valid) sigma[rr] = s + w.alpha_b[0];
  }
  if (sigma_only) {
    __syncthreads();  // the next chunk's first layer overwrites x[0]
    return;
  }
  {  // feature: signed integer requant
    int8_t* out = t.x[cur ^ 1];
    const QOperand qf = {t.x[cur], kLdq, w.feat_w, kW};
    gemm_rows_q<MT, NT, false>(qf, Operand{}, 0, t.scratch, [&](int r, int col, int zi, float) {
      out[r * kLdq + col] = (int8_t)requant_int(zi + w.feat_b[col], w.fp, w.fq, w.fm, -127);
    });
  }
  __syncthreads();
  // views: (fq @ views_q) * views_sw + pe_views @ views_ws + views_b, relu,
  // to bf16 in x[cur] (the last trunk activation is read no more)
  bf16* hv = reinterpret_cast<bf16*>(t.x[cur]);
  {
    const QOperand qv = {t.x[cur ^ 1], kLdq, w.views_wf, kW};
    const Operand fv = {t.pe + kPeViews, kLdpe, w.views_ws, 32};
    gemm_rows_q<MT, NTv, true>(qv, fv, 0, t.scratch, [&](int r, int col, int zi, float zf) {
      const float v = __fadd_rn(__fadd_rn(__fmul_rn((float)zi, w.views_sw[col]), zf), w.views_b[col]);
      hv[r * kLdv + col] = __float2bfloat16(activate(v, kRelu));
    });
  }
  __syncthreads();

  for (int e = tid; e < kChunk * 3; e += kThreads) {
    const int rr = e / 3, ch = e % 3;
    const bf16* h = hv + rr * kLdv;
    float s = 0.f;
    for (int c = 0; c < kWv; ++c) s += to_f(h[c]) * to_f(w.rgb_w[ch * kWv + c]);
    if (rr < valid) rgb[ch][rr] = 1.f / (1.f + expf(-(s + w.rgb_b[ch])));
  }
  __syncthreads();
}

// The MLP over rows [0, rows) of the plane z (row's ray: row / S); writes
// sigma[row] and, unless sigma_only, sigmoid(rgb) to rgb[0..2][row].
// Every thread of the block calls it; it ends on a barrier.
__device__ __forceinline__ void nerf_rows(const NerfWeightsQ& w, const TilesQ& t, const float* ray,
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
      t.pe[rr * kLdpe + col] = __float2bfloat16(v);
    }
    __syncthreads();
    float* rgb_c[3] = {nullptr, nullptr, nullptr};
    if (!sigma_only)
      for (int k = 0; k < 3; ++k) rgb_c[k] = rgb[k] + c0;
    mlp_chunk(w, t, rows - c0, sigma_only, sigma + c0, rgb_c);
  }
}

// a before b in the stable order: ascending, NaN last, ties by index
__device__ __forceinline__ bool sorts_before(float a, int i, float b, int j) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na ? (nb && i < j) : true;
  return a < b || (a == b && i < j);
}

// Stable sort of each of nr rays' S values src[r*S ..] into dst[r*S ..]:
// every element finds its rank in its ray (S compares, all `threads`
// threads busy).
__device__ __forceinline__ void sort_rows(const float* src, float* dst, int nr, int S, int threads = kThreads) {
  for (int e = threadIdx.x; e < nr * S; e += threads) {
    const int base = (e / S) * S, i = e - base;
    const float v = src[e];
    int rank = 0;
    for (int j = 0; j < S; ++j) rank += sorts_before(src[base + j], j, v, i) ? 1 : 0;
    dst[base + rank] = v;
  }
}

}  // namespace nst
