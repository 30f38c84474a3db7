// What the MLP core (mlp_wgmma.cuh) and the render kernels share: the
// element types and activations, the epilogue vectors of the NeRF's packs
// (NerfWeightsT, read_pack: bf16, fp32, and the W8A8 int8 pack of K10 with
// its requant constants), the positional encoding (embed), the int8
// requants, and the per-ray sort.
//
// The MLP is the W8A8 one in int8 (K10, kernels/quant.py): NerfWeightsQ
// holds an int8 pack's (qpack_nerf) vectors and its requant constants. The rounding
// points are JAX's: h*inv_sh + 0.5 in two rounded fp32 steps
// (__fmul_rn/__fadd_rn: no FMA) and a truncating float -> int8 cast
// (quant_f32; a NaN activation quantizes to 0, the plain version's
// choice), and the integer requant of the int layers (requant_int).
//
// The positional encoding is fp32 with accurate sinf/cosf: the argument
// reaches 2^9*|x|, so __sinf is not acceptable.
//
// sort_rows is the stable per-ray sort of a plane, by rank, that K3 and K6
// run before shading: ties keep index order and NaN goes last, compared
// explicitly (fminf/fmaxf and plain < would drop or misplace NaN).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace nst {

using bf16 = __nv_bfloat16;

constexpr int kW = 256;          // NeRF width the kernels are built for
constexpr int kWv = kW / 2;      // views-layer width
constexpr int kPeCols = 96;      // [pts emb 63 | 0 | view emb 27 | 0 x5]
constexpr int kPeViews = 64;     // first column of the view embedding
constexpr int kPtsCh = 63;       // 3 * (1 + 2 * 10)
constexpr int kViewCh = 27;      // 3 * (1 + 2 * 4)
constexpr int kMaxD = 16;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

// Comparisons keep a NaN where fmaxf would drop it: a ray that misses the
// bounding sphere must stay NaN end to end, as in the reference.
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return v < 0.f ? 0.f : v;
  if (act == kLeaky) return v > 0.f ? v : 0.01f * v;
  return v;
}

// The vectors the epilogues of a NeRF pack read. The matrices reach the
// device once, as the pack's weight slices (mlp_wgmma.cuh), which the launch
// hands over before these vectors.
template <typename T>
struct NerfWeightsT {
  int D;
  unsigned skip_mask;           // bit i: layer i also reads the point embedding
  const float* tb[kMaxD];       // [W]
  const float* feat_b;          // [W]
  const T* alpha_w;             // [W]
  const float* alpha_b;         // [1]
  const float* views_b;         // [W/2]
  const T* rgb_w;               // [3, W/2]
  const float* rgb_b;           // [3]
};
using NerfWeights = NerfWeightsT<bf16>;

// Reads a bf16 or fp32 pack's epilogue vectors from ptrs[k...] (see
// fused_render.epilogue_vectors): tb[0..D-1], then alpha_w and alpha_b
// alone (sigma_only) or feat_b, alpha_w, alpha_b, views_b, rgb_w, rgb_b.
// Returns the number of pointers read, or -1 on a bad D / skip_mask.
template <typename T>
inline int read_weights(const void* const* ptrs, int D, unsigned skip_mask, bool sigma_only,
                        NerfWeightsT<T>* w) {
  if (D < 1 || D > kMaxD || (skip_mask & 1u) || (skip_mask >> D)) return -1;
  *w = NerfWeightsT<T>{};
  w->D = D;
  w->skip_mask = skip_mask;
  int k = 0;
  for (int i = 0; i < D; ++i) w->tb[i] = static_cast<const float*>(ptrs[k++]);
  if (!sigma_only) w->feat_b = static_cast<const float*>(ptrs[k++]);
  w->alpha_w = static_cast<const T*>(ptrs[k++]);
  w->alpha_b = static_cast<const float*>(ptrs[k++]);
  if (sigma_only) return k;
  w->views_b = static_cast<const float*>(ptrs[k++]);
  w->rgb_w = static_cast<const T*>(ptrs[k++]);
  w->rgb_b = static_cast<const float*>(ptrs[k++]);
  return k;
}

// The int8 pack's (kernels/quant.py::qpack_nerf) epilogue vectors and its
// requant constants.
template <>
struct NerfWeightsT<int8_t> {
  int D;
  unsigned skip_mask;
  const float* b0;              // [W]
  const void* trow[kMaxD];      // int32 bias [W], or the fp32 dequant row [W] at a skip layer
  const float* skip_b[kMaxD];   // [W]
  const int* feat_b;            // [W] int32
  const bf16* alpha_w;          // [W], the last trunk scales folded in
  const float* alpha_b;         // [1]
  const float* views_sw;        // [W/2] dequant row
  const float* views_b;         // [W/2]
  const bf16* rgb_w;            // [3, W/2]
  const float* rgb_b;           // [3]
  float inv_sh0;                // layer 0's fp32 requant
  int p[kMaxD], q[kMaxD], m[kMaxD];  // the int layers' requant
  float inv_sh[kMaxD];          // the skip layers' fp32 requant
  int fp, fq, fm;               // the feature layer's requant
};
using NerfWeightsQ = NerfWeightsT<int8_t>;

// Reads an int8 pack's epilogue vectors from ptrs[k...]
// (fused_render.epilogue_vectors): b0, trow[1..D-1], skip_b[i] for each set
// bit of skip_mask, then alpha_w and alpha_b alone (sigma_only) or feat_b,
// alpha_w, alpha_b, views_sw, views_b, rgb_w, rgb_b; the constants from
// plan (quant.quant_plan: bits of inv_sh0, then (p, q, m, bits of inv_sh)
// per layer 1..D-1, then the feature layer's (p, q, m)). Returns the number
// of pointers read, or -1 on a bad D / skip_mask / plan.
inline int read_weights_q(const void* const* ptrs, int D, unsigned skip_mask, bool sigma_only,
                          const int* plan, NerfWeightsQ* w) {
  if (D < 1 || D > kMaxD || (skip_mask & 1u) || (skip_mask >> D) || plan == nullptr) return -1;
  *w = NerfWeightsQ{};
  w->D = D;
  w->skip_mask = skip_mask;
  int k = 0;
  w->b0 = static_cast<const float*>(ptrs[k++]);
  for (int i = 1; i < D; ++i) w->trow[i] = ptrs[k++];
  for (int i = 1; i < D; ++i)
    if ((skip_mask >> i) & 1u) w->skip_b[i] = static_cast<const float*>(ptrs[k++]);
  if (!sigma_only) w->feat_b = static_cast<const int*>(ptrs[k++]);
  w->alpha_w = static_cast<const bf16*>(ptrs[k++]);
  w->alpha_b = static_cast<const float*>(ptrs[k++]);
  if (!sigma_only) {
    w->views_sw = static_cast<const float*>(ptrs[k++]);
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

// a before b in the stable order: ascending, NaN last, ties by index
__device__ __forceinline__ bool sorts_before(float a, int i, float b, int j) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na ? (nb && i < j) : true;
  return a < b || (a == b && i < j);
}

// Stable sort of each of nr rays' S values src[r*S ..] into dst[r*S ..]:
// every element finds its rank in its ray (S compares), by the caller's
// first `threads` threads.
__device__ __forceinline__ void sort_rows(const float* src, float* dst, int nr, int S, int threads) {
  for (int e = threadIdx.x; e < nr * S; e += threads) {
    const int base = (e / S) * S, i = e - base;
    const float v = src[e];
    int rank = 0;
    for (int j = 0; j < S; ++j) rank += sorts_before(src[base + j], j, v, i) ? 1 : 0;
    dst[base + rank] = v;
  }
}

}  // namespace nst
