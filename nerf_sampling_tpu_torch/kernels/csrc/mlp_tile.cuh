// The MLP cores of K1 in bf16 (depth_net.cu) and of K2/K3/K8/K9 in int8
// (nerf_mlp.cuh's int8 chunk): one dense layer over a tile of rows whose
// activations live in shared memory. (K2-K9 in bf16, K8/K9 in fp32, K6/K7 in
// every type, K4, K5 and K1 in fp32 run the wgmma core of mlp_wgmma.cuh.)
//
//   out[16*MT, N] = act(sum_op A_op @ W_op + bias),   N = kWarps * NT * 16
//
// A_op is a bf16 tile in shared memory (row-major, stride lda); W_op is a
// [K, N] row-major bf16 matrix in device memory. The MLP weights (a few MB)
// stay resident in the 50 MB L2, so every block streams them from L2 while
// its activations never leave the SM. A concatenation in the reference
// (skip inputs, embeddings) is a second operand accumulated into the same
// fp32 sum, with zero-padded weight rows where an operand is wider than its
// logical input.
//
// bf16: products run on the tensor cores through nvcuda::wmma 16x16x16
// bf16 fragments with fp32 accumulation. Warp w owns output columns
// [w*NT*16, (w+1)*NT*16) for every row; the epilogue adds the fp32 bias,
// applies the activation and rounds to bf16, the rounding points of the
// TPU kernels (bf16 activations, fp32 accumulation).
//
// int8 (the W8A8 MLP, K10, in K2/K3/K8/K9): gemm_rows_q runs an int8 x int8 product with
// int32 accumulation on the tensor cores (IMMA: mma.sync.m16n8k32 s8 in
// inline PTX, its fragments loaded by hand with aligned 8-byte loads; the
// int8 weights are [N, k], k contiguous), optionally beside a bf16
// operand's fp32 product (wmma, as above; the skip and views layers merge
// both), and hands each element's int32 and fp32 sums to an epilogue,
// which requantizes in the integer domain or in fp32 (nerf_mlp.cuh).
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace nst {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// fp32 floats of per-warp epilogue scratch (one 16x16 accumulator tile)
constexpr int kScratchPerWarp = 256;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

struct Operand {
  const bf16* a;  // shared-memory tile, row-major
  int lda;        // its row stride in elements (a multiple of 8)
  const bf16* w;  // device [k, N] row-major
  int k;          // depth of the product, a multiple of 16
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Comparisons keep a NaN where fmaxf would drop it: a ray that misses the
// bounding sphere must stay NaN end to end, as in the reference.
__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return v < 0.f ? 0.f : v;
  if (act == kLeaky) return v > 0.f ? v : 0.01f * v;
  return v;
}

// The product of dense(), handed to an epilogue: epi(row, col, v, j) for
// every element, v the fp32 sum over the operands, j the warp's column
// tile (0..NT-1; col = warp * NT * 16 + j * 16 + (col & 15)). Each element
// goes to exactly one lane, always the same one, in a fixed order, so a
// per-lane sum over the epilogue's calls is deterministic.
template <int MT, int NT, typename Epi>
__device__ __forceinline__ void gemm_rows(const Operand* ops, int n_ops, float* scratch, Epi epi) {
  constexpr int N = kWarps * NT * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = warp * NT * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int o = 0; o < n_ops; ++o) {
    const Operand op = ops[o];
    for (int k = 0; k < op.k; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        wmma::load_matrix_sync(b[j], op.w + (size_t)k * N + col0 + j * 16, N);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, op.a + i * 16 * op.lda + k, op.lda);
#pragma unroll
        for (int j = 0; j < NT; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }

  float* s = scratch + warp * kScratchPerWarp;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(s, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) epi(i * 16 + (e >> 4), col0 + j * 16 + (e & 15), s[e], j);
      __syncwarp();
    }
  }
}

// An int8 operand: a [rows, k] tile in shared memory (row-major, stride lda
// bytes, a multiple of 8) against an int8 matrix w [N, k] in device memory,
// each output column's k weights contiguous (nn.Linear's [out, in]).
struct QOperand {
  const signed char* a;
  int lda;
  const signed char* w;
  int k;  // a multiple of 32
};

// acc += A @ B over one k32 step on the tensor cores (IMMA,
// mma.sync.m16n8k32 s8 x s8 -> s32): A 16x32 as four registers of four
// int8 each, B 32x8 as two (PTX ISA, "Matrix Fragments for mma.m16n8k32").
__device__ __forceinline__ void mma_s8(int (&acc)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [row0, row0 + 16*MT) of the int8 product q (int32 sums) and, with
// WithF, of the bf16 operand f (fp32 sums) over the same output columns:
// epi(row, col, zi, zf) for every element, once, always from the same lane
// (zf is 0 without WithF). scratch holds kWarps fp32 16x16 tiles (WithF).
//
// Lane l of a warp (g = l / 4, t = l % 4) holds, of each 16x8 output tile,
// rows g and g + 8 at columns 2t and 2t + 1. Its A and B registers are
// 8-byte loads of k [8t, 8t + 8) of each k32 step, the first four bytes in
// the fragment's k [4t, 4t + 4), the last four in [16 + 4t, 16 + 4t + 4):
// one permutation of k, the same for A and B, which leaves the integer sum
// as it is. Every load is 8-byte aligned and no fragment pointer needs more.
template <int MT, int NT, bool WithF, typename Epi>
__device__ __forceinline__ void gemm_rows_q(const QOperand& q, const Operand& f, int row0, float* scratch,
                                            Epi epi) {
  constexpr int NB = 2 * NT;  // 8-column tiles of the warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = warp * NT * 16;

  int acc[MT][NB][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int k = 0; k < q.k; k += 32) {
    unsigned b[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q.w + (size_t)(col0 + j * 8 + g) * q.k + k + 8 * t));
      b[j][0] = v.x;
      b[j][1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const signed char* ar = q.a + (row0 + i * 16 + g) * q.lda + k + 8 * t;
      const uint2 lo = *reinterpret_cast<const uint2*>(ar);
      const uint2 hi = *reinterpret_cast<const uint2*>(ar + 8 * q.lda);
      const unsigned a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_s8(acc[i][j], a, b[j]);
    }
  }
  if constexpr (WithF) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> accf[MT][NT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::fill_fragment(accf[i][j], 0.f);
    for (int k = 0; k < f.k; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[NT];
      constexpr int N = kWarps * NT * 16;
#pragma unroll
      for (int j = 0; j < NT; ++j) wmma::load_matrix_sync(b[j], f.w + (size_t)k * N + col0 + j * 16, N);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, f.a + (row0 + i * 16) * f.lda + k, f.lda);
#pragma unroll
        for (int j = 0; j < NT; ++j) wmma::mma_sync(accf[i][j], a, b[j], accf[i][j]);
      }
    }
    float* sf = scratch + warp * kScratchPerWarp;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::store_matrix_sync(sf, accf[i][j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1), c = h * 8 + 2 * t + (e & 1);
            epi(row0 + i * 16 + r, col0 + j * 16 + c, acc[i][2 * j + h][e], sf[r * 16 + c]);
          }
        __syncwarp();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          epi(row0 + i * 16 + g + 8 * (e >> 1), col0 + j * 8 + 2 * t + (e & 1), acc[i][j][e], 0.f);
  }
}

template <int MT, int NT>
__device__ void dense(const Operand* ops, int n_ops, const float* __restrict__ bias,
                      bf16* out, int ldo, int act, float* scratch) {
  gemm_rows<MT, NT>(ops, n_ops, scratch, [&](int r, int col, float v, int) {
    out[r * ldo + col] = __float2bfloat16(activate(v + bias[col], act));
  });
}

}  // namespace nst
