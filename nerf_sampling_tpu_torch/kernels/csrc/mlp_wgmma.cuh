// The Hopper MLP core: dense layers over 64-row warpgroup tiles on wgmma,
// with the weights streamed through a ring of shared-memory slices by a
// producer warp. Every MLP of the port runs on it: K6/K7 in bf16, int8 and
// fp32 (render_hier.cu), K2/K3/K8/K9 in bf16, int8 and fp32
// (render_around_depth.cu), K1 in bf16 and fp32 (depth_net.cu), K4
// (nerf_points.cu), K5's row pass (nerf_points_bwd.cu) and the [core] check
// (wg_dense.cu). The fp32 path (3xTF32 products, 64-row tiles, one consumer
// warpgroup) and the DepthNet's bf16 program are described at their
// sections below.
//
//   acc[64 rows of a warpgroup, NH * 128] = sum_op A_op @ B_op
//
// in bf16 (fp32 sums) or in int8 (s8 x s8 -> s32 sums, exact in any
// order), followed, in each kernel, by a register epilogue: bf16, an fp32
// bias, activate() (NaN kept), a bf16 round, written straight into the
// activation tile the next layer reads; int8 (K10, kernels/quant.py), the
// requants of nerf_mlp.cuh at JAX's rounding points. Rounding points are
// the TPU kernels': only the order of the fp32 sums differs.
//
// Block: two consumer warpgroups (threads 0-255) and one producer warp
// (256-287) whose first lane issues the copies. Warpgroup g owns rows
// [64g, 64g + 64) of every 128-row tile,
// so each staged slice feeds 128 rows: half the L2 weight bytes per FLOP of
// a 64-row tile, and no fp32 scratch round trip.
//
// Shared-memory layouts (all 128-byte swizzled, K-major, 1024-byte aligned;
// what wgmma's descriptor with layout SWIZZLE_128B and SBO = 1024 reads):
// rows of 128 bytes, the 16-byte chunk c of row r at chunk c ^ (r % 8).
// - a bf16 activation tile: 128 rows x 64k columns as k panels of 16 KB,
//   panel p holding columns [64p, 64p + 64); element (r, c) at
//   tile_offset(r, c). Warpgroup g's A operand starts 8 KB into each panel.
// - an int8 activation tile: 128 rows x 128k columns as k panels of 16 KB,
//   panel p holding columns [128p, 128p + 128); element (r, c) at
//   qtile_offset(r, c).
// - a weight slice, 16 KB: bf16, 128 output columns x 64 of depth, element
//   (n, k) at n * 128 + ((k / 8) ^ (n % 8)) * 16 + (k % 8) * 2; int8, 128
//   output columns x 128 of depth, element (n, k) at n * 128 + ((k / 16) ^
//   (n % 8)) * 16 + k % 16. The host writes that byte image of every slice
//   (kernels/fused_render.py::wgmma_slices, wgmma_qslices), in the order a
//   tile consumes them, so the producer moves each with one cp.async.bulk
//   and an mbarrier completion. One stream may mix both kinds.
// A product of depth K and width N reads ceil(K/64) (int8: ceil(K/128)) *
// ceil(N/128) slices, k panels outer, 128-column halves inner; zero-padded
// rows and columns add exact zeros to the sums. Each k step of a product is
// 32 bytes of depth (k16 bf16, k32 int8), so one descriptor walk serves both.
//
// Each 128-row tile of a render pass begins with its PE tile, which the
// consumers fill while the tensor cores wait: per row one sincosf per
// (frequency, axis) of the point's embedding and a copy of its ray's view
// embedding, staged once per pass (stage_views, pe_fill; bit for bit the
// per-column embed it replaced: the section "the render kernels' PE fill").
// A tile of point queries (K4, K5) fills its PE tile alike, the view
// embeddings staged once per tile for the rays it touches (point_fill).
//
// The weight sequence of a pass does not depend on the activations, so the
// producer runs ahead across layers and tiles, bounded by free ring stages
// (full/empty mbarrier pairs; each consumer warp releases a stage after its
// own wgmma.wait_group). What bounds it on the H100: L2 -> SM bandwidth for
// the slices (128 multiply-adds per byte at 128 rows in bf16, 256 in int8)
// and the tensor-core rate; in int8 also the integer requant epilogue.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "nerf_mlp.cuh"

namespace nst {
namespace wg {

constexpr int kRows = 128;                    // rows per weight pass
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kSliceBytes = 128 * 64 * 2;     // one staged weight slice (bf16 128 x 64 or int8 128 x 128)
constexpr int kPanelBytes = kRows * 128;      // one panel of a tile: 64 bf16 or 128 int8 columns
constexpr int kHalfPanel = kPanelBytes / 2;   // warpgroup 1's rows in a panel
constexpr int kBarConsumers = 1;              // named barrier of threads 0-255; warpgroup g: 2 + g

// byte offset of element (row, col) of a swizzled bf16 tile whose 64-column
// panels are `panel` bytes apart (128 rows: kPanelBytes)
__host__ __device__ constexpr uint32_t tile_offset(int row, int col, uint32_t panel = kPanelBytes) {
  return (uint32_t)((col >> 6) * panel + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1));
}

// byte offset of element (row, col) of a swizzled 128-row int8 tile
__host__ __device__ constexpr uint32_t qtile_offset(int row, int col) {
  return (uint32_t)((col >> 7) * kPanelBytes + row * 128 + ((((col & 127) >> 4) ^ (row & 7)) << 4) + (col & 15));
}

// Slices of one tile's pass over a NeRF: the forward (trunk; unless
// sigma_only the feature and views layers) and K5's backward (the views and
// feature layers' d_h, the trunk chain, and with want_dx the dL/dPE hops).
// kernels/fused_render.py::wgmma_program lists the same matrices in order.
__host__ __device__ inline int popcount_u(unsigned v) {
  int n = 0;
  for (; v; v &= v - 1) ++n;
  return n;
}
__host__ __device__ inline int forward_slices(int D, unsigned skip_mask, bool sigma_only) {
  return 2 + 8 * (D - 1) + 2 * popcount_u(skip_mask) + (sigma_only ? 0 : 8 + 4 + 1);
}
// mip-NeRF's forward (nerf_forward<S, 2>): layer 0 and each skip matrix
// read both PE panels, 4 slices each; the heads as forward_slices'.
__host__ __device__ inline int mip_forward_slices(int D, unsigned skip_mask, bool sigma_only) {
  return 4 + 8 * (D - 1) + 4 * popcount_u(skip_mask) + (sigma_only ? 0 : 8 + 4 + 1);
}
__host__ __device__ inline int backward_slices(int D, unsigned skip_mask, bool want_dx) {
  return 4 + 8 * D + (want_dx ? 2 + 4 * popcount_u(skip_mask) + 4 : 0);
}
// The int8 forward (nerf_forward on NerfWeightsQ): layer 0's 2 bf16 slices,
// 4 int8 slices a trunk layer, 2 bf16 more at a skip layer; unless
// sigma_only the feature layer's 4, the views layer's 2 int8 and 1 bf16.
// kernels/fused_render.py::wgmma_qprogram lists the same matrices in order.
__host__ __device__ inline int forward_qslices(int D, unsigned skip_mask, bool sigma_only) {
  return 2 + 4 * (D - 1) + 2 * popcount_u(skip_mask) + (sigma_only ? 0 : 4 + 2 + 1);
}

// ---- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void consumers_sync() { bar_sync(kBarConsumers, kConsumers); }
__device__ __forceinline__ void group_sync() { bar_sync(2 + (threadIdx.x >> 7), 128); }
// generic-proxy writes of shared memory -> visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// returns once the phase of parity `parity` has completed; a wait of more
// than 2^35 cycles (about 20 s) traps, so a broken stream fails the launch
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers that an in-flight wgmma writes
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: groups of 8 rows of 128
// bytes, 1024 bytes apart (SBO). K-major (the rule here): a row holds 64 k
// of one m or n. MN-major (pass (b) of K5): a row holds 64 m or n of one k,
// and `lbo` bytes separate the 64-wide blocks of m or n.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128], bf16 in, fp32 accumulate; both
// operands K-major, or both MN-major with kMN = 1
template <int kMN = 0>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kMN));
}

// d[64 x 128] += A[64 x 32] @ B[32 x 128], s8 in, s32 accumulate; both
// operands K-major (the only layout of 8-bit wgmma). An integer wgmma takes
// no scale or transpose immediates; its accumulator fragment is laid out
// as the fp32 one.
__device__ __forceinline__ void mma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---- the ring

// S stages of kSliceBytes, then the full and empty mbarriers (8 bytes each)
template <int S>
struct Ring {
  uint32_t data;  // shared address of stage 0
  __device__ __forceinline__ uint32_t full(int s) const { return data + S * kSliceBytes + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return data + S * kSliceBytes + 8 * (S + s); }
  static constexpr int kBytes = S * kSliceBytes + 16 * S;
  // one thread, before the role split and a block-wide barrier; every
  // consumer warp releases a stage
  __device__ void init(int consumer_warps = kConsumers / 32) const {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), consumer_warps);
    }
    mbar_fence_init();
  }
};

// A consumer's position in the slice stream.
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
};

// One run of the slice stream: n slices from `slices`, `repeat` times over
// (16 KB each, bf16 or int8 images; the pointer type is nominal).
struct Segment {
  const bf16* slices;
  int n, repeat;
};

// The producer: every slice of the segments into the ring, in order, each
// as soon as its stage is free. The warp's first lane (thread `lead`, the
// first after the consumers) issues; the others return at once.
template <int S>
__device__ void produce(const Ring<S>& ring, const Segment* segs, int n_segs, int lead = kConsumers) {
  if ((int)threadIdx.x != lead) return;
  int stage = 0;
  uint32_t phase = 0;
  for (int g = 0; g < n_segs; ++g)
    for (int rep = 0; rep < segs[g].repeat; ++rep)
      for (int s = 0; s < segs[g].n; ++s) {
        const bf16* src = segs[g].slices + (size_t)s * (kSliceBytes / 2);
        mbar_wait(ring.empty(stage), phase ^ 1);  // the first round passes at once
        mbar_expect_tx(ring.full(stage), kSliceBytes);
        bulk_g2s(ring.data + stage * kSliceBytes, src, kSliceBytes, ring.full(stage));
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
}

// An A operand: `panels` panels of a tile at shared address `tile` (64
// bf16 or 128 int8 columns each), `panel` bytes apart: 16 KB in a 128-row
// tile, whose warpgroup g reads rows [64g, 64g + 64); 8 KB in a 64-row
// tile of one warpgroup (the DepthNet's, kDepthPanel).
struct Src {
  uint32_t tile;
  int panels;
  uint32_t panel = kPanelBytes;
};

// acc = sum over src of A @ B, B the next slices of the stream: bf16 with
// float acc, int8 with int acc; every consumer thread of the warpgroup
// calls it. With accumulate the sums continue from acc (bf16), else from
// zero. Ends with every slice released.
template <int NH, int S, typename Acc>
__device__ __forceinline__ void gemm(Acc (&acc)[NH][64], const Src* src, int n_src, const Ring<S>& ring,
                                     Cursor& cur, bool accumulate = false) {
  const uint32_t row_off = (threadIdx.x >> 7) * kHalfPanel;
  const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (!accumulate)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0;
    fence_regs(acc[h]);
  }
  int prev = -1;
  for (int o = 0; o < n_src; ++o)
    for (int kp = 0; kp < src[o].panels; ++kp) {
      const uint32_t a = src[o].tile + kp * src[o].panel + row_off;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        mbar_wait(ring.full(cur.stage), cur.phase);
        const uint32_t b = ring.data + cur.stage * kSliceBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (std::is_same_v<Acc, int>)
            mma_m64n128k32_s8(acc[h], sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
          else
            mma_m64n128k16(acc[h], sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done
        if (prev >= 0 && lead) mbar_arrive(ring.empty(prev));
        prev = cur.stage;
        if (++cur.stage == S) {
          cur.stage = 0;
          cur.phase ^= 1;
        }
      }
    }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
  if (prev >= 0 && lead) mbar_arrive(ring.empty(prev));
}

// ---- the register epilogue

// Calls f(row, col, h, i) for each pair acc[h][i], acc[h][i + 1] the thread
// holds, at columns col and col + 1 of row `row` of its warpgroup's 64:
// col = h * 128 + 8 j + 2 (lane % 4), row = 16 (warp % 4) + lane / 4 + 8 hh,
// i = 4 j + 2 hh.
template <int NH, typename F>
__device__ __forceinline__ void for_pairs(F f) {
  const int lane = threadIdx.x & 31;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) f(r + 8 * hh, h * 128 + 8 * j + c, h, 4 * j + 2 * hh);
}

// acc <- bf16(activate(acc + bias)), held as floats
template <int NH>
__device__ __forceinline__ void bias_act(float (&acc)[NH][64], const float* __restrict__ bias, int act) {
  for_pairs<NH>([&](int, int col, int h, int i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    const __nv_bfloat162 v = __floats2bfloat162_rn(activate(acc[h][i] + b.x, act), activate(acc[h][i + 1] + b.y, act));
    acc[h][i] = __low2float(v);
    acc[h][i + 1] = __high2float(v);
  });
}

// The byte offsets of the thread's pairs in a swizzled 128-row tile:
// tile_offset(row, col) = base(hh) + pair_offset(h, j) with the row parts
// hoisted (the thread's two rows share row % 8, so one XOR serves both).
struct PairAddr {
  uint32_t row_base[2];  // rows r and r + 8 of the thread, in this warpgroup
  uint32_t sw;           // row % 8, the swizzle of both rows
  uint32_t c;            // 2 * (lane % 4): the pair's column within its 8
  __device__ __forceinline__ PairAddr() {
    const int lane = threadIdx.x & 31;
    const int r = 64 * (threadIdx.x >> 7) + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    row_base[0] = r * 128;
    row_base[1] = (r + 8) * 128;
    sw = r & 7;
    c = 2 * (lane & 3);
  }
  // pair (h, i = 4j + 2hh): column h * 128 + 8 j + c, in a tile of panels kPanel bytes apart
  template <uint32_t kPanel = kPanelBytes>
  __device__ __forceinline__ uint32_t at(int h, int i) const {
    const int j = i >> 2, col8 = h * 16 + j;  // the 8-column group
    return (col8 >> 3) * kPanel + row_base[(i >> 1) & 1] + (((col8 & 7) ^ sw) << 4) + (c << 1);
  }
};

// acc (bf16 values) into a tile at this warpgroup's rows: a 128-row tile,
// or with kPanel = kDepthPanel the 64-row tile of one warpgroup. The caller
// has synced the warpgroup after its last product reading the tile; this
// ends with the tile visible to the warpgroup's next wgmma.
template <int NH, uint32_t kPanel = kPanelBytes>
__device__ __forceinline__ void store_tile(const float (&acc)[NH][64], unsigned char* tile) {
  const PairAddr pa;
  for_pairs<NH>([&](int, int, int h, int i) {
    *reinterpret_cast<__nv_bfloat162*>(tile + pa.template at<kPanel>(h, i)) =
        __floats2bfloat162_rn(acc[h][i], acc[h][i + 1]);
  });
  fence_async_smem();
  group_sync();
}

__device__ __forceinline__ float2 pair_at(const bf16* __restrict__ w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
}
__device__ __forceinline__ float2 pair_at(const float* __restrict__ w) { return *reinterpret_cast<const float2*>(w); }

// The per-row dot products of acc with CH rows of bf16 (or fp32) weights
// w[ch * ld + col]: out[2 ch + hh] for the thread's rows (hh = 0, 1), the
// sum over all columns, in every lane of the row's quad.
template <int NH, int CH, typename Wt>
__device__ __forceinline__ void row_dots(const float (&acc)[NH][64], const Wt* __restrict__ w, int ld,
                                         float (&out)[2 * CH]) {
#pragma unroll
  for (int k = 0; k < 2 * CH; ++k) out[k] = 0.f;
  for_pairs<NH>([&](int, int col, int h, int i) {
    const int hh = (i >> 1) & 1;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const float2 wv = pair_at(w + ch * ld + col);
      out[2 * ch + hh] += acc[h][i] * wv.x + acc[h][i + 1] * wv.y;
    }
  });
#pragma unroll
  for (int k = 0; k < 2 * CH; ++k) {
    out[k] += __shfl_xor_sync(0xffffffffu, out[k], 1);
    out[k] += __shfl_xor_sync(0xffffffffu, out[k], 2);
  }
}

// Rows [64g + 0, 64g + 64) of a swizzled tile's first `cols` columns (this
// warpgroup's rows) to rows row0 + 64g + ... of a row-major bf16 plane, in
// 16-byte stores. The caller has synced the warpgroup after writing them.
__device__ __forceinline__ void copy_rows(const unsigned char* tile, int cols, bf16* plane, long long row0) {
  const int g = threadIdx.x >> 7, per_row = cols / 8;
  for (int e = threadIdx.x & 127; e < 64 * per_row; e += 128) {
    const int r = 64 * g + e / per_row, c = (e % per_row) * 8;
    *reinterpret_cast<uint4*>(plane + (row0 + r) * cols + c) =
        *reinterpret_cast<const uint4*>(tile + tile_offset(r, c));
  }
}

// ---- the NeRF on the core (K2/K3/K6-K9 in bf16, K6/K7 in int8)

// Shared memory of the NeRF passes: the activation tile (four panels: one
// bf16 tile, or two int8 tiles of two panels), the PE tile (two bf16
// panels: [pts emb 63 | 0] and [view emb 27 | 0 x 37]) and the ring, from a
// 1024-byte aligned base.
template <int S>
struct Tiles {
  unsigned char* x;
  unsigned char* pe;
  Ring<S> ring;
  static constexpr int kBytes = 4 * kPanelBytes + 2 * kPanelBytes + Ring<S>::kBytes;
};
template <int S>
__device__ __forceinline__ Tiles<S> carve(unsigned char* base) {
  Tiles<S> t;
  t.x = base;
  t.pe = base + 4 * kPanelBytes;
  t.ring.data = smem_u32(base + 6 * kPanelBytes);
  return t;
}

// The forward over one 128-row tile whose PE tile is filled: the per-row
// sigma (alpha head) and, unless sigma_only, the sigmoid(rgb) (the logits
// with raw) of this warpgroup's valid rows, into sigma[row * stride] and
// rgb[ch][row * stride] (row within the 128). kPts: the PE panels that layer
// 0 and the skip layers read (1: the NeRF's point panel, forward_slices();
// 2: both panels, mip-NeRF's IPE and view columns, mip_forward_slices()),
// fixed at compile time; the views layer reads the second panel. Consumes
// that count of the stream.
template <int S, int kPts = 1>
__device__ void nerf_forward(const NerfWeights& w, const Tiles<S>& t, Cursor& cur, int valid, bool sigma_only,
                             float* sigma, float* const* rgb, bool raw = false, int stride = 1) {
  const uint32_t x = smem_u32(t.x), pe = smem_u32(t.pe);
  const int lane = threadIdx.x & 31;
  const int r0 = 64 * (threadIdx.x >> 7) + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  float acc[2][64];
  for (int i = 0; i < w.D; ++i) {
    const Src ops[2] = {{i == 0 ? pe : x, i == 0 ? kPts : 4}, {pe, kPts}};
    gemm(acc, ops, (i > 0 && ((w.skip_mask >> i) & 1u)) ? 2 : 1, t.ring, cur);
    bias_act(acc, w.tb[i], kRelu);
    if (i == w.D - 1) {  // sigma = h @ alpha_w + alpha_b
      float s[2];
      row_dots<2, 1>(acc, w.alpha_w, 0, s);
      if ((lane & 3) == 0)
        for (int hh = 0; hh < 2; ++hh)
          if (r0 + 8 * hh < valid) sigma[(r0 + 8 * hh) * stride] = s[hh] + w.alpha_b[0];
      if (sigma_only) return;
    }
    group_sync();  // the warpgroup's products read x no more
    store_tile(acc, t.x);
  }
  {
    const Src op = {x, 4};
    gemm(acc, &op, 1, t.ring, cur);
    bias_act(acc, w.feat_b, kNone);
    group_sync();
    store_tile(acc, t.x);
  }
  float accv[1][64];
  const Src opv[2] = {{x, 4}, {pe + kPanelBytes, 1}};
  gemm(accv, opv, 2, t.ring, cur);
  bias_act(accv, w.views_b, kRelu);
  float s[6];
  row_dots<1, 3>(accv, w.rgb_w, kWv, s);
  if ((lane & 3) == 0)
    for (int ch = 0; ch < 3; ++ch)
      for (int hh = 0; hh < 2; ++hh)
        if (r0 + 8 * hh < valid) {
          const float logit = s[2 * ch + hh] + w.rgb_b[ch];
          rgb[ch][(r0 + 8 * hh) * stride] = raw ? logit : 1.f / (1.f + expf(-logit));
        }
}

// Two int8 values into a swizzled int8 tile at (row, col) and (row, col + 1), col even
__device__ __forceinline__ void store_q2(unsigned char* tile, int row, int col, int a, int b) {
  *reinterpret_cast<uint16_t*>(tile + qtile_offset(row, col)) = (uint16_t)((a & 0xFF) | ((b & 0xFF) << 8));
}

// The int8 forward (K10: kernels/quant.py's chain at JAX's rounding
// points, nerf_mlp.cuh's requants) over one 128-row tile whose bf16 PE
// tile is filled; outputs as the bf16 nerf_forward. The activations are
// int8 in two tiles of t.x (panels 0-1 and 2-3): a layer reads one and
// writes the other. Consumes forward_qslices() of the stream:
//   layer 0    bf16 PE @ w0, + b0, relu, quant_f32
//   int layer  int8 @ tw, + bz, max 0, requant_int
//   skip layer per 128-column half (the int32 and the fp32 sums of a half
//              fit the registers together): int8 @ tw, then bf16 PE @
//              skip_w in its own fp32 sums, z * sw + zf + b in rounded fp32
//              steps, relu, quant_f32
//   alpha head (float)hq . alpha_w from the last trunk layer's registers
//   feature    int8 @ feat_w, + feat_b, requant_int down to -127
//   views      int8 @ views_wf and bf16 PE views @ views_ws, merged as a
//              skip half, relu, bf16; rgb = hv . rgb_w + rgb_b
template <int S>
__device__ void nerf_forward(const NerfWeightsQ& w, const Tiles<S>& t, Cursor& cur, int valid, bool sigma_only,
                             float* sigma, float* const* rgb) {
  const uint32_t pe = smem_u32(t.pe);
  unsigned char* const xq[2] = {t.x, t.x + 2 * kPanelBytes};
  const int lane = threadIdx.x & 31;
  const int g64 = 64 * (threadIdx.x >> 7);
  const int r0 = g64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  float sa[2] = {0.f, 0.f};  // the alpha head over the thread's columns, rows r0 and r0 + 8
  // the pair (a, b) of row r (of the warpgroup's 64), columns col and col + 1,
  // into tile x and, at the last trunk layer, into the alpha head
  auto put = [&](unsigned char* x, bool last, int r, int col, int hh, int a, int b) {
    if (last) {
      const float2 aw = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w.alpha_w + col));
      sa[hh] += (float)a * aw.x + (float)b * aw.y;  // exact products
    }
    if (!last || !sigma_only) store_q2(x, g64 + r, col, a, b);
  };
  // the fp32 merge of a half's int32 and fp32 sums: z * sw + zf + b, rounded step by step
  auto merge = [](int z, float sw, float zf, float b) { return __fadd_rn(__fadd_rn(__fmul_rn((float)z, sw), zf), b); };

  {  // layer 0
    float acc[2][64];
    const Src op = {pe, 1};
    gemm(acc, &op, 1, t.ring, cur);
    for_pairs<2>([&](int r, int col, int h, int i) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(w.b0 + col));
      put(xq[0], w.D == 1, r, col, (i >> 1) & 1, quant_f32(activate(acc[h][i] + b.x, kRelu), w.inv_sh0),
          quant_f32(activate(acc[h][i + 1] + b.y, kRelu), w.inv_sh0));
    });
    fence_async_smem();
    group_sync();
  }
  int cx = 0;  // the tile holding the current layer's input
  for (int i = 1; i < w.D; ++i) {
    const Src op = {smem_u32(xq[cx]), 2};
    unsigned char* out = xq[cx ^ 1];
    const bool last = i == w.D - 1;
    if ((w.skip_mask >> i) & 1u) {
      const float* sw = static_cast<const float*>(w.trow[i]);
      const float* b = w.skip_b[i];
      const float inv = w.inv_sh[i];
      const Src opf = {pe, 1};
      for (int h = 0; h < 2; ++h) {
        int zi[1][64];
        float zf[1][64];
        gemm(zi, &op, 1, t.ring, cur);
        gemm(zf, &opf, 1, t.ring, cur);
        for_pairs<1>([&](int r, int c, int, int j) {
          const int col = 128 * h + c;
          const float2 s2 = __ldg(reinterpret_cast<const float2*>(sw + col));
          const float2 b2 = __ldg(reinterpret_cast<const float2*>(b + col));
          put(out, last, r, col, (j >> 1) & 1, quant_f32(activate(merge(zi[0][j], s2.x, zf[0][j], b2.x), kRelu), inv),
              quant_f32(activate(merge(zi[0][j + 1], s2.y, zf[0][j + 1], b2.y), kRelu), inv));
        });
      }
    } else {
      const int* bz = static_cast<const int*>(w.trow[i]);
      const int p = w.p[i], q = w.q[i], m = w.m[i];
      int acc[2][64];
      gemm(acc, &op, 1, t.ring, cur);
      for_pairs<2>([&](int r, int col, int h, int j) {
        const int2 b2 = __ldg(reinterpret_cast<const int2*>(bz + col));
        const int a0 = acc[h][j] + b2.x, a1 = acc[h][j + 1] + b2.y;
        put(out, last, r, col, (j >> 1) & 1, requant_int(a0 < 0 ? 0 : a0, p, q, m, 0),
            requant_int(a1 < 0 ? 0 : a1, p, q, m, 0));
      });
    }
    fence_async_smem();
    group_sync();
    cx ^= 1;
  }

  // sigma = hq @ alpha_w + alpha_b, summed over the row's quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sa[hh] += __shfl_xor_sync(0xffffffffu, sa[hh], 1);
    sa[hh] += __shfl_xor_sync(0xffffffffu, sa[hh], 2);
  }
  if ((lane & 3) == 0)
    for (int hh = 0; hh < 2; ++hh)
      if (r0 + 8 * hh < valid) sigma[r0 + 8 * hh] = sa[hh] + w.alpha_b[0];
  if (sigma_only) return;

  {  // feature: a signed integer requant
    int acc[2][64];
    const Src op = {smem_u32(xq[cx]), 2};
    gemm(acc, &op, 1, t.ring, cur);
    for_pairs<2>([&](int r, int col, int h, int j) {
      const int2 b2 = __ldg(reinterpret_cast<const int2*>(w.feat_b + col));
      store_q2(xq[cx ^ 1], g64 + r, col, requant_int(acc[h][j] + b2.x, w.fp, w.fq, w.fm, -127),
               requant_int(acc[h][j + 1] + b2.y, w.fp, w.fq, w.fm, -127));
    });
    fence_async_smem();
    group_sync();
    cx ^= 1;
  }
  int zi[1][64];
  float zf[1][64];
  const Src opq = {smem_u32(xq[cx]), 2}, opv = {pe + kPanelBytes, 1};
  gemm(zi, &opq, 1, t.ring, cur);
  gemm(zf, &opv, 1, t.ring, cur);
  for_pairs<1>([&](int, int col, int, int j) {
    const float2 s2 = __ldg(reinterpret_cast<const float2*>(w.views_sw + col));
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(w.views_b + col));
    const __nv_bfloat162 v = __floats2bfloat162_rn(activate(merge(zi[0][j], s2.x, zf[0][j], b2.x), kRelu),
                                                   activate(merge(zi[0][j + 1], s2.y, zf[0][j + 1], b2.y), kRelu));
    zf[0][j] = __low2float(v);
    zf[0][j + 1] = __high2float(v);
  });
  float s[6];
  row_dots<1, 3>(zf, w.rgb_w, kWv, s);
  if ((lane & 3) == 0)
    for (int ch = 0; ch < 3; ++ch)
      for (int hh = 0; hh < 2; ++hh)
        if (r0 + 8 * hh < valid) rgb[ch][r0 + 8 * hh] = 1.f / (1.f + expf(-(s[2 * ch + hh] + w.rgb_b[ch])));
}

// ---- the render kernels' PE fill (K2/K3/K8/K9 and K6/K7, bf16 and int8)
//
// The rows of a render pass are samples of the block's rays: row r is the
// point o + d z[r] of ray r / S, seen from the ray's unit direction d / |d|
// (ray: o[3], d[3], |d| per ray, 8 floats). Its PE row is
//   [u, sin(u 2^0), cos(u 2^0), ..., sin(u 2^9), cos(u 2^9) | 0]  (63 + 1)
//   [v, sin(v 2^0), cos(v 2^0), ..., sin(v 2^3), cos(v 2^3) | 0]  (27 + 37)
// with u = o + d z and v = d / |d|, each value nerf_mlp.cuh::embed's,
// rounded to bf16. Each distinct value is computed once:
// - per pass that reads the view panel (not a sigma-only one): the view
//   panel's columns 96-127, zero in every row and written by no tile, and
//   each ray's view embedding, staged as 32 bf16 (27 and 5 zeros, 64 bytes)
//   a ray (stage_views);
// - per row: the row's ray (one division), u (the three rounded
//   __fadd_rn(o, __fmul_rn(d, z)) of the plain version: no FMA), then one
//   sincosf(u_k 2^f) per frequency f and axis k, which gives both column
//   3 + 6f + k (sine) and column 6 + 6f + k (cosine); the view panel's
//   first 64 bytes are a copy of the ray's staged embedding (pe_fill).
// Bit for bit the per-column fill it replaced (every element embed(u, col)
// or embed(v, col), __float2bfloat16): the same fp32 operations in the same
// order, sincosf giving sinf's and cosf's bits (no __sinf/__cosf, fast math
// or recurrence: the argument reaches 2^9 |u|), NaN depths NaN in the same
// columns, rows past the pass zero; chip_smoke.py [core] holds the two
// fills' bytes equal on the card (wg_dense.cu's nst_pe_fill_check).
//
// Two threads a row: thread h = 0 the frequencies 0-4 and point columns
// 0-31, h = 1 the frequencies 5-9 and columns 32-63 (column 32, the last
// cosine of frequency 4, by a shuffle from its partner lane), each 15
// sincosf and four 16-byte stores; the view panel's chunks 2h and 2h + 1.
// A store instruction's quarter warp (4 rows x 2 halves) hits 8 distinct
// 16-byte chunks of the swizzle in the point panel (chunk (4h + q) ^ (row %
// 8)), so the point stores are free of bank conflicts; the view stores are
// 2-way (chunks 0-3 of 4 rows whose swizzles share their high bit).

// The view embedding of rays [0, nr) into view[32 r .. 32 r + 32) and the
// view panel's columns 96-127 zero, before the first tile of a pass that
// reads the view panel; all consumer threads. Ends with both visible to
// every consumer and to the tensor cores.
__device__ __forceinline__ void stage_views(const float* ray, int nr, bf16* view, unsigned char* pe) {
  for (int e = threadIdx.x; e < nr * 32; e += kConsumers) {
    const int r = e >> 5, col = e & 31;
    float v = 0.f;
    if (col < kViewCh) {
      const float* q = ray + 8 * r;
      float u[3];
      for (int k = 0; k < 3; ++k) u[k] = __fdiv_rn(q[3 + k], q[6]);
      v = embed(u, col);
    }
    view[e] = __float2bfloat16(v);
  }
  for (int e = threadIdx.x; e < kRows * 4; e += kConsumers)
    *reinterpret_cast<uint4*>(pe + tile_offset(e >> 2, kPeViews + 32 + 8 * (e & 3))) = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  consumers_sync();
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The PE tile of rows [c0, c0 + 128) of a pass of `rows` rows, S a ray,
// this warpgroup's 64: the point panel from z and the rays, the view panel
// (unless sigma_only) from stage_views' embeddings; rows from `rows` on
// zero. Begins by waiting for the warpgroup's products of the previous
// tile; ends with the PE tile visible to its next wgmma.
__device__ __forceinline__ void pe_fill(unsigned char* pe, const float* ray, const bf16* view, const float* z,
                                        int c0, int rows, int S, bool sigma_only) {
  const int lt = threadIdx.x & 127, h = lt & 1;
  const int rr = 64 * (threadIdx.x >> 7) + (lt >> 1), row = c0 + rr;
  const bool live = row < rows;
  const int r = live ? row / S : 0;
  float u[3] = {0.f, 0.f, 0.f};
  if (live) {
    const float* q = ray + 8 * r;
    const float zr = z[row];
    // o + d*z rounded like the plain version: no fused multiply-add
    for (int k = 0; k < 3; ++k) u[k] = __fadd_rn(q[k], __fmul_rn(q[3 + k], zr));
  }
  // sine and cosine of u_k 2^f for this half's frequencies f = 5h + j
  float sn[5][3], cs[5][3];
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) sincosf(u[k] * (float)(1 << (5 * h + j)), &sn[j][k], &cs[j][k]);
  const float c32 = __shfl_xor_sync(0xffffffffu, cs[4][2], 1);  // column 32, from the first half
  // the half's columns 32h + i: h = 0: u, then frequency j's sines at 3 +
  // 6j + k and cosines at 6 + 6j + k; h = 1: column 32, then frequency 5 +
  // j's at 1 + 6j + k and 4 + 6j + k, and column 63 zero
  float v[32];
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (h == 0) {
        v[3 + 6 * j + k] = sn[j][k];
        if (6 + 6 * j + k < 32) v[6 + 6 * j + k] = cs[j][k];
      } else {
        v[1 + 6 * j + k] = sn[j][k];
        v[4 + 6 * j + k] = cs[j][k];
      }
    }
  if (h == 0) {
    v[0] = u[0];
    v[1] = u[1];
    v[2] = u[2];
  } else {
    v[0] = c32;
    v[31] = 0.f;
  }
  group_sync();  // the previous tile's products read the PE tile no more
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (live)
      w = make_uint4(bf16x2_bits(v[8 * q], v[8 * q + 1]), bf16x2_bits(v[8 * q + 2], v[8 * q + 3]),
                     bf16x2_bits(v[8 * q + 4], v[8 * q + 5]), bf16x2_bits(v[8 * q + 6], v[8 * q + 7]));
    *reinterpret_cast<uint4*>(pe + tile_offset(rr, 32 * h + 8 * q)) = w;
  }
  if (!sigma_only) {
    const uint4* src = reinterpret_cast<const uint4*>(view + 32 * r) + 2 * h;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<uint4*>(pe + tile_offset(rr, kPeViews + 16 * h + 8 * q)) =
          live ? src[q] : make_uint4(0u, 0u, 0u, 0u);
  }
  fence_async_smem();
  group_sync();
}

// The MLP over rows [0, rows) of the plane z (row's ray: row / S), on the
// core, as nerf_mlp.cuh::nerf_rows: sigma[row] and, unless sigma_only,
// sigmoid(rgb) into rgb[0..2][row]; bf16 or int8 by the weights' type.
// view: room for the view embeddings of the pass's rays (32 bf16 a ray,
// 16-byte aligned; stage_views). Consumer threads only; ends without a
// block-wide barrier (the caller syncs the consumers).
template <int S, typename Weights>
__device__ void nerf_rows(const Weights& w, const Tiles<S>& t, Cursor& cur, const float* ray, bf16* view,
                          const float* z, int rows, int Sr, bool sigma_only, float* sigma, float* const* rgb) {
  if (!sigma_only) stage_views(ray, (rows + Sr - 1) / Sr, view, t.pe);
  for (int c0 = 0; c0 < rows; c0 += kRows) {
    pe_fill(t.pe, ray, view, z, c0, rows, Sr, sigma_only);
    float* rgb_c[3] = {nullptr, nullptr, nullptr};
    if (!sigma_only)
      for (int k = 0; k < 3; ++k) rgb_c[k] = rgb[k] + c0;
    nerf_forward(w, t, cur, rows - c0, sigma_only, sigma + c0, rgb_c);
  }
}

// ---- mip-NeRF's PE fill (K11, render_mip.cu)
//
// The rows of a pass are intervals of the block's rays: row r is interval s
// = r % S, [t[s], t[s + 1]], of ray r / S, t the pass's plane of S + 1
// t-values a ray (ray: o[3], d[3], |d|, base radius, 8 floats). Its PE row
// fills both panels of the PE tile:
//   [w sin(y) x 48 | w sin(y + pi/2) x 48 | view 27 | 0 x 5]
// at column 3 l + k for scale 2^l (l = 0..15) and axis k: y = 2^l mean_k,
// var = 4^l cov_k, w = exp(-var / 2), (mean, cov) the Gaussian of the
// interval's conical frustum (mip-NeRF's stable form, diagonal covariance:
// frustum_gaussian); an argument of magnitude 100 pi or more is taken modulo
// 100 pi first (mip-NeRF's safe_sin: safe_wrap, fmodf's exact remainder);
// each value rounded to bf16. One sincosf of the wrapped y gives both
// columns: the cosine stands for mip-NeRF's sin(y + pi/2), a rounding of y +
// pi/2 apart. Without `integrate` every variance is 0 (mip-NeRF's
// disable_integration). The view columns are the ray's pos_enc of d / |d|,
// staged once per launch (stage_mip_views). Every operation in fp32 in the
// order of kernels/fused_mip.py's plain version (no FMA), sincosf and expf
// accurate.
// Two threads a row: h = 0 the scales 0-7, h = 1 the scales 8-15 (24
// (scale, axis) pairs: 24 sine and 24 cosine columns, six 16-byte stores),
// and the view chunks 2h and 2h + 1.

constexpr float kSafeWrap = 314.159271240234375f;          // fl(100 pi)
constexpr float kHalfPi = 1.57079637050628662109375f;      // fl(pi / 2)

// mip-NeRF's safe_sin argument: x where |x| < 100 pi, else x % 100 pi
// (Python's modulus, the divisor's sign: a negative remainder plus 100 pi).
// The remainder is fmodf's, exact: |x| - n 100 pi in one fused rounding of
// a representable value, n the quotient truncated, corrected where the
// product by the rounded reciprocal put it one off. NaN and infinities give
// NaN.
__device__ __forceinline__ float safe_wrap(float x) {
  const float ax = fabsf(x);
  if (ax < kSafeWrap) return x;
  const float n = truncf(__fmul_rn(ax, 1.f / kSafeWrap));
  float r = fmaf(-n, kSafeWrap, ax);
  if (r < 0.f) r = fmaf(-(n - 1.f), kSafeWrap, ax);
  else if (r >= kSafeWrap) r = fmaf(-(n + 1.f), kSafeWrap, ax);
  return x < 0.f ? (r != 0.f ? __fsub_rn(kSafeWrap, r) : -r) : r;
}

// The Gaussian of the conical frustum [t0, t1] of ray q (o, d, |d|, base
// radius): mean[3] = o + d t_mean, cov[3] = t_var d^2 + r_var (1 - d^2 /
// max(|d|^2, 1e-10))
__device__ __forceinline__ void frustum_gaussian(const float* q, float t0, float t1, float* mean, float* cov) {
  const float mu = __fmul_rn(__fadd_rn(t0, t1), 0.5f), hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
  const float mu2 = __fmul_rn(mu, mu), hw2 = __fmul_rn(hw, hw), hw4 = __fmul_rn(hw2, hw2);
  const float den = __fadd_rn(__fmul_rn(3.f, mu2), hw2);
  const float t_mean = __fadd_rn(mu, __fdiv_rn(__fmul_rn(__fmul_rn(2.f, mu), hw2), den));
  const float t_var = __fsub_rn(
      __fdiv_rn(hw2, 3.f),
      __fmul_rn(4.f / 15.f, __fdiv_rn(__fmul_rn(hw4, __fsub_rn(__fmul_rn(12.f, mu2), hw2)), __fmul_rn(den, den))));
  const float r_var = __fmul_rn(__fmul_rn(q[7], q[7]),
                                __fsub_rn(__fadd_rn(__fdiv_rn(mu2, 4.f), __fmul_rn(5.f / 12.f, hw2)),
                                          __fdiv_rn(__fmul_rn(4.f / 15.f, hw4), den)));
  float d2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d2[k] = __fmul_rn(q[3 + k], q[3 + k]);
  const float mag = fmaxf(__fadd_rn(__fadd_rn(d2[0], d2[1]), d2[2]), 1e-10f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mean[k] = __fadd_rn(__fmul_rn(q[3 + k], t_mean), q[k]);
    cov[k] = __fadd_rn(__fmul_rn(t_var, d2[k]), __fmul_rn(r_var, __fsub_rn(1.f, __fdiv_rn(d2[k], mag))));
  }
}

// Each ray's pos_enc of d / |d| with its identity, [v, sin(2^l v) (l = 0..3,
// scale-major), sin(2^l v + pi/2), 0 x 5], as 32 bf16 into view[32 r ..];
// all consumer threads; ends with a consumers' barrier.
__device__ __forceinline__ void stage_mip_views(const float* ray, int nr, bf16* view) {
  for (int e = threadIdx.x; e < nr * 32; e += kConsumers) {
    const int r = e >> 5, col = e & 31;
    float v = 0.f;
    if (col < kViewCh) {
      const float* q = ray + 8 * r;
      const int c = col < 3 ? col : (col - 3) % 3;
      v = __fdiv_rn(q[3 + c], q[6]);
      if (col >= 3) {
        const int l = ((col - 3) % 12) / 3;
        const float x = __fmul_rn(v, (float)(1 << l));
        v = sinf(col >= 15 ? __fadd_rn(x, kHalfPi) : x);
      }
    }
    view[e] = __float2bfloat16(v);
  }
  consumers_sync();
}

// The PE tile of rows [c0, c0 + 128) of a pass of `rows` interval rows, S a
// ray, t-values tv (S + 1 a ray), this warpgroup's 64; rows from `rows` on
// zero. Begins by waiting for the warpgroup's products of the previous
// tile; ends with the PE tile visible to its next wgmma.
__device__ __forceinline__ void ipe_fill(unsigned char* pe, const float* ray, const bf16* view, const float* tv,
                                         int c0, int rows, int S, bool integrate) {
  const int lt = threadIdx.x & 127, h = lt & 1;
  const int rr = 64 * (threadIdx.x >> 7) + (lt >> 1), row = c0 + rr;
  const bool live = row < rows;
  const int r = live ? row / S : 0;
  float mean[3] = {0.f, 0.f, 0.f}, cov[3] = {0.f, 0.f, 0.f};
  if (live) {
    const float* tt = tv + r * (S + 1) + (row - r * S);
    frustum_gaussian(ray + 8 * r, tt[0], tt[1], mean, cov);
    if (!integrate) cov[0] = cov[1] = cov[2] = 0.f;
  }
  uint32_t sn[3][4], cs[3][4];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float a[2], b[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * q + j + e, k = c % 3;   // pair 24 h + c: scale 8 h + c / 3, axis k
        const float sc = __int_as_float((127 + 8 * h + c / 3) << 23);  // 2^l, exact
        const float y = __fmul_rn(mean[k], sc), var = __fmul_rn(cov[k], __fmul_rn(sc, sc));
        const float w = expf(__fmul_rn(-0.5f, var));
        float sv, cv;
        sincosf(safe_wrap(y), &sv, &cv);
        a[e] = __fmul_rn(w, sv);
        b[e] = __fmul_rn(w, cv);
      }
      sn[q][j >> 1] = bf16x2_bits(a[0], a[1]);
      cs[q][j >> 1] = bf16x2_bits(b[0], b[1]);
    }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  group_sync();  // the previous tile's products read the PE tile no more
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    *reinterpret_cast<uint4*>(pe + tile_offset(rr, 24 * h + 8 * q)) =
        live ? make_uint4(sn[q][0], sn[q][1], sn[q][2], sn[q][3]) : zero;
    *reinterpret_cast<uint4*>(pe + tile_offset(rr, 48 + 24 * h + 8 * q)) =
        live ? make_uint4(cs[q][0], cs[q][1], cs[q][2], cs[q][3]) : zero;
  }
  const uint4* src = reinterpret_cast<const uint4*>(view + 32 * r) + 2 * h;
#pragma unroll
  for (int q = 0; q < 2; ++q)
    *reinterpret_cast<uint4*>(pe + tile_offset(rr, 96 + 16 * h + 8 * q)) = live ? src[q] : zero;
  fence_async_smem();
  group_sync();
}

// ---- the point-query kernels' PE fill (K4, K5's row pass)
//
// The rows of a launch are points: row r is the point x = pts[r] seen from
// the unit direction v = dirs[r / S] (given, not normalized here). Its PE
// row is the render kernels' (the section above) of x and v, each value
// nerf_mlp.cuh::embed's, rounded to bf16. Each distinct value is computed
// once:
// - per tile, the view embedding of each ray the tile's rows touch (rays
//   row0 / S to (row0 + valid - 1) / S: at most 2 at S >= 64, 128 at S =
//   1), one sincosf per (frequency, axis) giving both the sine and the
//   cosine column, staged as 32 bf16 (27 and 5 zeros) a ray
//   (stage_point_views);
// - per row, the point read once and one sincosf(x_k 2^f) per frequency f
//   and axis k, two threads a row as pe_fill's (column 32 by a shuffle,
//   four 16-byte stores); the view panel's first 64 bytes a copy of the
//   ray's staged embedding, its columns 96-127 zero (point_fill).
// Bit for bit the per-column fill it replaced (every element embed(x, col)
// or embed(v, col), __float2bfloat16): the same fp32 operations in the
// same order, sincosf giving sinf's and cosf's bits (no __sinf/__cosf,
// fast math or recurrence: the argument reaches 2^9 |x|), NaN inputs NaN
// in the same columns, rows from `valid` on zero; chip_smoke.py [core]
// holds the two fills' bytes equal on the card (wg_dense.cu's
// nst_point_fill_check).

// The view embeddings of rays [ra, ra + nr) of dirs into view[32 (r - ra)
// ..]: one sincosf per (frequency, axis) of a ray; all consumer threads, no
// barrier.
__device__ __forceinline__ void stage_point_views(const float* __restrict__ dirs, long long ra, int nr, bf16* view) {
#pragma unroll 1
  for (int e = threadIdx.x; e < nr * 16; e += kConsumers) {
    const int r = e >> 4, p = e & 15;
    const float* d = dirs + (ra + r) * 3;
    bf16* out = view + 32 * r;
    if (p < 12) {  // frequency f = p / 3, axis k: the sine at column 3 + 6f + k, the cosine at 6 + 6f + k
      const int f = p / 3, k = p - 3 * f;
      float sv, cv;
      sincosf(d[k] * (float)(1 << f), &sv, &cv);
      out[3 + 6 * f + k] = __float2bfloat16(sv);
      out[6 + 6 * f + k] = __float2bfloat16(cv);
    } else if (p < 15) {
      out[p - 12] = __float2bfloat16(d[p - 12]);
    } else {
      for (int c = kViewCh; c < 32; ++c) out[c] = __float2bfloat16(0.f);
    }
  }
}

// The PE tile of one 128-row tile of point queries (K4, K5): rows [row0,
// row0 + valid) of pts [M, 3] with directions dirs [M / S, 3], rows [valid,
// 128) zero. view: room for the tile's staged rays (128 x 32 bf16, 16-byte
// aligned) that no consumer reads before this call's barrier: a kernel
// that walks several tiles alternates two. q, unless null: the tile's
// inputs, 8 floats a row (pts[3], dirs[3], 0, 0), which K5's dx reads. All
// consumer threads: one barrier of the consumers (the staged rays
// visible, every consumer's products of the previous tile done), then the
// stores; ends with the PE tile visible to its next wgmma. kRolled: the
// row's 15 sincosf in a loop of one copy, for a kernel that fills one tile
// a block (K5's row pass), whose every block fetches the fill's code cold;
// unrolled (K4, several tiles a block) they overlap, the code warm after
// the first tile. Both give the same bits.
template <bool kRolled = false>
__device__ __forceinline__ void point_fill(const float* __restrict__ pts, const float* __restrict__ dirs,
                                           long long row0, int valid, long long S, bf16* view, float* q,
                                           unsigned char* pe) {
  const int lt = threadIdx.x & 127, h = lt & 1;
  const int rr = 64 * (threadIdx.x >> 7) + (lt >> 1);
  const bool live = rr < valid;
  const long long row = row0 + rr, ra = row0 / S;
  const int r = live ? (int)(row / S - ra) : 0;  // the row's ray among the staged
  float x[3] = {0.f, 0.f, 0.f};
  if (live)
    for (int k = 0; k < 3; ++k) x[k] = pts[row * 3 + k];
  // sine and cosine of x_k 2^f for this half's frequencies f = 5h + j
  float sn[5][3], cs[5][3];
  if constexpr (kRolled) {
#pragma unroll 1
    for (int i = 0; i < 15; ++i) {
      const int j = i / 3, k = i - 3 * j;
      const float xk = k == 0 ? x[0] : k == 1 ? x[1] : x[2];
      float sv, cv;
      sincosf(xk * (float)(1 << (5 * h + j)), &sv, &cv);
#pragma unroll
      for (int t = 0; t < 15; ++t)
        if (t == i) {
          sn[t / 3][t % 3] = sv;
          cs[t / 3][t % 3] = cv;
        }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) sincosf(x[k] * (float)(1 << (5 * h + j)), &sn[j][k], &cs[j][k]);
  }
  const float c32 = __shfl_xor_sync(0xffffffffu, cs[4][2], 1);  // column 32, from the first half
  // the half's columns 32h + i, as pe_fill's
  float v[32];
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (h == 0) {
        v[3 + 6 * j + k] = sn[j][k];
        if (6 + 6 * j + k < 32) v[6 + 6 * j + k] = cs[j][k];
      } else {
        v[1 + 6 * j + k] = sn[j][k];
        v[4 + 6 * j + k] = cs[j][k];
      }
    }
  if (h == 0) {
    v[0] = x[0];
    v[1] = x[1];
    v[2] = x[2];
  } else {
    v[0] = c32;
    v[31] = 0.f;
  }
  stage_point_views(dirs, ra, (int)((row0 + valid - 1) / S - ra) + 1, view);
  consumers_sync();  // the staged rays visible; the previous tile's products read the PE tile no more
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint4 w = zero;
    if (live)
      w = make_uint4(bf16x2_bits(v[8 * c], v[8 * c + 1]), bf16x2_bits(v[8 * c + 2], v[8 * c + 3]),
                     bf16x2_bits(v[8 * c + 4], v[8 * c + 5]), bf16x2_bits(v[8 * c + 6], v[8 * c + 7]));
    *reinterpret_cast<uint4*>(pe + tile_offset(rr, 32 * h + 8 * c)) = w;
  }
  const uint4* src = reinterpret_cast<const uint4*>(view + 32 * r) + 2 * h;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    *reinterpret_cast<uint4*>(pe + tile_offset(rr, kPeViews + 16 * h + 8 * c)) = live ? src[c] : zero;
    *reinterpret_cast<uint4*>(pe + tile_offset(rr, kPeViews + 32 + 16 * h + 8 * c)) = zero;
  }
  if (q) {  // h = 0 the point, h = 1 the direction
    float* qr = q + rr * 8 + 3 * h;
    for (int k = 0; k < 3; ++k) qr[k] = !live ? 0.f : h == 0 ? x[k] : dirs[(row / S) * 3 + k];
    q[rr * 8 + 6 + h] = 0.f;
  }
  fence_async_smem();
  group_sync();
}

// ---- the fp32 path: 3xTF32 products (K7, K8/K9 and K1 in fp32, [core]'s fp32 layer)
//
// An fp32 operand x runs on the tf32 tensor cores split in two, hi =
// tf32(x) and lo = tf32(x - hi), both rounded to nearest (cvt.rna, ties
// away from zero), and x @ w is summed as lo @ w_hi + hi @ w_lo + hi @ w_hi
// in fp32: the lo @ w_lo term (about 2^-22 of a product) is the only one
// dropped. The host writes the weights' hi and lo images
// (kernels/fused_render.py::wgmma_slices32); the activations are split
// here, in registers, one 8-deep k step at a time. The tensor cores' fp32
// accumulation is not round-to-nearest: each wgmma adds into its
// accumulators with an error of about an ulp of them, biased toward zero,
// and 96 of them in one chain (three products per k step at K = 256) put
// a layer several times further from an fp64 matmul than torch.matmul in
// fp32 (fault_check.py's tf32_chain on an H100). So each 32-deep panel is
// summed afresh, its 8 corrections first (while the sum is small) and its
// 4 main products last, and the panel sums are added to the layer's in
// rounded fp32: about 4 such errors per panel, at the panel's magnitude.
//
// Block: one consumer warpgroup (threads 0-127) on 64-row tiles and the
// producer warp (128-159). The A operand comes from registers. wgmma's tf32
// A fragment holds, in lane l of warp w, rows 16w + l/4 and 16w + l/4 + 8
// at columns l%4 and l%4 + 4 of the k step's 8; its fp32 accumulator holds
// the same rows at columns 2(l%4) and 2(l%4) + 1 of every 8. The host
// writes each 8-deep k group of every weight slice permuted (depth s of the
// group holds the weights' row 2s of it for s < 4, 2(s - 4) + 1 after:
// fused_render.TF32_PERM), so that a layer's accumulator, as the thread
// holds it, is the next layer's A fragment: an activation never leaves its
// thread. Between layers it waits in shared
// memory, thread-private: for each 8-column group g of the operand the
// thread's float4 (row r col c, r c+1, r+8 c, r+8 c+1), c = 8g + 2(l%4),
// at store[g * 128 + tid] (16-byte accesses, no bank conflicts, no
// barriers). The PE is filled the same way, by the thread that reads it;
// an operand in device memory (the DepthNet's embeddings A and B) is read
// from a copy that the host wrote in this order (fused_depth_net.
// fragment_tiles).
// A weight slice, 16 KB: fp32, 128 output columns x 32 of depth, element
// (n, k) at n * 128 + ((k / 4) ^ (n % 8)) * 16 + (k % 4) * 4 (the same
// 128-byte swizzle; a k8 step is 32 bytes of depth, as bf16 k16 and s8
// k32, so the descriptor walk, ring and producer are the bf16 path's). A
// product of depth K and width N reads, per 32-deep k panel and 128-column
// half (k panels outer, halves inner), the hi slice then the lo slice.
//
// Why this shape: 128 rows of fp32 activations (128 KB) and PE (48 KB)
// do not fit beside a ring in 227 KB, and two consumer warpgroups get 168
// registers a thread, too few for 128 fp32 accumulators and the split A
// fragments; one warpgroup gets up to 255, and its tile's activations (64
// KB) and PE (24 KB) leave room for a 6-stage ring.

constexpr int kConsumers32 = 128;                 // one consumer warpgroup
constexpr int kThreads32 = kConsumers32 + 32;     // and one producer warp
constexpr int kRows32 = 64;                       // rows per weight pass
constexpr int kStages32 = 6;
constexpr int kXGroups32 = kW / 8, kPeGroups32 = kPeCols / 8;  // 8-column groups of the activations and PE

// The fp32 forward's slices (nerf_forward on NerfWeightsT<float>): two (hi,
// lo) per 32-deep panel and 128-column half of each product: w0 8, a trunk
// layer 32, a skip matrix 8; unless sigma_only the feature layer's 32, the
// views layer's 16 + 2. kernels/fused_render.py::wgmma_slices32 writes them.
__host__ __device__ inline int forward_slices32(int D, unsigned skip_mask, bool sigma_only) {
  return 8 + 32 * (D - 1) + 8 * popcount_u(skip_mask) + (sigma_only ? 0 : 32 + 16 + 2);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d[64 x 128] += A[64 x 8] @ B[8 x 128], tf32 in (A: the thread's fragment
// registers; B K-major, the only tf32 layout), fp32 accumulate
__device__ __forceinline__ void mma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += lo @ B_hi + hi @ B_lo, the 3xTF32 corrections of one k step
__device__ __forceinline__ void mma_tf32_corrections(float (&d)[64], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                                     uint64_t bh, uint64_t bl) {
  mma_m64n128k8_tf32(d, lo, bh);
  mma_m64n128k8_tf32(d, hi, bl);
}

// An A operand of the fp32 path: `groups` 8-column groups (a multiple of
// 4: whole 32-deep panels) of a thread-private store.
struct Src32 {
  const float4* store;
  int groups;
};

// acc = sum over src of A @ B (with accumulate, acc += it), B the next
// slices of the stream (hi, lo per panel and half); the consumer
// warpgroup calls it. Each panel and half is one commit group into a fresh
// sum (corrections first), waited for and added to acc in rounded fp32
// before the next; its two stages are released then. Ends with every
// slice released.
template <int NH, int S>
__device__ __forceinline__ void gemm_tf32(float (&acc)[NH][64], const Src32* src, int n_src, const Ring<S>& ring,
                                          Cursor& cur, bool accumulate = false) {
  const int tid = threadIdx.x;
  const bool lead = (tid & 31) == 0;
  if (!accumulate)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  for (int o = 0; o < n_src; ++o)
    for (int kp = 0; kp < src[o].groups / 4; ++kp) {
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = src[o].store[(4 * kp + kk) * kConsumers32 + tid];
        const float a[4] = {v.x, v.z, v.y, v.w};  // the fragment: (r, c), (r + 8, c), (r, c + 1), (r + 8, c + 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hi[kk][j] = tf32_rna(a[j]);
          lo[kk][j] = tf32_rna(a[j] - __uint_as_float(hi[kk][j]));
        }
      }
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        int used[2];
        uint32_t b[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mbar_wait(ring.full(cur.stage), cur.phase);
          used[e] = cur.stage;
          b[e] = ring.data + cur.stage * kSliceBytes;
          if (++cur.stage == S) {
            cur.stage = 0;
            cur.phase ^= 1;
          }
        }
        // the panel's sums start afresh and join the layer's in rounded fp32
        float part[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) part[i] = 0.f;
        auto join = [](float sum, float p) { return __fadd_rn(sum, p); };
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_tf32_corrections(part, hi[kk], lo[kk], sw128_desc(b[0] + 32 * kk), sw128_desc(b[1] + 32 * kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_m64n128k8_tf32(part, hi[kk], sw128_desc(b[0] + 32 * kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        if (lead) {
          mbar_arrive(ring.empty(used[0]));
          mbar_arrive(ring.empty(used[1]));
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = join(acc[h][i], part[i]);
      }
    }
}

// acc <- activate(acc + bias), in fp32
template <int NH>
__device__ __forceinline__ void bias_act32(float (&acc)[NH][64], const float* __restrict__ bias, int act) {
  for_pairs<NH>([&](int, int col, int h, int i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    acc[h][i] = activate(acc[h][i] + b.x, act);
    acc[h][i + 1] = activate(acc[h][i + 1] + b.y, act);
  });
}

// acc into the thread's store, the next product's A operand
template <int NH>
__device__ __forceinline__ void store32(const float (&acc)[NH][64], float4* store) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store[(16 * h + j) * kConsumers32 + threadIdx.x] =
          make_float4(acc[h][4 * j], acc[h][4 * j + 1], acc[h][4 * j + 2], acc[h][4 * j + 3]);
}

// acc from the thread's store (store32's inverse)
template <int NH>
__device__ __forceinline__ void load32(float (&acc)[NH][64], const float4* store) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 v = store[(16 * h + j) * kConsumers32 + threadIdx.x];
      acc[h][4 * j] = v.x;
      acc[h][4 * j + 1] = v.y;
      acc[h][4 * j + 2] = v.z;
      acc[h][4 * j + 3] = v.w;
    }
}

// Shared memory of the fp32 NeRF passes, from a 1024-byte aligned base: the
// ring, the activation store (32 groups) and the PE store (12 groups).
template <int S>
struct Tiles32 {
  float4* x;
  float4* pe;
  Ring<S> ring;
  static constexpr int kBytes = Ring<S>::kBytes + (kXGroups32 + kPeGroups32) * kConsumers32 * 16;
};
template <int S>
__device__ __forceinline__ Tiles32<S> carve32(unsigned char* base) {
  Tiles32<S> t;
  t.ring.data = smem_u32(base);
  t.x = reinterpret_cast<float4*>(base + Ring<S>::kBytes);
  t.pe = t.x + kXGroups32 * kConsumers32;
  return t;
}

// The fp32 forward over one 64-row tile whose PE store is filled: sigma
// and, unless sigma_only, sigmoid(rgb) of the valid rows into sigma[row]
// and rgb[ch][row] (row within the 64), every sum and activation in fp32
// (nerf_mlp.cuh's fp32 MLP, on the tensor cores). Consumes
// forward_slices32() of the stream.
template <int S>
__device__ void nerf_forward(const NerfWeightsT<float>& w, const Tiles32<S>& t, Cursor& cur, int valid,
                             bool sigma_only, float* sigma, float* const* rgb) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  float acc[2][64];
  for (int i = 0; i < w.D; ++i) {
    const Src32 ops[2] = {{i == 0 ? t.pe : t.x, i == 0 ? 8 : kXGroups32}, {t.pe, 8}};
    gemm_tf32(acc, ops, (i > 0 && ((w.skip_mask >> i) & 1u)) ? 2 : 1, t.ring, cur);
    bias_act32(acc, w.tb[i], kRelu);
    if (i == w.D - 1) {  // sigma = h @ alpha_w + alpha_b
      float s[2];
      row_dots<2, 1>(acc, w.alpha_w, 0, s);
      if ((lane & 3) == 0)
        for (int hh = 0; hh < 2; ++hh)
          if (r0 + 8 * hh < valid) sigma[r0 + 8 * hh] = s[hh] + w.alpha_b[0];
      if (sigma_only) return;
    }
    store32(acc, t.x);
  }
  {
    const Src32 op = {t.x, kXGroups32};
    gemm_tf32(acc, &op, 1, t.ring, cur);
    bias_act32(acc, w.feat_b, kNone);
    store32(acc, t.x);
  }
  float accv[1][64];
  const Src32 opv[2] = {{t.x, kXGroups32}, {t.pe + (kPeViews / 8) * kConsumers32, 4}};
  gemm_tf32(accv, opv, 2, t.ring, cur);
  bias_act32(accv, w.views_b, kRelu);
  float s[6];
  row_dots<1, 3>(accv, w.rgb_w, kWv, s);
  if ((lane & 3) == 0)
    for (int ch = 0; ch < 3; ++ch)
      for (int hh = 0; hh < 2; ++hh)
        if (r0 + 8 * hh < valid) rgb[ch][r0 + 8 * hh] = 1.f / (1.f + expf(-(s[2 * ch + hh] + w.rgb_b[ch])));
}

// The fp32 MLP over rows [0, rows) of the plane z (row's ray: row / S), as
// nerf_mlp.cuh::nerf_rows: sigma[row] and, unless sigma_only, sigmoid(rgb)
// into rgb[0..2][row]. Each thread fills the PE it reads (accurate
// sinf/cosf, o + d*z and d/|d| rounded as the plain version), so no
// barrier is needed between tiles; the consumer warpgroup only. Ends
// without a barrier (the caller syncs).
template <int S>
__device__ void nerf_rows(const NerfWeightsT<float>& w, const Tiles32<S>& t, Cursor& cur, const float* ray,
                          const float* z, int rows, int Sr, bool sigma_only, float* sigma, float* const* rgb) {
  const int lane = threadIdx.x & 31, c = 2 * (lane & 3);
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8 of the tile
  for (int c0 = 0; c0 < rows; c0 += kRows32) {
    float u[2][3], v[2][3];  // each row's point and unit direction
    bool live[2];
    for (int hh = 0; hh < 2; ++hh) {
      const int row = c0 + r0 + 8 * hh;
      live[hh] = row < rows;
      if (!live[hh]) continue;
      const float* q = ray + 8 * (row / Sr);
      const float zr = z[row];
      for (int k = 0; k < 3; ++k) {
        u[hh][k] = __fadd_rn(q[k], __fmul_rn(q[3 + k], zr));  // no fused multiply-add
        v[hh][k] = __fdiv_rn(q[3 + k], q[6]);
      }
    }
    for (int g = 0; g < kPeGroups32; ++g) {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int hh = k >> 1, col = 8 * g + c + (k & 1);
        e[k] = 0.f;
        if (live[hh]) {
          if (col < kPtsCh) e[k] = embed(u[hh], col);
          else if (col >= kPeViews && col < kPeViews + kViewCh) e[k] = embed(v[hh], col - kPeViews);
        }
      }
      t.pe[g * kConsumers32 + threadIdx.x] = make_float4(e[0], e[1], e[2], e[3]);
    }
    float* rgb_c[3] = {nullptr, nullptr, nullptr};
    if (!sigma_only)
      for (int k = 0; k < 3; ++k) rgb_c[k] = rgb[k] + c0;
    nerf_forward(w, t, cur, rows - c0, sigma_only, sigma + c0, rgb_c);
  }
}

// ---- the DepthNet on the fp32 path (K1 in fp32, depth_net.cu)
//
// Per 64-row tile: three towers of n_layers layers with no activation, the
// origin and direction towers reading the embedding A, the intersection
// tower B (layer 0: emb @ te[0] + tb; layer l: emb @ te[l] + h @ th[l] + tb),
// then a LeakyReLU(0.01) trunk whose layer 0 reads [o | d | i | A | B] and
// the sigmoid head scaled to [near, far]. Shared memory holds one 64-row
// activation store (64 KB) and no room for the three tower outputs that
// trunk layer 0 reads, so each tower's share of it, out_t @ cat0[t], is
// added to a partial sum (a second store, 64 KB) as soon as the tower ends;
// trunk layer 0 then adds A @ cat0[3] and B @ cat0[4] to the partial, in
// the same chain of rounded fp32 panel joins (o, d, i, A, B: the plain
// version's order of the five products), and its bias. A and B are read
// from device memory in the thread-fragment order (fused_depth_net.
// fragment_tiles), each tile's 32 KB of them once per product.
//
// The slice stream of one tile (kernels/fused_depth_net.py::
// wgmma_depth_program): per tower, layer by layer, te[l] then th[l], then
// its cat0 operand; cat0's A and B operands; trunk layers 1..n_cat-1. At
// 256 wide and 128-wide embeddings, two (hi, lo) per 32-deep panel and
// 128-column half: a 128-deep product 16 slices, a 256-deep one 32.
constexpr int kEmbGroups32 = 16;  // 8-column groups of a 128-wide embedding
__host__ __device__ inline int depth_slices32(int n_layers, int n_cat) {
  return 3 * (16 + 48 * (n_layers - 1) + 32) + 32 + 32 * (n_cat - 1);
}

// Shared memory of the fp32 DepthNet, from a 1024-byte aligned base: the
// ring, the activation store and the trunk-layer-0 partial (32 groups each).
template <int S>
struct DepthTiles32 {
  float4* x;
  float4* part;
  Ring<S> ring;
  static constexpr int kBytes = Ring<S>::kBytes + 2 * kXGroups32 * kConsumers32 * 16;
};
template <int S>
__device__ __forceinline__ DepthTiles32<S> carve_depth32(unsigned char* base) {
  DepthTiles32<S> t;
  t.ring.data = smem_u32(base);
  t.x = reinterpret_cast<float4*>(base + Ring<S>::kBytes);
  t.part = t.x + kXGroups32 * kConsumers32;
  return t;
}

// The DepthNet's head over the last trunk layer's activations acc (64
// rows of one warpgroup): depth = near (1 - sg) + far sg, sg the sigmoid
// (accurate expf) of the fp32 dot with head_w plus head_b, into out[row]
// for rows [0, valid).
template <typename P>
__device__ __forceinline__ void depth_head(const P& p, const float (&acc)[2][64], int valid, float* out) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // rows r0, r0 + 8
  float s[2];
  row_dots<2, 1>(acc, p.head_w, 0, s);
  if ((lane & 3) == 0)
    for (int hh = 0; hh < 2; ++hh)
      if (r0 + 8 * hh < valid) {
        const float sg = 1.f / (1.f + expf(-(s[hh] + p.head_b[0])));
        out[r0 + 8 * hh] = p.near_ * (1.f - sg) + p.far_ * sg;
      }
}

// The DepthNet over one 64-row tile: depth of rows [0, valid) into out[row].
// a and b: the tile's embeddings in fragment order (16 groups each). P
// holds n_layers, n_cat, the fp32 biases tb[3][l] and cb[l], head_w [256],
// head_b [1], near_ and far_ (depth_net.cu's DepthNetParams<float>).
// Consumes depth_slices32() of the stream.
template <int S, typename P>
__device__ void depth_forward32(const P& p, const DepthTiles32<S>& t, Cursor& cur, const float4* a,
                                const float4* b, int valid, float* out) {
  const Src32 x = {t.x, kXGroups32};
  float acc[2][64];
  for (int tw = 0; tw < 3; ++tw) {
    const Src32 ops[2] = {{tw < 2 ? a : b, kEmbGroups32}, x};
    for (int l = 0; l < p.n_layers; ++l) {
      gemm_tf32(acc, ops, l > 0 ? 2 : 1, t.ring, cur);
      bias_act32(acc, p.tb[tw][l], kNone);
      store32(acc, t.x);
    }
    // the tower's share of trunk layer 0, added to the partial
    if (tw > 0) load32(acc, t.part);
    gemm_tf32(acc, &x, 1, t.ring, cur, tw > 0);
    store32(acc, t.part);
  }
  load32(acc, t.part);
  const Src32 emb[2] = {{a, kEmbGroups32}, {b, kEmbGroups32}};
  gemm_tf32(acc, emb, 2, t.ring, cur, true);
  bias_act32(acc, p.cb[0], kLeaky);
  for (int l = 1; l < p.n_cat; ++l) {
    store32(acc, t.x);
    gemm_tf32(acc, &x, 1, t.ring, cur);
    bias_act32(acc, p.cb[l], kLeaky);
  }
  depth_head(p, acc, valid, out);
}

// ---- the DepthNet on the bf16 path (K1 in bf16, depth_net.cu)
//
// depth_forward32's program with bf16 products (m64n128k16, both operands
// in shared memory) and the bf16 register epilogue (bias_act: the fp32
// bias, activate, a bf16 round, as the TPU kernel rounds each layer): the
// three towers layer by layer, each tower's share of trunk layer 0 summed
// onto an fp32 partial as the tower ends (the tensor cores accumulate onto
// it: gemm with accumulate), then A's and B's share and the bias, LeakyReLU
// and the trunk, and depth_head. The same block as the fp32 path: one
// consumer warpgroup on 64-row tiles and the producer warp (160 threads),
// a block walking tiles_per_block tiles, a 6-stage ring.
//
// Shared memory (the layout a 128-row tile of two warpgroups cannot have:
// its activations, A and B and the partial need 256 KB before any ring):
// the activation tile, 64 rows x 256 bf16 as 4 panels of 8 KB (32 KB); A
// and B, 64 x 128 bf16 each as 2 panels (32 KB), copied in from the rows
// of [N, 128] in device memory, swizzled, at the start of each tile; the
// fp32 partial in the fp32 path's thread-private store order (64 KB); the
// ring (96 KB + its barriers): 229,472 bytes, 230,496 with the 1024-byte
// alignment. Each staged slice feeds 64 rows: 440 slices (7.2 MB) a tile
// of the committed 10x256 net, 18 GB of L2 reads a 160,064-ray frame. Why
// one warpgroup and not two on one 64-row tile (each owning 128 output
// columns, the partial in registers): it is the fp32 path's block and
// stream as they are, with one release count per stage and no per-layer
// handshake between warpgroups; both read the same L2 bytes a frame.
//
// The slice stream of one tile (fused_depth_net.wgmma_depth_program, bf16
// slices 128 x 64): a 128-deep product 4 slices, a 256-deep one 8.
constexpr uint32_t kDepthPanel = kRows32 * 128;  // one 64-column panel of a 64-row bf16 tile
constexpr int kEmb = 8 * kEmbGroups32;           // the width of A and B
__host__ __device__ inline int depth_slices16(int n_layers, int n_cat) {
  return 3 * (4 + 12 * (n_layers - 1) + 8) + 8 + 8 * (n_cat - 1);
}

// Shared memory of the bf16 DepthNet, from a 1024-byte aligned base: the
// activation tile, A, B, the trunk-layer-0 partial and the ring.
template <int S>
struct DepthTiles {
  unsigned char* x;
  unsigned char* a;
  unsigned char* b;
  float4* part;
  Ring<S> ring;
  static constexpr int kBytes = 8 * kDepthPanel + kXGroups32 * kConsumers32 * 16 + Ring<S>::kBytes;
};
template <int S>
__device__ __forceinline__ DepthTiles<S> carve_depth(unsigned char* base) {
  DepthTiles<S> t;
  t.x = base;
  t.a = base + 4 * kDepthPanel;
  t.b = base + 6 * kDepthPanel;
  t.part = reinterpret_cast<float4*>(base + 8 * kDepthPanel);
  t.ring.data = smem_u32(base + 8 * kDepthPanel + kXGroups32 * kConsumers32 * 16);
  return t;
}

// Rows [0, valid) of a row-major [., 128] bf16 plane into a swizzled 64-row
// tile, zero past them, 16 bytes a thread and step.
__device__ __forceinline__ void load_emb(const bf16* __restrict__ src, int valid, unsigned char* tile) {
  for (int e = threadIdx.x; e < kRows32 * (kEmb / 8); e += kConsumers32) {
    const int r = e / (kEmb / 8), c = (e % (kEmb / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = __ldg(reinterpret_cast<const uint4*>(src + (long long)r * kEmb + c));
    *reinterpret_cast<uint4*>(tile + tile_offset(r, c, kDepthPanel)) = v;
  }
}

// The bf16 DepthNet over one 64-row tile: depth of rows [0, valid) into
// out[row]. a and b: the tile's first rows of A and B ([N, 128] bf16). P:
// depth_net.cu's DepthNetParams<bf16>. Consumes depth_slices16() of the
// stream.
template <int S, typename P>
__device__ void depth_forward(const P& p, const DepthTiles<S>& t, Cursor& cur, const bf16* a, const bf16* b,
                              int valid, float* out) {
  group_sync();  // the previous tile's products read A and B no more
  load_emb(a, valid, t.a);
  load_emb(b, valid, t.b);
  fence_async_smem();
  group_sync();
  const Src x = {smem_u32(t.x), 4, kDepthPanel};
  const Src emb[2] = {{smem_u32(t.a), 2, kDepthPanel}, {smem_u32(t.b), 2, kDepthPanel}};
  float acc[2][64];
  for (int tw = 0; tw < 3; ++tw) {
    const Src ops[2] = {emb[tw < 2 ? 0 : 1], x};
    for (int l = 0; l < p.n_layers; ++l) {
      gemm(acc, ops, l > 0 ? 2 : 1, t.ring, cur);
      bias_act(acc, p.tb[tw][l], kNone);
      group_sync();  // the warpgroup's products read x no more
      store_tile<2, kDepthPanel>(acc, t.x);
    }
    // the tower's share of trunk layer 0, summed onto the partial
    if (tw > 0) load32(acc, t.part);
    gemm(acc, &x, 1, t.ring, cur, tw > 0);
    store32(acc, t.part);
  }
  load32(acc, t.part);
  gemm(acc, emb, 2, t.ring, cur, true);
  bias_act(acc, p.cb[0], kLeaky);
  for (int l = 1; l < p.n_cat; ++l) {
    group_sync();
    store_tile<2, kDepthPanel>(acc, t.x);
    gemm(acc, &x, 1, t.ring, cur);
    bias_act(acc, p.cb[l], kLeaky);
  }
  depth_head(p, acc, valid, out);
}

// ---- the render kernels' paths (render_hier.cu, render_around_depth.cu)

// A render kernel's element type T picks its path of the core: bf16 and
// int8 with 288 threads (two consumer warpgroups), 128-row tiles and a ring
// of kRenderStages slices; fp32 with 160 threads (one consumer warpgroup),
// 64-row tiles and a ring of kStages32. The tiles start at the first
// 1024-byte boundary of shared memory.
constexpr int kRenderStages = 5;
template <typename T>
constexpr bool kCore32 = std::is_same_v<T, float>;
// the threads that do the kernel's work: the consumers
template <typename T>
constexpr int kWorkers = kCore32<T> ? kConsumers32 : kConsumers;
template <typename T>
constexpr int kBlockThreads = kCore32<T> ? kThreads32 : kThreads;
template <typename T>
constexpr int kTileRows = kCore32<T> ? kRows32 : kRows;
template <typename T>
using RenderTiles = std::conditional_t<kCore32<T>, Tiles32<kStages32>, Tiles<kRenderStages>>;
// the MLP's shared memory, ahead of the kernel's own planes (+ the 1024-byte alignment)
template <typename T>
__host__ __device__ constexpr size_t mlp_bytes() {
  return 1024 + RenderTiles<T>::kBytes;
}
// The core's tiles from the first 1024-byte boundary of smem, the ring's
// barriers initialized (by thread 0; the caller syncs the block)
template <typename T>
__device__ __forceinline__ RenderTiles<T> carve_render(unsigned char* smem) {
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  RenderTiles<T> t;
  if constexpr (kCore32<T>) {
    t = carve32<kStages32>(base);
    if (threadIdx.x == 0) t.ring.init(kConsumers32 / 32);
  } else {
    t = carve<kRenderStages>(base);
    if (threadIdx.x == 0) t.ring.init();
  }
  return t;
}

}  // namespace wg
}  // namespace nst
