"""K2, K3, K8 and K9: populate-and-shade as a hand-written CUDA kernel, with plain versions.

Replaces nerf_sampling_tpu/kernels/fused_render.py::_call in four of its
z sources, all modes of one kernel source, ``csrc/render_around_depth.cu``.
For every ray it shades a population of depths with the NeRF MLP and
composites the samples in order over a white background:

- uniform (K2, ``fused_render_around_depth``): z = clip(depth + offsets,
  near, far), already sorted;
- gaussian (K3, ``fused_render_gaussian``): depth + std * N(0, 1) for S-1
  samples plus the depth itself, no clip, sorted per ray before shading.
  The draws come from Philox keyed by (seed, global ray index: a launch's
  row r is global ray ``ray_base + r``) (``philox.gaussian_noise``) or are
  injected;
- linspace (K8, ``fused_render``): the eval grid at perturb 0 between near
  and far (or linear in disparity), the same for every ray, with the TPU
  kernel's rounding (``linspace_grid``); FULL_NERF without fine samples;
- input (K9, ``fused_shade``): the caller's z [N, S], taken as sorted or
  sorted per ray first (stable, NaN last); the COMPARE mode's shading.

K2 and K3 run bf16; K8 and K9 run bf16 or fp32 (``dtype``: the COMPARE
mode runs fp32 kernels). All four also run int8 (W8A8, K10): given a
``quant.qpack_nerf`` pack instead of a ``pack_nerf`` one, the kernel's MLP is
the int8 tensor-core chain of ``kernels/quant.py`` (the int8 eval renders of
``mlp_impl="cuda_int8"``), and the plain versions run ``quant.mlp_plain_q``.

``pack_nerf`` lays the NeRF's weights out as [in, out] matrices over one
positional-encoding row of 96 columns: the 63 point-embedding columns
(padded to 64) and the 27 view-embedding columns (padded to 32), so each
concatenation of the reference is one more zero-padded operand of the same
sum. ``render_around_depth_plain``, ``render_gaussian_plain``,
``render_linspace_plain`` and ``shade_plain`` compute the same things in
plain PyTorch: fp32 is the reference, bf16 rounds where the kernel rounds.

``wgmma_slices`` lays the same matrices out for the wgmma core that K2-K9
run in bf16 (``csrc/mlp_wgmma.cuh``): the byte image of the shared-memory
weight slices, in the order a tile consumes them (``wgmma_program``);
``wgmma_qslices`` does the same for an int8 pack's forward
(``wgmma_qprogram``: bf16 and int8 slices in one stream), which K2, K3 and
K6-K9 run in int8, and ``wgmma_slices32`` for an fp32 pack's (the hi and
lo tf32 images of every slice, ``tf32_split``, each 8-deep k group
permuted), which K7, K8 and K9 run in fp32 with 3xTF32 products.
``pack_slices`` makes a pack's slices once and keeps them in it. The
slice image is the only device copy of a pack's matrices: ``pack_args``
turns a pack into what every NeRF launch passes (K2-K9, K11), its checked
slices, the vectors the epilogues read (``epilogue_vectors``), the int8
plan and the skip mask.
``wgmma_dense``, ``wgmma_dense_q`` and ``wgmma_dense32`` are one dense
layer on that core, bf16, s8 and fp32, the first check of
``chip_smoke.py``; ``pe_fill_check`` holds the render kernels' PE fill to
the per-column formula it replaced, in the same check.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerf_sampling_tpu_torch.core.compositing import raw2outputs
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import build, philox, quant
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.utils.precision import strict_fp32

MAX_SAMPLES = 512
PTS_ROWS, VIEW_ROWS = 64, 32  # padded embedding widths of the kernel's PE row
KERNEL_WIDTH = 256  # NeRF width the CUDA kernel is built for


def uniform_population_offsets(n_samples: int, std: float) -> np.ndarray:
    """sorted(linspace(-std, std, n-1) U {0}) as float32 [n] (reference
    sample_points_around_mean "uniform", before the [2, 6] clip)."""
    if n_samples < 2:
        return np.zeros((1,), np.float32)
    grid = np.linspace(-std, std, n_samples - 1)
    return np.sort(np.concatenate([grid, [0.0]])).astype(np.float32)


def pack_nerf(model: NeRF, dtype=torch.bfloat16) -> dict:
    """Repack a viewdirs NeRF's weights as [in, out] matrices for the kernel."""
    cfg = model.cfg
    if not cfg.use_viewdirs:
        raise ValueError("the fused render needs use_viewdirs=True")
    Cp, Cv, W = cfg.input_ch, cfg.input_ch_views, cfg.W
    if Cp > PTS_ROWS or Cv > VIEW_ROWS:
        raise ValueError("embedding widths exceed the kernel's PE row")

    def T(lin) -> torch.Tensor:
        return lin.weight.detach().float().T

    def b(lin) -> torch.Tensor:
        return lin.bias.detach().float().contiguous()

    def cast(w: torch.Tensor) -> torch.Tensor:
        return w.to(dtype).contiguous()

    def pad(w: torch.Tensor, rows: int) -> torch.Tensor:
        out = torch.zeros((rows, w.shape[1]), device=w.device)
        out[: w.shape[0]] = w
        return cast(out)

    pts = model.pts_linears
    trunk_w, skip_w = [], {}
    for i in range(1, cfg.D):
        w = T(pts[i])
        if (i - 1) in cfg.skips:  # cat([input_pts, h]) @ W
            skip_w[i] = pad(w[:Cp], PTS_ROWS)
            w = w[Cp:]
        trunk_w.append(cast(w))
    vw = T(model.views_linears[0])  # rows [feature(W) | views emb(Cv)]
    return {
        "w0": pad(T(pts[0]), PTS_ROWS),
        "trunk_w": trunk_w,  # layers 1..D-1
        "trunk_b": [b(lin) for lin in pts],
        "skip_w": skip_w,
        "feature_w": cast(T(model.feature_linear)),
        "feature_b": b(model.feature_linear),
        "alpha_w": cast(T(model.alpha_linear)[:, 0]),
        "alpha_b": b(model.alpha_linear),
        "views_wf": cast(vw[:W]),
        "views_ws": pad(vw[W:], VIEW_ROWS),
        "views_b": b(model.views_linears[0]),
        "rgb_w": cast(model.rgb_linear.weight.detach().float()),  # [3, W/2]
        "rgb_b": b(model.rgb_linear),
    }


WG_SLICE_N, WG_SLICE_K = 128, 64  # a weight slice of the wgmma core: 128 output columns x 64 of depth
WG_SLICE_BYTES = WG_SLICE_N * WG_SLICE_K * 2  # 16 KB; an int8 slice: 128 output columns x 128 of depth
# the byte gather index of each slice program (``_program_index``): int32 on
# the host for every program made so far, and on the device for those whose
# slices are made again with every new pack of live weights (the nerf steps'
# K4/K5 packs, inside captured steps too, so the index must outlive the graphs)
_wg_index_cache: dict = {}
_wg_device_index: dict = {}


def wgmma_program(packed: dict, *, sigma_only: bool = False, backward: bool = False,
                  want_dx: bool = False) -> list[tuple[torch.Tensor, bool]]:
    """The matrices a 128-row tile of ``csrc/mlp_wgmma.cuh`` multiplies by,
    in the order it consumes their slices: (W, transposed) for each product
    x @ W, or x @ W^T when transposed, of a ``pack_nerf`` pack (bf16).

    The forward (K6/K7's passes, K5's recompute): w0, each trunk matrix and
    its skip rows, then unless ``sigma_only`` feature_w, views_wf and
    views_ws. ``backward`` appends K5's d_h chain: (with ``want_dx``
    views_ws^T,) views_wf^T, feature_w^T and the trunk matrices^T down the
    layers, each followed with ``want_dx`` by skip_w^T at a skip layer and
    w0^T at layer 0. Counts: ``mlp_wgmma.cuh::forward_slices`` and
    ``backward_slices``."""
    D = len(packed["trunk_b"])
    prog = [(packed["w0"], False)]
    for i in range(1, D):
        prog.append((packed["trunk_w"][i - 1], False))
        if i in packed["skip_w"]:
            prog.append((packed["skip_w"][i], False))
    if sigma_only:
        return prog
    prog += [(packed["feature_w"], False), (packed["views_wf"], False), (packed["views_ws"], False)]
    if not backward:
        return prog
    if want_dx:
        prog.append((packed["views_ws"], True))
    prog.append((packed["views_wf"], True))
    for i in range(D - 1, -1, -1):
        prog.append((packed["feature_w"] if i == D - 1 else packed["trunk_w"][i], True))
        if want_dx and (i == 0 or i in packed["skip_w"]):
            prog.append((packed["w0"] if i == 0 else packed["skip_w"][i], True))
    return prog


def wgmma_qprogram(qpacked: dict, sigma_only: bool = False) -> list[tuple[torch.Tensor, bool, int | None]]:
    """The int8 forward of ``csrc/mlp_wgmma.cuh`` (K6/K7 in int8) over a
    ``quant.qpack_nerf`` pack: (W, transposed, half) for each product in
    the order a 128-row tile consumes its slices, half None for all of the
    product's output columns or 0/1 for one 128-column half. The bf16 w0
    (x @ W); each trunk layer's int8 [out, in] matrix (x @ W^T), or at a
    skip layer, per half, the int8 matrix's half then skip_w's half; then
    unless ``sigma_only`` feature_wq, views_wq and the bf16 views_ws. Count:
    ``mlp_wgmma.cuh::forward_qslices``."""
    prog = [(qpacked["w0"], False, None)]
    for i, wq in enumerate(qpacked["trunk_wq"], start=1):
        if i in qpacked["skip_w"]:
            for h in (0, 1):
                prog += [(wq, True, h), (qpacked["skip_w"][i], False, h)]
        else:
            prog.append((wq, True, None))
    if sigma_only:
        return prog
    return prog + [(qpacked["feature_wq"], True, None), (qpacked["views_wq"], True, None),
                   (qpacked["views_ws"], False, None)]


TF32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)  # depth s of an fp32 slice's 8-deep k group holds row TF32_PERM[s] of it


def _slice_index(rows: int, cols: int, transposed: bool, half: int | None, size: int) -> np.ndarray:
    """For each element of one product's slices, in byte order, its
    position in the row-major [rows, cols] matrix (rows * cols where the
    slice pads with zero). B = W, or W^T when transposed, is [K, N]; its
    slice (kp, h) holds B[Ks kp + k, 128 h + n] at n Ks + ((k // E) ^ (n %
    8)) E + k % E, E = 16 // size elements to the 16-byte chunk (8 bf16, 16
    int8, 4 fp32) and Ks = 8 E of depth: the 128-byte swizzled K-major
    tile. fp32 slices hold, at depth k, B's row 8 (k // 8) + TF32_PERM[k %
    8] of the panel (``csrc/mlp_wgmma.cuh``'s fp32 path: a layer's
    accumulator fragment is the next layer's A fragment). k panels outer,
    128-column halves inner (only ``half`` where given)."""
    E = 16 // size
    Ks = 8 * E
    n = np.arange(WG_SLICE_N)[:, None]
    k = np.arange(Ks)[None, :]
    pos = (n * Ks + ((k // E) ^ (n % 8)) * E + k % E).reshape(-1)  # the 128-byte swizzle
    depth = 8 * (k // 8) + np.asarray(TF32_PERM)[k % 8] if size == 4 else k
    K, N = (cols, rows) if transposed else (rows, cols)
    halves = range(-(-N // WG_SLICE_N)) if half is None else (half,)
    parts = []
    for kp in range(-(-K // Ks)):
        for h in halves:
            kk, nn = kp * Ks + depth, h * WG_SLICE_N + n  # B[kk, nn]
            src = nn * cols + kk if transposed else kk * cols + nn
            sl = np.empty(WG_SLICE_N * Ks, np.int64)
            sl[pos] = np.where((kk < K) & (nn < N), src, rows * cols).reshape(-1)
            parts.append(sl)
    return np.concatenate(parts)


def _program_index(key: tuple, device: torch.device, keep: bool = True) -> torch.Tensor:
    """Byte gather index of a program's slices (int32): for each byte of the
    image, in order, its position in the bytes of the matrices laid end to
    end (one past them, a zero byte, where a slice pads). ``key`` holds
    (rows, cols, transposed, half, element size) of each product. Built
    once on the host; kept on ``device`` too unless ``keep`` is False, when
    the caller's gather takes a copy that goes with it (the DepthNet's
    programs: one image a pack, made once an eval, whose 27.5 MiB index
    would otherwise sit on the card for the whole run)."""
    if key not in _wg_index_cache:
        zero = sum(r * c * size for r, c, _, _, size in key)
        if zero >= 2**31:
            raise ValueError(f"a slice program of {zero} bytes overflows the int32 gather index")
        parts, off = [], 0
        for rows, cols, transposed, half, size in key:
            idx = _slice_index(rows, cols, transposed, half, size)[:, None]
            parts.append(np.where(idx == rows * cols, zero, off + idx * size + np.arange(size)).reshape(-1))
            off += rows * cols * size
        _wg_index_cache[key] = np.concatenate(parts).astype(np.int32)
    if not keep:
        return torch.from_numpy(_wg_index_cache[key]).to(device)
    if (key, str(device)) not in _wg_device_index:
        _wg_device_index[(key, str(device))] = torch.from_numpy(_wg_index_cache[key]).to(device)
    return _wg_device_index[(key, str(device))]


def _slice_image(program: list[tuple[torch.Tensor, bool, int | None]], keep_index: bool = True) -> torch.Tensor:
    """The byte image [n_slices, 16384] uint8 of a program's slices (see
    ``wgmma_qslices``), any element size; ``keep_index``: ``_program_index``'s
    ``keep``."""
    key = tuple((w.shape[0], w.shape[1], bool(t), h, w.element_size()) for w, t, h in program)
    flat = torch.cat([w.reshape(-1).view(torch.uint8) for w, _, _ in program]
                     + [program[0][0].new_zeros(1, dtype=torch.uint8)])
    return flat[_program_index(key, flat.device, keep_index)].view(-1, WG_SLICE_BYTES)


def wgmma_qslices(program: list[tuple[torch.Tensor, bool, int | None]], keep_index: bool = True) -> torch.Tensor:
    """The byte image of a program's weight slices, [n_slices, 16384] uint8,
    for a product x @ B of each (W, transposed, half) (B = W, or W^T when
    transposed; [K, N]), slice after slice in the order a tile consumes
    them: k panels outer, 128-column halves inner (only ``half`` where one
    is given), product after product. A bf16 slice holds B[64 kp + k,
    128 h + n] at element n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8, an int8
    slice B[128 kp + k, 128 h + n] at byte n * 128 + ((k // 16) ^ (n % 8)) *
    16 + k % 16, zero past K or N: the 128-byte swizzled K-major tile that
    wgmma's shared-memory descriptor reads. The kernels' producer warp moves
    each slice as one bulk copy. ``keep_index`` False lets the gather index
    go once the image is made (``_program_index``)."""
    for w, _, _ in program:
        if w.dim() != 2 or w.dtype not in (torch.bfloat16, torch.int8):
            raise TypeError("the wgmma core takes bf16 and int8 matrices")
    return _slice_image(program, keep_index)


def wgmma_slices(program: list[tuple[torch.Tensor, bool]], keep_index: bool = True) -> torch.Tensor:
    """``wgmma_qslices`` of a bf16 program (``wgmma_program``: every product
    whole) as [n_slices, 128 * 64] bf16."""
    for w, _ in program:
        if w.dtype != torch.bfloat16:
            raise TypeError("the wgmma core takes bf16 matrices")
    return wgmma_qslices([(w, t, None) for w, t in program], keep_index).view(torch.bfloat16)


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an fp32 tensor: hi = tf32(w) and lo = tf32(w - hi), each
    rounded to the nearest tf32 (10 mantissa bits), ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds; w - hi - lo is within 2^-22 |w|."""
    def rna(x: torch.Tensor) -> torch.Tensor:
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(w.float())
    return hi, rna(w.float() - hi)


def wgmma_slices32(program: list[tuple[torch.Tensor, bool]], keep_index: bool = True) -> torch.Tensor:
    """The fp32 path's slices of a program of fp32 matrices
    (``wgmma_program`` of a ``pack_nerf(..., torch.float32)`` pack), as
    [n_slices, 128 * 32] fp32: for each 32-deep k panel and 128-column half
    of each product (k panels outer, halves inner) the hi slice, then the lo
    slice (``tf32_split``). A slice holds B[32 kp + 8 g + TF32_PERM[s], 128 h
    + n] (depth k = 8 g + s) at element n * 32 + ((k // 4) ^ (n % 8)) * 4 +
    k % 4, zero past K or N. Count: ``mlp_wgmma.cuh::forward_slices32``."""
    for w, _ in program:
        if w.dim() != 2 or w.dtype != torch.float32:
            raise TypeError("the fp32 path takes fp32 matrices")
    splits = [tf32_split(w) for w, _ in program]
    hi = _slice_image([(h, t, None) for (h, _), (_, t) in zip(splits, program)], keep_index)
    lo = _slice_image([(lo, t, None) for (_, lo), (_, t) in zip(splits, program)], keep_index)
    return torch.stack([hi, lo], 1).reshape(-1, WG_SLICE_BYTES).view(torch.float32)


def pack_slices(packed: dict, sigma_only: bool = False) -> torch.Tensor:
    """The wgmma core's forward weight slices of a pack: for a bf16
    ``pack_nerf`` pack ``wgmma_slices(wgmma_program(packed, sigma_only=...))``,
    for an fp32 one ``wgmma_slices32`` of that program, for an int8
    ``quant.qpack_nerf`` pack ``wgmma_qslices(wgmma_qprogram(packed,
    sigma_only))``; the full forward (K2, K3, K8, K9, K4 and K5's recompute,
    K6/K7's fine pass) or the trunk and alpha head (K6/K7's coarse pass).
    Made on first use and kept in the pack under the program they hold, so
    one pack can serve both programs; a pack is made anew for new weights
    (``render.pack_kernel_weights``, and every nerf step's), so its slices
    are always its own weights'."""
    cache = packed.setdefault("wg_slices", {})
    key = "sigma_only" if sigma_only else "full"
    if key not in cache:
        if quant.is_int8(packed):
            cache[key] = wgmma_qslices(wgmma_qprogram(packed, sigma_only=sigma_only))
        elif packed["w0"].dtype == torch.float32:
            cache[key] = wgmma_slices32(wgmma_program(packed, sigma_only=sigma_only))
        else:
            cache[key] = wgmma_slices(wgmma_program(packed, sigma_only=sigma_only))
    return cache[key]


def check_slices(slices: torch.Tensor, packed: dict, sigma_only: bool = False) -> None:
    """Raise ValueError unless ``slices`` is the image ``pack_slices(packed,
    sigma_only)`` makes: its element type and its count of 16 KB slices
    (the kernels read as many as their header's forward_slices,
    forward_qslices or forward_slices32 say, blind)."""
    if quant.is_int8(packed):
        prog, dtype = wgmma_qprogram(packed, sigma_only=sigma_only), torch.uint8
    else:
        prog = [(w, t, None) for w, t in wgmma_program(packed, sigma_only=sigma_only)]
        dtype = packed["w0"].dtype
    n = 0
    for w, t, h in prog:
        K, N = (w.shape[1], w.shape[0]) if t else tuple(w.shape)
        depth = WG_SLICE_BYTES // (WG_SLICE_N * w.element_size())  # 128 int8, 64 bf16, 32 fp32 (hi and lo)
        n += -(-K // depth) * (1 if h is not None else -(-N // WG_SLICE_N)) * (2 if w.element_size() == 4 else 1)
    shape = (n, WG_SLICE_BYTES // torch.empty(0, dtype=dtype).element_size())
    if slices is None or slices.dtype != dtype or tuple(slices.shape) != shape or not slices.is_contiguous():
        got = None if slices is None else (slices.dtype, tuple(slices.shape))
        raise ValueError(f"the weight slices must be the pack's {'sigma-only' if sigma_only else 'full'} forward "
                         f"(fused_render.pack_slices): {dtype} {shape}, got {got}")


def wgmma_dense(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, a2: torch.Tensor | None = None,
                w2: torch.Tensor | None = None, act: int = 1) -> torch.Tensor:
    """One dense layer on the wgmma core (``csrc/wg_dense.cu``):
    act(a @ w + a2 @ w2 + bias) as bf16, fp32 sums; a [M, K] and w [K, N]
    bf16 with K in {64, 128, 192, 256} and N in {128, 256}, a2 [M, 64] and
    w2 [64, N] optional, act 0 none, 1 relu, 2 leaky. On a CPU tensor this
    runs the plain version (fp32 products of the bf16 operands)."""
    if (a2 is None) != (w2 is None):
        raise ValueError("give a2 and w2 together")
    if a.device.type == "cpu":
        z = a.float() @ w.float() + bias
        if a2 is not None:
            z = z + a2.float() @ w2.float()
        z = torch.relu(z) if act == 1 else (torch.nn.functional.leaky_relu(z, 0.01) if act == 2 else z)
        return z.to(torch.bfloat16)
    M, K = a.shape
    N = w.shape[1]
    if K not in (64, 128, 192, 256) or N not in (128, 256) or tuple(w.shape) != (K, N):
        raise ValueError("wgmma_dense takes a [M, K] @ w [K, N], K in {64..256} by 64, N in {128, 256}")
    prog = [(w, False)] + ([(w2, False)] if w2 is not None else [])
    slices = wgmma_slices(prog)
    a, bias = a.contiguous(), bias.contiguous()
    a2 = None if a2 is None else a2.contiguous()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    build.launch("nst_wg_dense", "bf16", "nst_wg_dense", [a, a2, slices, bias, out], M, K, N, int(act))
    return out


def wgmma_dense_q(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """One s8 layer on the wgmma core (``csrc/wg_dense.cu``): the int32
    sums a @ wq^T of a [M, K] and wq [N, K] int8 ([out, in], as
    ``quant.qpack_nerf``'s matrices), K and N in {128, 256}. On a CPU tensor
    this runs the plain version (an int64 matmul)."""
    if a.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("wgmma_dense_q takes int8 operands")
    if a.device.type == "cpu":
        return (a.long() @ wq.long().T).int()
    M, K = a.shape
    N = wq.shape[0]
    if K not in (128, 256) or N not in (128, 256) or tuple(wq.shape) != (N, K):
        raise ValueError("wgmma_dense_q takes a [M, K] and wq [N, K], K and N in {128, 256}")
    slices = wgmma_qslices([(wq, True, None)])
    a = a.contiguous()
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    build.launch("nst_wg_dense_q", "int8", "nst_wg_dense_q", [a, slices, out], M, K, N)
    return out


def wgmma_dense32(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *, act: int = 0) -> torch.Tensor:
    """One fp32 layer on the wgmma core (``csrc/wg_dense.cu``): act(a @ w +
    bias) in fp32, the products 3xTF32 (``wgmma_slices32``), the sums fp32;
    a [M, K] and w [K, N] fp32 with K in {32, 64, ..., 256} and N in {128,
    256}, act 0 none, 1 relu, 2 leaky. On a CPU tensor this runs the plain
    version (an fp32 matmul)."""
    if a.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("wgmma_dense32 takes fp32 operands")
    if a.device.type == "cpu":
        strict_fp32()
        z = a @ w + bias
        return torch.relu(z) if act == 1 else (torch.nn.functional.leaky_relu(z, 0.01) if act == 2 else z)
    M, K = a.shape
    N = w.shape[1]
    if K % 32 or not 32 <= K <= 256 or N not in (128, 256) or tuple(w.shape) != (K, N):
        raise ValueError("wgmma_dense32 takes a [M, K] @ w [K, N], K in {32..256} by 32, N in {128, 256}")
    slices = wgmma_slices32([(w, False)])
    a, bias = a.contiguous(), bias.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    build.launch("nst_wg_dense32", "fp32", "nst_wg_dense32", [a, slices, bias, out], M, K, N, int(act))
    return out


def pe_fill_check(rays_o: torch.Tensor, rays_d: torch.Tensor, z: torch.Tensor, R: int, *,
                  sigma_only: bool = False, multires: int = 10,
                  multires_views: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """The render kernels' PE tiles (``csrc/wg_dense.cu::nst_pe_fill_check``)
    of N rays [N, 3] at depths z [N, S], R rays a block as a render launch
    lays them out: (the fill of ``csrc/mlp_wgmma.cuh``, the per-column
    formula it replaced), each bf16 [ceil(N / R) * tiles * 128, 128] with
    tiles = ceil(R S / 128): block b's tile t at rows (b tiles + t) * 128,
    row s of ray i (i = b R + j) at j S + s within its block, columns
    [point embedding 63 | 0 | view embedding 27 | 0 x 37], rows past a
    block's rays zero. With ``sigma_only`` the fill leaves the view panel
    (columns 64-127) as 0xFF bytes. On CPU tensors both are the plain
    embedding (``positional_encoding`` in fp32, rounded to bf16)."""
    n, S = z.shape
    check_rays(rays_o, rays_d, z=(z, (n, S)))
    if not (1 <= R <= 64 and R * S <= 1536):
        raise ValueError(f"R must be in [1, 64] with R * S <= 1536, got R {R} at S {S}")
    tiles = -(-R * S // 128)
    blocks = -(-n // R)
    if rays_o.device.type == "cpu":
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        Cp, Cv = 3 * (1 + 2 * multires), 3 * (1 + 2 * multires_views)
        rows = torch.zeros((n * S, 128))
        rows[:, :Cp] = positional_encoding(pts, multires).reshape(n * S, Cp)
        rows[:, PTS_ROWS:PTS_ROWS + Cv] = positional_encoding(vd, multires_views)[:, None, :].expand(
            n, S, Cv).reshape(n * S, Cv)
        # ray i's rows into its block's tiles, the rest zero
        out = torch.zeros((blocks, tiles * 128, 128))
        per_block = torch.nn.functional.pad(rows, (0, 0, 0, (blocks * R - n) * S)).reshape(blocks, R * S, 128)
        out[:, :R * S] = per_block
        fill = out.reshape(-1, 128).to(torch.bfloat16)
        if sigma_only:
            fill[:, PTS_ROWS:] = torch.tensor(-1, dtype=torch.int16).view(torch.bfloat16)
        return fill, out.reshape(-1, 128).to(torch.bfloat16)
    if (multires, multires_views) != (10, 4):
        raise ValueError("the CUDA kernels are built for multires 10 and multires_views 4")
    rays_o, rays_d, z = rays_o.contiguous(), rays_d.contiguous(), z.contiguous()
    out = torch.empty((2, blocks * tiles * 128, 128), dtype=torch.bfloat16, device=z.device)
    build.launch("nst_pe_fill_check", "bf16", "nst_pe_fill_check", [rays_o, rays_d, z, out], n, S, R,
                 int(bool(sigma_only)))
    return out[0], out[1]


class MlpActs(NamedTuple):
    """The activations of ``mlp_plain`` that the backward reads (as fp32
    tensors holding the kernels' bf16 values)."""

    h: list  # trunk layers 0..D-1, [M, W] each
    feature: torch.Tensor | None  # [M, W]
    zv: torch.Tensor | None  # the views layer before its ReLU, fp32 [M, W/2]
    hv: torch.Tensor | None  # [M, W/2]


def mlp_plain(
    packed: dict,
    cfg: NeRFConfig,
    x_pts: torch.Tensor,
    x_v: torch.Tensor | None,
    dtype=torch.bfloat16,
    sigma_only: bool = False,
) -> tuple[torch.Tensor, MlpActs]:
    """The kernels' NeRF MLP on rounded embeddings [M, Cp] and [M, Cv], in
    plain PyTorch: (raw [M, 4] (rgb logits, sigma), or sigma [M] with
    ``sigma_only``; the activations). Every activation is rounded to
    ``dtype`` where the kernels round it; sums are fp32."""
    strict_fp32()
    f32 = torch.float32
    Cp, Cv = cfg.input_ch, cfg.input_ch_views

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(f32)

    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(f32)

    h = rnd(torch.relu(mm(x_pts, packed["w0"][:Cp]) + packed["trunk_b"][0]))
    hs = [h]
    for i in range(1, cfg.D):
        zi = mm(h, packed["trunk_w"][i - 1])
        if i in packed["skip_w"]:
            zi = zi + mm(x_pts, packed["skip_w"][i][:Cp])
        h = rnd(torch.relu(zi + packed["trunk_b"][i]))
        hs.append(h)
    sigma = mm(h, packed["alpha_w"][:, None]) + packed["alpha_b"]
    if sigma_only:
        return sigma[:, 0], MlpActs(hs, None, None, None)
    feature = rnd(mm(h, packed["feature_w"]) + packed["feature_b"])
    zv = mm(feature, packed["views_wf"]) + mm(x_v, packed["views_ws"][:Cv]) + packed["views_b"]
    hv = rnd(torch.relu(zv))
    rgb_logits = mm(hv, packed["rgb_w"].T) + packed["rgb_b"]
    return torch.cat([rgb_logits, sigma], -1), MlpActs(hs, feature, zv, hv)


def nerf_raw_plain(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z: torch.Tensor,
    *,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
    sigma_only: bool = False,
) -> torch.Tensor:
    """The kernels' NeRF MLP over the points o + z*d of [N, S] depths, in
    plain PyTorch: raw [N, S, 4] (sigmoid not applied), or sigma [N, S] with
    ``sigma_only`` (trunk and alpha head only, as K6's coarse pass). An int8
    pack (``quant.qpack_nerf``) runs ``quant.mlp_plain_q`` on the bf16
    embeddings, whatever ``dtype`` says."""
    Cp, Cv = cfg.input_ch, cfg.input_ch_views
    int8 = quant.is_int8(packed)
    if int8:
        dtype = torch.bfloat16

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(torch.float32)

    n, S = z.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    x_pts = rnd(positional_encoding(pts, multires)).reshape(n * S, Cp)
    x_v = None
    if not sigma_only:
        vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        x_v = rnd(positional_encoding(vd, multires_views))[:, None, :].expand(n, S, Cv).reshape(n * S, Cv)
    if int8:
        out = quant.mlp_plain_q(packed, cfg, x_pts, x_v, sigma_only)
    else:
        out, _ = mlp_plain(packed, cfg, x_pts, x_v, dtype, sigma_only)
    return out.reshape(n, S) if sigma_only else out.reshape(n, S, 4)


def _maps(out) -> dict[str, torch.Tensor]:
    return {"rgb_map": out.rgb_map, "disp_map": out.disp_map,
            "acc_map": out.acc_map, "depth_map": out.depth_map}


def render_around_depth_plain(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    offsets: torch.Tensor,
    *,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K2's computation in plain PyTorch -> rgb/disp/acc/depth maps."""
    n = rays_o.shape[0]
    z = torch.clamp(depth.reshape(n, 1) + offsets[None, :], near, far)  # keeps NaN
    raw = nerf_raw_plain(packed, cfg, rays_o, rays_d, z, multires=multires,
                         multires_views=multires_views, dtype=dtype)
    return _maps(raw2outputs(raw, z, rays_d, 0.0, white_bkgd))


def gaussian_population(depth: torch.Tensor, noise: torch.Tensor, std: float) -> torch.Tensor:
    """z [N, S]: depth + std*noise [N, S-1] and the depth itself, sorted
    (stable) per ray, with no clip (reference utils.py:228-236)."""
    d = depth.reshape(-1, 1)
    return torch.sort(torch.cat([d + std * noise, d], -1), dim=-1, stable=True).values


def render_gaussian_plain(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    noise: torch.Tensor | None = None,
    *,
    std: float = 0.5,
    n_samples: int | None = None,
    seed: int | None = None,
    ray_base: int = 0,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K3's computation in plain PyTorch: the gaussian population around
    depth [N] from ``noise`` [N, S-1], or from K3's Philox draws of
    ``seed`` for the global rays ``ray_base .. ray_base + N - 1`` at
    ``n_samples``, sorted, shaded and composited."""
    if (noise is None) == (seed is None):
        raise ValueError("give the noise or a seed (with n_samples)")
    if noise is None:
        noise = philox.gaussian_noise(seed, rays_o.shape[0], n_samples - 1, ray0=ray_base).to(rays_o.device)
    z = gaussian_population(depth, noise, std)
    raw = nerf_raw_plain(packed, cfg, rays_o, rays_d, z, multires=multires,
                         multires_views=multires_views, dtype=dtype)
    return _maps(raw2outputs(raw, z, rays_d, 0.0, white_bkgd))


def dtype_name(dtype: torch.dtype) -> str:
    """"bf16" or "fp32": the kernels' two element types."""
    names = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    if dtype not in names:
        raise TypeError(f"the kernels run bf16 or fp32, got {dtype}")
    return names[dtype]


def epilogue_vectors(packed: dict, sigma_only: bool = False, dtype=torch.bfloat16) -> list[torch.Tensor]:
    """The vectors of a pack that the kernels' epilogues read, in the order
    the C entries take them after the slices (``nerf_mlp.cuh::read_pack``),
    after checking their types. A ``pack_nerf`` pack at ``dtype``: the
    trunk's biases, then the alpha head alone (``sigma_only``: K6's coarse
    net) or feature_b, alpha_w, alpha_b, views_b, rgb_w, rgb_b. An int8
    pack (``quant.qpack_nerf``, with the default ``dtype`` only): b0, the
    trunk rows, the skip layers' biases, then the alpha head alone or
    feature_bz, alpha_w, alpha_b, views_sw, views_b, rgb_w, rgb_b. The
    wrappers check CPU tensors' packs with it too, so that the plain
    versions refuse what the kernels refuse."""
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    if quant.is_int8(packed):
        if dtype != bf16:
            raise TypeError(f"an int8 pack runs with the default dtype, not {dtype}")
        vec = [(packed["b0"], f32)]
        vec += [(r, f32 if s[0] == "skip" else i32) for r, s in zip(packed["trunk_row"], packed["calib"].steps)]
        vec += [(packed["skip_b"][i], f32) for i in sorted(packed["skip_w"])]
        heads = [("alpha_w", bf16), ("alpha_b", f32)] if sigma_only else [
            ("feature_bz", i32), ("alpha_w", bf16), ("alpha_b", f32), ("views_sw", f32), ("views_b", f32),
            ("rgb_w", bf16), ("rgb_b", f32)]
        what = "int8 weights must be quant.qpack_nerf(model, calib)"
    else:
        vec = [(b, f32) for b in packed["trunk_b"]]
        names = ("alpha_w", "alpha_b") if sigma_only else (
            "feature_b", "alpha_w", "alpha_b", "views_b", "rgb_w", "rgb_b")
        heads = [(k, f32 if k.endswith("_b") else dtype) for k in names]
        what = (f"packed weights must be pack_nerf(model, {dtype}): {dtype_name(dtype)} matrices and fp32 "
                f"biases")
    vec += [(packed[k], want) for k, want in heads]
    for v, want in vec:
        if v.dtype != want:
            raise TypeError(f"{what}: got a {v.dtype} {want} slot")
    return [v for v, _ in vec]


class PackArgs(NamedTuple):
    """What a launch passes of a NeRF pack (``pack_args``)."""

    slices: torch.Tensor  # the wgmma core's forward slices, checked against the pack
    vectors: list[torch.Tensor]  # epilogue_vectors
    plan: np.ndarray | None  # the int8 constants (quant.quant_plan); None for bf16 and fp32
    skip_mask: int  # bit i: layer i also reads the point embedding


def pack_args(packed: dict, cfg: NeRFConfig, *, sigma_only: bool = False, dtype=torch.bfloat16,
              slices: torch.Tensor | None = None) -> PackArgs:
    """What a launch passes of a ``pack_nerf`` pack at ``dtype`` or a
    ``quant.qpack_nerf`` one: the forward's slices (``slices``, or the
    pack's own from ``pack_slices``) after ``check_slices``, the
    ``epilogue_vectors``, the int8 plan (after checking the pack's calib
    against ``cfg``) and the skip mask. Each C entry takes the slices after
    its inputs and outputs and the vectors after the slices."""
    vectors = epilogue_vectors(packed, sigma_only, dtype)
    if slices is None:
        slices = pack_slices(packed, sigma_only)
    check_slices(slices, packed, sigma_only)
    plan = None
    if quant.is_int8(packed):
        quant.check_calib(packed["calib"], cfg)
        plan = quant.quant_plan(packed, cfg.D)
    return PackArgs(slices, vectors, plan, sum(1 << i for i in packed["skip_w"]))


def check_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, **per_ray) -> int:
    """Shapes, types and device of N rays [N, 3] and per-ray fp32 tensors
    {name: (tensor, expected shape)}; returns N."""
    n = rays_o.shape[0]
    items = {"rays_o": (rays_o, (n, 3)), "rays_d": (rays_d, (n, 3)), **per_ray}
    for name, (t, shape) in items.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != rays_o.device:
            raise ValueError("all inputs must be on one device")
    return n


def check_cuda(cfg: NeRFConfig, multires: int, multires_views: int, tensors, weights) -> None:
    """What the CUDA kernels take beyond the plain version: contiguous
    inputs, the 8x256-class NeRF with the production encodings, and the
    pack's slices and vectors (``weights``) contiguous on the rays' device."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if (cfg.W, cfg.input_ch, cfg.input_ch_views, multires, multires_views) != (
        KERNEL_WIDTH, 63, 27, 10, 4
    ):
        raise ValueError("the CUDA kernel is built for W=256, multires 10 and multires_views 4")
    if cfg.D > 16 or any(not 0 <= s < cfg.D - 1 for s in cfg.skips):
        raise ValueError("the CUDA kernel takes D <= 16 and skips inside the trunk")
    for w in weights:
        if w.device != device or not w.is_contiguous():
            raise ValueError("packed weights must be contiguous and on the rays' device")


def render_around_depth_kernel(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    offsets: torch.Tensor,
    *,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
) -> dict[str, torch.Tensor]:
    """K2: maps of N rays [N, 3] around depth [N] at the std-scaled offsets [S];
    int8 with a ``quant.qpack_nerf`` pack.

    On a CPU tensor this runs ``render_around_depth_plain`` at bf16 (or its
    int8 chain); on a CUDA tensor it launches the kernel, or raises on what
    it does not take.
    """
    S = offsets.shape[0]
    check_rays(rays_o, rays_d, depth=(depth, (rays_o.shape[0],)), offsets=(offsets, (S,)))
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"n_samples must be in [1, {MAX_SAMPLES}], got {S}")
    if rays_o.device.type == "cpu":
        epilogue_vectors(packed)
        return render_around_depth_plain(packed, cfg, rays_o, rays_d, depth, offsets, near=near, far=far,
                                         white_bkgd=white_bkgd, multires=multires, multires_views=multires_views,
                                         dtype=torch.bfloat16)
    return _launch("K2", "nst_render_around_depth", packed, cfg, (rays_o, rays_d, depth, offsets),
                   (multires, multires_views), torch.bfloat16, S, float(near), float(far), int(bool(white_bkgd)))


def kernel_occupancy(n_samples: int = 64, fp32: bool = False, int8: bool = False) -> dict[str, int]:
    """The bf16 kernel's launch shape (K2, K3, K8, K9), with ``int8`` the
    int8 one's (K10) or with ``fp32`` the fp32 one's (K8/K9 in COMPARE), at
    ``n_samples``: resident blocks per SM, rays per block, threads per
    block, dynamic shared memory (bytes), and the card's SM count."""
    if int8 and fp32:
        raise ValueError("one kernel: int8 or fp32")
    return build.occupancy("nst_render_around_depth_occupancy", n_samples, 1 if int8 else 2 if fp32 else 0)


def fused_render_around_depth(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    *,
    n_samples: int = 64,
    std: float = 0.5,
    clip_near: float = 2.0,
    clip_far: float = 6.0,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
) -> dict[str, torch.Tensor]:
    """Uniform populate-and-shade of [N, 3] rays around depth [N] through K2;
    ``packed`` is ``pack_nerf(model, torch.bfloat16)`` (or ``quant.qpack_nerf``
    for int8), made once per set of weights."""
    offsets = torch.from_numpy(uniform_population_offsets(n_samples, std)).to(rays_o.device)
    return render_around_depth_kernel(
        packed, cfg, rays_o, rays_d, depth.reshape(-1), offsets,
        near=clip_near, far=clip_far, white_bkgd=white_bkgd,
        multires=multires, multires_views=multires_views,
    )


def render_gaussian_kernel(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    *,
    n_samples: int,
    std: float,
    seed: int = 0,
    ray_base: int = 0,
    noise: torch.Tensor | None = None,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
) -> dict[str, torch.Tensor]:
    """K3: maps of N rays [N, 3] over the gaussian population around depth [N];
    int8 with a ``quant.qpack_nerf`` pack.

    The kernel draws its noise from Philox keyed by (``seed``, global ray
    index), row r of the launch being global ray ``ray_base + r`` (a rank's
    first row under data parallelism); ``noise`` [N, S-1] replaces the
    draws (the kernel check on the card).
    On a CPU tensor this runs ``render_gaussian_plain`` at bf16 with the
    same draws (``philox.gaussian_noise``) unless ``noise`` is given; on a
    CUDA tensor it launches the kernel, or raises on what it does not take.
    """
    S = n_samples
    n = rays_o.shape[0]
    per_ray = {"depth": (depth, (n,))}
    if noise is not None:
        per_ray["noise"] = (noise, (n, S - 1))
    check_rays(rays_o, rays_d, **per_ray)
    if not 2 <= S <= MAX_SAMPLES:
        raise ValueError(f"n_samples must be in [2, {MAX_SAMPLES}], got {S}")
    if rays_o.device.type == "cpu":
        epilogue_vectors(packed)
        return render_gaussian_plain(packed, cfg, rays_o, rays_d, depth, noise, std=std, n_samples=S,
                                     seed=seed if noise is None else None, ray_base=ray_base,
                                     white_bkgd=white_bkgd, multires=multires,
                                     multires_views=multires_views, dtype=torch.bfloat16)
    return _launch("K3", "nst_render_gaussian", packed, cfg, (rays_o, rays_d, depth, noise),
                   (multires, multires_views), torch.bfloat16, S, float(std), int(seed) & 0xFFFFFFFF,
                   int(ray_base), int(bool(white_bkgd)))


def fused_render_gaussian(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    *,
    seed: int,
    ray_base: int = 0,
    n_samples: int = 64,
    std: float = 0.5,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
) -> dict[str, torch.Tensor]:
    """Gaussian populate-and-shade of [N, 3] rays around depth [N] through K3
    (nerf_sampling_tpu/kernels/fused_render.py::fused_render_gaussian), the
    rays being the global rays from ``ray_base`` on."""
    return render_gaussian_kernel(
        packed, cfg, rays_o, rays_d, depth.reshape(-1), n_samples=n_samples, std=std,
        seed=seed, ray_base=ray_base, white_bkgd=white_bkgd, multires=multires, multires_views=multires_views,
    )


def linspace_grid(n_samples: int, near: float, far: float, lindisp: bool = False,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """K8's z grid [S] in fp32, rounded as the TPU kernel rounds it
    (nerf_sampling_tpu/kernels/fused_render.py:278-286), not as
    ``jnp.linspace``: t = s / (S-1) by true division (0 when S = 1), then
    a*(1-t) + b*t with (a, b) = (near, far), or its reciprocal with
    (1/near, 1/far) for lindisp, the constants rounded to fp32 once."""
    t = torch.arange(n_samples, dtype=torch.float32, device=device) / max(n_samples - 1, 1)
    a, b = (1.0 / near, 1.0 / far) if lindisp else (near, far)
    v = a * (1.0 - t) + b * t
    return 1.0 / v if lindisp else v


def render_linspace_plain(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    lindisp: bool = False,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K8's computation in plain PyTorch: every ray shaded at the
    ``linspace_grid`` z and composited -> rgb/disp/acc/depth maps."""
    z = linspace_grid(n_samples, near, far, lindisp, rays_o.device).expand(rays_o.shape[0], n_samples)
    raw = nerf_raw_plain(packed, cfg, rays_o, rays_d, z, multires=multires,
                         multires_views=multires_views, dtype=dtype)
    return _maps(raw2outputs(raw, z, rays_d, 0.0, white_bkgd))


def shade_plain(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z: torch.Tensor,
    *,
    assume_sorted: bool = True,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K9's computation in plain PyTorch: the caller's z [N, S] (sorted per
    ray first, stably with NaN last, unless ``assume_sorted``), shaded and
    composited in order -> rgb/disp/acc/depth maps."""
    if not assume_sorted:
        z = torch.sort(z, dim=-1, stable=True).values
    raw = nerf_raw_plain(packed, cfg, rays_o, rays_d, z, multires=multires,
                         multires_views=multires_views, dtype=dtype)
    return _maps(raw2outputs(raw, z, rays_d, 0.0, white_bkgd))


def precision(packed: dict, dtype=torch.bfloat16) -> str:
    """The precision a launch runs a pack in: "int8" for a ``quant.qpack_nerf``
    pack, else ``dtype_name(dtype)``."""
    return "int8" if quant.is_int8(packed) else dtype_name(dtype)


def _launch(kernel: str, entry: str, packed: dict, cfg: NeRFConfig, inputs: tuple, encodings: tuple[int, int],
            dtype: torch.dtype, S: int, *args) -> dict[str, torch.Tensor]:
    """One launch of K2 (``nst_render_around_depth``), K3
    (``nst_render_gaussian``), K8 (``nst_render_linspace``) or K9
    (``nst_shade``): pointers ``inputs`` (rays_o, rays_d, the depth or
    None, the z argument or None), out, then the pack's slices and
    epilogue vectors (``pack_args``); then n, S, D, the skip mask,
    ``args`` and the int8 plan (or null)."""
    rays_o = inputs[0]
    n = rays_o.shape[0]
    pa = pack_args(packed, cfg, dtype=dtype)
    weights = [pa.slices, *pa.vectors]
    check_cuda(cfg, *encodings, [t for t in inputs if t is not None], weights)
    out = torch.empty((6, n), dtype=torch.float32, device=rays_o.device)
    build.launch(kernel, precision(packed, dtype), entry, [*inputs, out, *weights], n, S, cfg.D, pa.skip_mask,
                 *args, build.host_pointer(pa.plan))
    return {"rgb_map": out[0:3].T, "disp_map": out[3], "acc_map": out[4], "depth_map": out[5]}


def fused_render(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    lindisp: bool = False,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K8: the deterministic-eval render of N rays [N, 3] at ``n_samples``
    grid samples (nerf_sampling_tpu/kernels/fused_render.py::fused_render);
    ``packed`` is ``pack_nerf(model, dtype)``, or ``quant.qpack_nerf`` for
    int8 (with the default dtype). It takes 2..512 samples: at
    one sample the TPU kernel composites a 1e10 interval where
    ``raw2outputs`` keeps the reference's empty one.

    On a CPU tensor this runs ``render_linspace_plain`` at ``dtype``; on a
    CUDA tensor it launches the kernel, or raises on what it does not take.
    """
    check_rays(rays_o, rays_d)
    if not 2 <= n_samples <= MAX_SAMPLES:  # at 1, raw2outputs' reference quirk (no interval) differs
        raise ValueError(f"n_samples must be in [2, {MAX_SAMPLES}], got {n_samples}")
    if rays_o.device.type == "cpu":
        epilogue_vectors(packed, dtype=dtype)
        return render_linspace_plain(packed, cfg, rays_o, rays_d, n_samples=n_samples, near=near, far=far,
                                     lindisp=lindisp, white_bkgd=white_bkgd, multires=multires,
                                     multires_views=multires_views, dtype=dtype)
    a, b = (1.0 / near, 1.0 / far) if lindisp else (near, far)
    return _launch("K8", "nst_render_linspace", packed, cfg, (rays_o, rays_d, None, None), (multires, multires_views),
                   dtype, n_samples, float(a), float(b), int(bool(lindisp)), int(bool(white_bkgd)),
                   int(dtype == torch.float32))


def fused_shade(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    *,
    assume_sorted: bool = True,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K9: shade the caller's z [N, S] of N rays [N, 3]
    (nerf_sampling_tpu/kernels/fused_render.py::fused_shade); unless
    ``assume_sorted`` each ray's z is sorted first (the stable sort by
    (z, index) that the TPU kernel's order-free compositor reproduces).
    ``packed`` is ``pack_nerf(model, dtype)``, or ``quant.qpack_nerf`` for
    int8 (with the default dtype).

    On a CPU tensor this runs ``shade_plain`` at ``dtype``; on a CUDA tensor
    it launches the kernel, or raises on what it does not take.
    """
    n = rays_o.shape[0]
    S = z_vals.shape[-1] if z_vals.dim() == 2 else 0
    check_rays(rays_o, rays_d, z_vals=(z_vals, (n, S)))
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"z_vals must be [N, S] with S in [1, {MAX_SAMPLES}], got {tuple(z_vals.shape)}")
    if rays_o.device.type == "cpu":
        epilogue_vectors(packed, dtype=dtype)
        return shade_plain(packed, cfg, rays_o, rays_d, z_vals, assume_sorted=assume_sorted, white_bkgd=white_bkgd,
                           multires=multires, multires_views=multires_views, dtype=dtype)
    return _launch("K9", "nst_shade", packed, cfg, (rays_o, rays_d, None, z_vals), (multires, multires_views), dtype,
                   S, int(bool(assume_sorted)), int(bool(white_bkgd)), int(dtype == torch.float32))
