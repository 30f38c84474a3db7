"""K1: the DepthNet forward as a hand-written CUDA kernel, with its plain version.

Replaces nerf_sampling_tpu/kernels/fused_depth_net.py::_fused_call. The
kernel source is ``csrc/depth_net.cu``. The wrapper builds the two [N, 128]
bf16 input buffers outside the kernel, as the JAX wrapper does:

    A: origin embedding in columns [0, 63), direction embedding in [63, 126)
    B: embedding of the flattened [N, 6] sphere intersections in [0, 126)

and every concatenation of the DepthNet becomes a sum of products with
zero-padded weights (``pack_depth_net``). ``depth_net_plain`` computes the
same sums in plain PyTorch: with ``dtype=torch.float32`` it is the fp32
reference, with bf16 it rounds weights and activations where the kernel
does, so the kernel can be held to it tightly on the card. The kernel runs
bf16 or, for the COMPARE mode, fp32 (fp32 buffers and weights, no
rounding), chosen by the buffers' dtype.

Both run on the wgmma MLP core (``csrc/mlp_wgmma.cuh``), one consumer
warpgroup on 64-row tiles: in bf16 on its bf16 products, in fp32 on its
fp32 path (3xTF32 products on the tensor cores, fp32 sums).
``wgmma_depth_program`` lists the DepthNet's matrices in the order a tile
consumes them, and ``depth_slices`` writes their slice image once per pack
(``fused_render.wgmma_slices``, or the hi and lo images of
``fused_render.wgmma_slices32``) and keeps it there: the only device copy
of the matrices. A launch passes A, B, out, the slices, then the vectors
its epilogues read (``epilogue_vectors``). The bf16 kernel reads A and B
as they are; for the fp32 one ``fragment_tiles`` copies them into the
order in which each thread of the tile reads its share of them.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.core.geometry import find_intersection_points_with_sphere
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels.fused_render import dtype_name, wgmma_slices, wgmma_slices32
from nerf_sampling_tpu_torch.models.depth_net import DepthNet, DepthNetConfig
from nerf_sampling_tpu_torch.utils.precision import strict_fp32

PAD = 128
KERNEL_HIDDEN = 256  # hidden width the CUDA kernel is built for
TILE_ROWS = 64  # rows of a tile of the kernel (csrc/mlp_wgmma.cuh's kRows32)


def _in_out(lin: nn.Linear) -> torch.Tensor:
    return lin.weight.detach().float().T


def _bias(lin: nn.Linear) -> torch.Tensor:
    return lin.bias.detach().float().contiguous()


def pack_depth_net(model: DepthNet, dtype=torch.bfloat16) -> dict:
    """Repack a DepthNet's weights as [in, out] matrices for buffers A and B."""
    cfg = model.cfg
    eo, ed, ei = cfg.origin_dims, cfg.direction_dims, cfg.intersection_dims
    H = cfg.hidden_sizes
    if max(eo + ed, ei) > PAD:
        raise ValueError("embedding widths exceed PAD")
    if len(set(H)) != 1 or len(set(cfg.cat_hidden_sizes)) != 1:
        raise ValueError("the fused DepthNet needs uniform hidden sizes")

    def pad_rows(w: torch.Tensor, off: int) -> torch.Tensor:
        out = torch.zeros((PAD, w.shape[1]), device=w.device)
        out[off : off + w.shape[0]] = w
        return out.to(dtype).contiguous()

    def cast(w: torch.Tensor) -> torch.Tensor:
        return w.to(dtype).contiguous()

    def tower(seq: nn.Sequential, emb_dim: int, off: int) -> dict:
        t = {"e": [], "h": [], "b": [_bias(lin) for lin in seq]}
        for i, lin in enumerate(seq):
            w = _in_out(lin)
            if i == 0:  # cat([emb, emb]) @ W == emb @ (W_top + W_bottom)
                t["e"].append(pad_rows(w[:emb_dim] + w[emb_dim:], off))
            else:  # cat([h, emb]) @ W
                t["h"].append(cast(w[: H[0]]))
                t["e"].append(pad_rows(w[H[0] :], off))
        return t

    lins = [m for m in model.cat_layers if isinstance(m, nn.Linear)]
    w0 = _in_out(lins[0])  # rows [o(H) | d(H) | i(H) | o_emb | d_emb | i_emb]
    Hn = H[-1]
    emb0 = 3 * Hn
    wa = torch.zeros((PAD, w0.shape[1]), device=w0.device)
    wa[:eo] = w0[emb0 : emb0 + eo]
    wa[eo : eo + ed] = w0[emb0 + eo : emb0 + eo + ed]
    head = model.to_depth[0]
    return {
        "o": tower(model.origin_layers, eo, 0),
        "d": tower(model.direction_layers, ed, eo),
        "i": tower(model.intersection_layers, ei, 0),
        "cat0": [
            cast(w0[0:Hn]), cast(w0[Hn : 2 * Hn]), cast(w0[2 * Hn : 3 * Hn]),
            cast(wa), pad_rows(w0[emb0 + eo + ed :], 0),
        ],
        "cat_w": [cast(_in_out(lin)) for lin in lins[1:]],
        "cat_b": [_bias(lin) for lin in lins],
        "head_w": cast(_in_out(head)[:, 0]),
        "head_b": _bias(head),
    }


def depth_net_inputs(
    cfg: DepthNetConfig, rays_o: torch.Tensor, rays_d: torch.Tensor, dtype=torch.bfloat16
) -> tuple[torch.Tensor, torch.Tensor]:
    """Buffers A and B [N, 128] from the rays' encodings and sphere hits."""
    eo, ed, ei = cfg.origin_dims, cfg.direction_dims, cfg.intersection_dims
    n = rays_o.shape[0]
    _, inters = find_intersection_points_with_sphere(rays_o, rays_d, cfg.sphere_radius)
    A = torch.zeros((n, PAD), dtype=dtype, device=rays_o.device)
    A[:, :eo] = positional_encoding(rays_o, cfg.multires).to(dtype)
    A[:, eo : eo + ed] = positional_encoding(rays_d, cfg.multires).to(dtype)
    B = torch.zeros((n, PAD), dtype=dtype, device=rays_o.device)
    B[:, :ei] = positional_encoding(inters.reshape(n, 6), cfg.multires).to(dtype)
    return A, B


def depth_net_plain(
    packed: dict, cfg: DepthNetConfig, A: torch.Tensor, B: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """The kernel's computation in plain PyTorch -> depth [N] fp32."""
    strict_fp32()
    f32 = torch.float32

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(f32)

    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(f32)

    A, B = A.to(f32), B.to(f32)

    def run_tower(t: dict, buf: torch.Tensor) -> torch.Tensor:
        h = None
        for i, b in enumerate(t["b"]):
            z = mm(buf, t["e"][i])
            if i > 0:
                z = z + mm(h, t["h"][i - 1])
            h = rnd(z + b)  # towers: no activation (reference quirk)
        return h

    o, d, i_ = run_tower(packed["o"], A), run_tower(packed["d"], A), run_tower(packed["i"], B)
    c = packed["cat0"]
    z = mm(o, c[0]) + mm(d, c[1]) + mm(i_, c[2]) + mm(A, c[3]) + mm(B, c[4]) + packed["cat_b"][0]
    h = rnd(torch.where(z > 0, z, 0.01 * z))
    for w, b in zip(packed["cat_w"], packed["cat_b"][1:]):
        z = mm(h, w) + b
        h = rnd(torch.where(z > 0, z, 0.01 * z))
    depth = torch.sigmoid(mm(h, packed["head_w"][:, None])[:, 0] + packed["head_b"])
    return cfg.near * (1 - depth) + cfg.far * depth


def wgmma_depth_program(packed: dict) -> list[tuple[torch.Tensor, bool]]:
    """The matrices of a ``pack_depth_net`` pack (bf16 or fp32) in the
    order a 64-row tile of the kernel multiplies by them, as
    ``fused_render.wgmma_program``'s (W, transposed) pairs (all x @ W): per
    tower (origin, direction, intersection), layer by layer, its embedding
    matrix then, past layer 0, its hidden one, then the tower's rows of
    trunk layer 0 (added to the trunk's partial sum as the tower ends);
    trunk layer 0's A and B rows; trunk layers 1..C-1. Counts:
    ``mlp_wgmma.cuh::depth_slices16`` and ``depth_slices32`` (the functions
    of the same names here)."""
    prog = []
    for k, name in enumerate(("o", "d", "i")):
        tower = packed[name]
        for i, e in enumerate(tower["e"]):
            prog.append((e, False))
            if i > 0:
                prog.append((tower["h"][i - 1], False))
        prog.append((packed["cat0"][k], False))
    prog += [(packed["cat0"][3], False), (packed["cat0"][4], False)]
    return prog + [(w, False) for w in packed["cat_w"]]


def depth_slices32(n_layers: int, n_cat: int) -> int:
    """The fp32 kernel's slices of a 256-wide DepthNet (``mlp_wgmma.cuh::
    depth_slices32``): two (hi, lo) per 32-deep panel and 128-column half,
    16 for a 128-deep product, 32 for a 256-deep one."""
    return 3 * (16 + 48 * (n_layers - 1) + 32) + 32 + 32 * (n_cat - 1)


def depth_slices16(n_layers: int, n_cat: int) -> int:
    """The bf16 kernel's slices of a 256-wide DepthNet (``mlp_wgmma.cuh::
    depth_slices16``): one per 64-deep panel and 128-column half, 4 for a
    128-deep product, 8 for a 256-deep one."""
    return 3 * (4 + 12 * (n_layers - 1) + 8) + 8 + 8 * (n_cat - 1)


def _fp32(packed: dict) -> bool:
    return packed["head_w"].dtype == torch.float32


def depth_slices(packed: dict) -> torch.Tensor:
    """The kernel's weight slices of a pack: for a bf16 pack
    ``wgmma_slices(wgmma_depth_program(packed))`` [n, 8192] bf16, for an
    fp32 one ``wgmma_slices32`` of that program [n, 4096] fp32; made on
    first use and kept in the pack (a pack is made anew for new weights).
    The gather index is not kept on the device: a pack is made once an
    eval, never inside a captured step."""
    cache = packed.setdefault("wg_slices", {})
    if "depth" not in cache:
        image = wgmma_slices32 if _fp32(packed) else wgmma_slices
        cache["depth"] = image(wgmma_depth_program(packed), keep_index=False)
    return cache["depth"]


def check_depth_slices(slices: torch.Tensor, packed: dict) -> None:
    """Raise ValueError unless ``slices`` is the image ``depth_slices``
    makes of ``packed``: its element type and as many 16 KB slices as the
    kernel reads blind (``depth_slices16`` or ``depth_slices32``)."""
    count = depth_slices32 if _fp32(packed) else depth_slices16
    dtype = torch.float32 if _fp32(packed) else torch.bfloat16
    shape = (count(len(packed["o"]["b"]), len(packed["cat_b"])), 16384 // dtype.itemsize)
    if slices is None or slices.dtype != dtype or tuple(slices.shape) != shape or not slices.is_contiguous():
        got = None if slices is None else (slices.dtype, tuple(slices.shape))
        raise ValueError(f"the weight slices must be the pack's (fused_depth_net.depth_slices): "
                         f"{dtype} {shape}, got {got}")


def fragment_tiles(x: torch.Tensor) -> torch.Tensor:
    """[N, 128] fp32 rows in the order the fp32 kernel's threads read them:
    [T, 16, 128, 4] for T = ceil(N / 64) tiles (zero rows past N), element
    [t, g, i] the float4 of thread i (warp w = i // 32, lane l) in 8-column
    group g: rows r = 16 w + l // 4 and r + 8 of tile t at columns c = 8 g +
    2 (l % 4) and c + 1, as (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1)."""
    n = x.shape[0]
    t = -(-n // TILE_ROWS)
    padded = x.new_zeros((t * TILE_ROWS, PAD))
    padded[:n] = x
    # rows as (tile, warp, r // 8 % 2, r % 8), columns as (group, lane % 4, pair)
    v = padded.view(t, 4, 2, 8, PAD // 8, 4, 2)
    return v.permute(0, 4, 1, 3, 5, 2, 6).reshape(t, PAD // 8, 128, 4).contiguous()


def tiles_per_block(n: int, sms: int) -> int:
    """The 64-row tiles one block walks for n rays on a card of ``sms``
    SMs: the fewest that keep the grid within one wave at one block per SM
    (19 at 160,064 rays on 132 SMs)."""
    return max(1, -(-(-(-n // TILE_ROWS)) // sms))


def kernel_occupancy(n: int, fp32: bool = False) -> dict[str, int]:
    """The bf16 kernel's launch shape for n rays, or with ``fp32`` the fp32
    one's (K1 in COMPARE): resident blocks per SM, threads per block,
    dynamic shared memory (bytes), tiles per block, blocks, and the card's
    SM count."""
    occ = build.occupancy("nst_depth_net_occupancy", int(fp32), fields=("blocks_per_sm", "threads", "smem_bytes"))
    tpb = tiles_per_block(n, occ["sms"])
    return {**occ, "tiles_per_block": tpb, "blocks": -(-(-(-n // TILE_ROWS)) // tpb)}


def epilogue_vectors(packed: dict, dtype=torch.bfloat16) -> list[torch.Tensor]:
    """The vectors of a pack that the kernel's epilogues read, in the order
    nst_depth_net_forward takes them after the slices (each tower's biases,
    the trunk's, head_w, head_b), after checking that the pack is the
    kernel's layout: ``dtype`` matrices and fp32 biases (on CPU tensors
    too, so that the plain version refuses what the kernel refuses)."""
    f32 = torch.float32
    vec = [(b, f32) for t in ("o", "d", "i") for b in packed[t]["b"]]
    vec += [(b, f32) for b in packed["cat_b"]] + [(packed["head_w"], dtype), (packed["head_b"], f32)]
    for v, want in vec:
        if v.dtype != want:
            raise TypeError(f"packed weights must be pack_depth_net(model, {dtype}): {dtype_name(dtype)} "
                            f"matrices and fp32 biases, got a {v.dtype} {want} slot")
    return [v for v, _ in vec]


def check_cuda(cfg: DepthNetConfig, A: torch.Tensor, B: torch.Tensor, weights: list[torch.Tensor]) -> None:
    """What the CUDA kernel takes beyond the plain version: contiguous
    buffers on the card, the 256-wide DepthNet, the slices and vectors
    (``weights``) on the buffers' device."""
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("A and B must be contiguous")
    if cfg.hidden_sizes[0] != KERNEL_HIDDEN or cfg.cat_hidden_sizes[0] != KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel is built for width {KERNEL_HIDDEN}")
    for w in weights:
        if w.device != A.device or not w.is_contiguous():
            raise ValueError("packed weights must be contiguous and on the inputs' device")


def depth_net_kernel(
    packed: dict, cfg: DepthNetConfig, A: torch.Tensor, B: torch.Tensor
) -> torch.Tensor:
    """Depth [N] fp32 from buffers A, B [N, 128], both bf16 or both fp32;
    ``packed`` is ``pack_depth_net`` at the same dtype.

    On a CPU tensor this runs ``depth_net_plain`` at that dtype; on a CUDA
    tensor it launches the kernel, or raises on what the kernel does not take.
    A launch hands the kernel the pack's slices (``depth_slices``), checked
    first, then its ``epilogue_vectors``, and the tiles a block walks; an
    fp32 launch hands it A and B in fragment order (``fragment_tiles``).
    """
    n = A.shape[0]
    dtype = A.dtype
    if dtype not in (torch.bfloat16, torch.float32) or B.dtype != dtype:
        raise TypeError("A and B must be both bf16 or both fp32")
    if A.shape != (n, PAD) or B.shape != (n, PAD):
        raise ValueError(f"A and B must be [N, {PAD}], got {tuple(A.shape)} and {tuple(B.shape)}")
    if A.device != B.device:
        raise ValueError("A and B must be on one device")
    vectors = epilogue_vectors(packed, dtype)
    if A.device.type == "cpu":
        return depth_net_plain(packed, cfg, A, B, dtype)
    slices = depth_slices(packed)
    check_depth_slices(slices, packed)
    check_cuda(cfg, A, B, [slices, *vectors])
    fp32 = dtype == torch.float32
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    if fp32:
        A, B = fragment_tiles(A), fragment_tiles(B)
    build.launch("K1", dtype_name(dtype), "nst_depth_net_forward", [A, B, out, slices, *vectors], n,
                 len(cfg.hidden_sizes), len(cfg.cat_hidden_sizes), float(cfg.near), float(cfg.far), int(fp32),
                 tiles_per_block(n, build.sm_count(A.device)))
    return out


def fused_depth_net_apply(
    packed: dict, cfg: DepthNetConfig, rays_o: torch.Tensor, rays_d: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """Depth [N] of [N, 3] rays through K1; ``packed`` is
    ``pack_depth_net(model, dtype)``, made once per set of weights."""
    A, B = depth_net_inputs(cfg, rays_o, rays_d, dtype)
    return depth_net_kernel(packed, cfg, A, B)
