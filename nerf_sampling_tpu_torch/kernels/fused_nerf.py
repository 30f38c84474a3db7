"""K4: the NeRF MLP over point queries as a hand-written CUDA kernel, with its plain version.

Replaces nerf_sampling_tpu/kernels/fused_nerf.py::_fused_call
(``fused_nerf_apply``, and the forward of ``fused_nerf_vjp._packed_apply``):
for each row, the fp32 positional encoding of a point and of its unit view
direction, rounded to bf16, then the viewdirs NeRF MLP (bf16 operands and
activations, fp32 sums), returning the raw logits [M, 4] (rgb, sigma) with
no sigmoid. The kernel source is ``csrc/nerf_points.cu``, on the wgmma core
(``csrc/mlp_wgmma.cuh``); the weights are ``fused_render.pack_nerf``'s
layout, shared with K2, K3, K6 and K7: a launch passes their full-forward
slices (``fused_render.pack_slices``), which the caller makes once per set
of weights (the train step's Function hands K5 the same ones), and the
pack's epilogue vectors (``fused_render.pack_args``); a launch without
the slices is refused. A block walks
``tiles_per_block`` 128-row tiles, sized from the rows and the card's SM
count so that both of a step's queries fill the card.

View directions are per row ([M, 3]) or per ray ([M / S, 3], row r's
direction being dirs[r // S]): the train step's queries pass one direction
per ray, never expanded. They are given unit vectors and are not
normalized here.

``nerf_points_plain`` computes the same in plain PyTorch: fp32 is the
reference, bf16 rounds where the kernel rounds. The kernel fills each
128-row tile's embeddings with one sine and cosine per (row, frequency,
axis), and the view embedding of each ray the tile touches once
(``staged_view_rays``; ``point_fill_check`` holds that fill to the
per-column formula it replaced, byte for byte, on the card). While the
recorder is on, a launch counts its rows and staged rays (``nst.k4.rows``,
``nst.k4.view_rays``).
"""

from __future__ import annotations

import torch

from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels.fused_render import PTS_ROWS, check_cuda, epilogue_vectors, mlp_plain, pack_args
from nerf_sampling_tpu_torch.models.nerf import NeRFConfig
from nerf_sampling_tpu_torch.utils import profiling

TILE_ROWS = 128  # rows of a tile of the wgmma core


def tiles_per_block(m: int, sms: int) -> int:
    """The 128-row tiles one K4 block walks for m rows on a card of ``sms``
    SMs: the fewest that keep the grid within one wave at one block per SM
    (4 for the coarse query's 65,536 rows and 12 for the fine query's
    196,608 on 132 SMs: 128 blocks each)."""
    tiles = -(-m // TILE_ROWS)
    return max(1, -(-tiles // sms))


def staged_view_rays(m: int, S: int) -> int:
    """The view embeddings K4's and K5's PE fill stages for m rows at S rows
    a ray: each ray once in every 128-row tile it touches (m / 64 at S =
    64, m / 96 at S = 192, m at S = 1)."""
    return sum((min(t + TILE_ROWS, m) - 1) // S - t // S + 1 for t in range(0, m, TILE_ROWS))


def count_fill(kernel: str, m: int, S: int) -> None:
    """While the recorder is on: a launch's rows and staged view rays, as the
    counts ``nst.<kernel>.rows`` and ``nst.<kernel>.view_rays``."""
    if profiling.recording():
        profiling.count(f"nst.{kernel}.rows", m)
        profiling.count(f"nst.{kernel}.view_rays", staged_view_rays(m, S))


def rows_per_dir(pts: torch.Tensor, dirs: torch.Tensor) -> int:
    """S of points [M, 3] and directions [M / S, 3], after checking both."""
    for name, t in (("pts", pts), ("viewdirs", dirs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be [rows, 3], got {tuple(t.shape)}")
    if dirs.device != pts.device:
        raise ValueError("all inputs must be on one device")
    m, r = pts.shape[0], dirs.shape[0]
    if r == 0 or m % r:
        raise ValueError(f"{m} points do not split into {r} view directions")
    return m // r


def point_embeddings(
    pts: torch.Tensor, dirs: torch.Tensor, multires: int, multires_views: int, dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's PE rows, rounded to ``dtype``: points [M, Cp] and the
    view embedding of each row's direction [M, Cv]."""
    S = rows_per_dir(pts, dirs)

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(torch.float32)

    x_v = rnd(positional_encoding(dirs, multires_views))
    return rnd(positional_encoding(pts, multires)), torch.repeat_interleave(x_v, S, dim=0)


def nerf_points_plain(
    packed: dict,
    cfg: NeRFConfig,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """K4's computation in plain PyTorch: raw [M, 4] of points [M, 3] with
    view directions [M / S, 3]."""
    x_pts, x_v = point_embeddings(pts, viewdirs, multires, multires_views, dtype)
    return mlp_plain(packed, cfg, x_pts, x_v, dtype)[0]


def nerf_points_kernel(
    packed: dict,
    cfg: NeRFConfig,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    slices: torch.Tensor | None = None,
    multires: int = 10,
    multires_views: int = 4,
) -> torch.Tensor:
    """K4: raw [M, 4] of points [M, 3] with view directions [M / S, 3].

    On a CPU tensor this runs ``nerf_points_plain`` at bf16; on a CUDA
    tensor it launches the kernel with the pack's full-forward ``slices``
    (``fused_render.pack_slices(packed)``), or raises on what it does not
    take, a launch without the slices included. A block walks
    ``tiles_per_block`` of M and the card's SM count 128-row tiles.
    """
    S = rows_per_dir(pts, viewdirs)
    if pts.device.type == "cpu":
        epilogue_vectors(packed)
        return nerf_points_plain(packed, cfg, pts, viewdirs, multires=multires,
                                 multires_views=multires_views, dtype=torch.bfloat16)
    if slices is None:
        raise ValueError("K4 takes the pack's full-forward slices (fused_render.pack_slices)")
    pa = pack_args(packed, cfg, slices=slices)
    weights = [pa.slices, *pa.vectors]
    check_cuda(cfg, multires, multires_views, (pts, viewdirs), weights)
    m = pts.shape[0]
    out = torch.empty((m, 4), dtype=torch.float32, device=pts.device)
    build.launch("K4", "bf16", "nst_nerf_points", [pts, viewdirs, out, *weights], m, S, cfg.D, pa.skip_mask,
                 tiles_per_block(m, build.sm_count(pts.device)))
    count_fill("k4", m, S)
    return out


def point_fill_check(pts: torch.Tensor, dirs: torch.Tensor, *, tiles_per_block: int = 1, rolled: bool = False,
                     multires: int = 10, multires_views: int = 4) -> tuple[torch.Tensor, ...]:
    """The PE tiles of K4 and K5 (``csrc/wg_dense.cu::nst_point_fill_check``)
    of points [M, 3] with directions [M / S, 3], blocks walking
    ``tiles_per_block`` 128-row tiles as K4's do: (the fill of
    ``csrc/mlp_wgmma.cuh::point_fill``, unrolled as K4's or ``rolled`` as
    K5's, the per-column formula it replaced), each bf16 [Mp, 128] with
    Mp = M rounded up to 128, columns [point embedding 63 | 0 | view
    embedding 27 | 0 x 37], rows from M on zero; then the tiles' inputs
    as each fill wrote them, fp32 [Mp, 8] (pts, dirs, 0, 0). On CPU
    tensors both are the plain embedding (``point_embeddings`` in fp32,
    rounded to bf16)."""
    S = rows_per_dir(pts, dirs)
    if tiles_per_block < 1:
        raise ValueError(f"tiles_per_block must be at least 1, got {tiles_per_block}")
    m = pts.shape[0]
    mp = -(-m // TILE_ROWS) * TILE_ROWS
    if pts.device.type == "cpu":
        x_pts, x_v = point_embeddings(pts, dirs, multires, multires_views, torch.float32)
        rows = torch.zeros((mp, 128))
        rows[:m, :x_pts.shape[1]] = x_pts
        rows[:m, PTS_ROWS:PTS_ROWS + x_v.shape[1]] = x_v
        q = torch.zeros((mp, 8))
        q[:m, :3] = pts
        q[:m, 3:6] = torch.repeat_interleave(dirs, S, dim=0)
        return rows.to(torch.bfloat16), rows.to(torch.bfloat16), q, q.clone()
    if (multires, multires_views) != (10, 4):
        raise ValueError("the CUDA kernels are built for multires 10 and multires_views 4")
    pts, dirs = pts.contiguous(), dirs.contiguous()
    out = torch.empty((2, mp, 128), dtype=torch.bfloat16, device=pts.device)
    q = torch.empty((2, mp, 8), dtype=torch.float32, device=pts.device)
    build.launch("nst_point_fill_check", "bf16", "nst_point_fill_check", [pts, dirs, out, q], m, S, tiles_per_block,
                 int(bool(rolled)))
    return out[0], out[1], q[0], q[1]


def kernel_occupancy(m: int) -> dict[str, int]:
    """K4's launch shape for m rows: resident blocks per SM, threads per
    block, dynamic shared memory (bytes), tiles per block, blocks, and the
    card's SM count."""
    occ = build.occupancy("nst_nerf_points_occupancy", fields=("blocks_per_sm", "threads", "smem_bytes"))
    tpb = tiles_per_block(m, occ["sms"])
    return {**occ, "tiles_per_block": tpb, "blocks": -(-(-(-m // TILE_ROWS)) // tpb)}


def flat_queries(pts: torch.Tensor, viewdirs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Points [..., 3] and view directions broadcastable to them, as the
    kernels take them: pts [M, 3] and dirs [M / S, 3]. Directions of shape
    [N, 1, 3] against points [N, S, 3] stay one per ray."""
    batch = pts.shape[:-1]
    if viewdirs.dim() == pts.dim() and viewdirs.shape[-2] == 1 and viewdirs.shape[:-2] == pts.shape[:-2]:
        dirs = viewdirs.reshape(-1, 3)
    else:
        dirs = torch.broadcast_to(viewdirs, (*batch, 3)).reshape(-1, 3)
    return pts.reshape(-1, 3).float().contiguous(), dirs.float().contiguous()
