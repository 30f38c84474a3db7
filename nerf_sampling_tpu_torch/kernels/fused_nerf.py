"""K4: the NeRF MLP over point queries as a hand-written CUDA kernel, with its plain version.

Replaces nerf_sampling_tpu/kernels/fused_nerf.py::_fused_call
(``fused_nerf_apply``, and the forward of ``fused_nerf_vjp._packed_apply``):
for each row, the fp32 positional encoding of a point and of its unit view
direction, rounded to bf16, then the viewdirs NeRF MLP (bf16 operands and
activations, fp32 sums), returning the raw logits [M, 4] (rgb, sigma) with
no sigmoid. The kernel source is ``csrc/nerf_points.cu``; the weights are
``fused_render.pack_nerf``'s layout, shared with K2, K3, K6 and K7.

View directions are per row ([M, 3]) or per ray ([M / S, 3], row r's
direction being dirs[r // S]): the train step's queries pass one direction
per ray, never expanded. They are given unit vectors and are not
normalized here.

``nerf_points_plain`` computes the same in plain PyTorch: fp32 is the
reference, bf16 rounds where the kernel rounds.
"""

from __future__ import annotations

import torch

from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels.fused_render import _check_cuda, _flat_weights, mlp_plain
from nerf_sampling_tpu_torch.models.nerf import NeRFConfig

launches = 0  # kernel launches since the last reset (see chip_smoke.py)


def _rows_per_dir(pts: torch.Tensor, dirs: torch.Tensor) -> int:
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
    S = _rows_per_dir(pts, dirs)

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
    multires: int = 10,
    multires_views: int = 4,
) -> torch.Tensor:
    """K4: raw [M, 4] of points [M, 3] with view directions [M / S, 3].

    On a CPU tensor this runs ``nerf_points_plain`` at bf16; on a CUDA
    tensor it launches the kernel, or raises on what it does not take.
    """
    global launches
    S = _rows_per_dir(pts, viewdirs)
    weights = _flat_weights(packed)
    if pts.device.type == "cpu":
        return nerf_points_plain(packed, cfg, pts, viewdirs, multires=multires,
                                 multires_views=multires_views, dtype=torch.bfloat16)
    _check_cuda(cfg, multires, multires_views, (pts, viewdirs), weights)
    m = pts.shape[0]
    lib = build.load_library()
    out = torch.empty((m, 4), dtype=torch.float32, device=pts.device)
    arr, count = build.pointer_array([pts, viewdirs, out] + weights)
    rc = lib.nst_nerf_points(arr, count, m, S, cfg.D, sum(1 << i for i in packed["skip_w"]),
                             build.current_stream(pts.device))
    build.check(rc, "nerf_points_kernel")
    launches += 1
    return out


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
