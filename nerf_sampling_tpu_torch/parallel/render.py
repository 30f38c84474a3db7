"""Full-image rendering over the ranks (nerf_sampling_tpu/parallel/render.py).

Rendering is independent per ray, so each rank renders its contiguous
block of the image's rays with the one-device code (the kernels included)
and the blocks are gathered on the host of every rank: PSNRs, PNGs and the
Trainer's keep_best and early-stop decisions then see the same image on
every rank, as the JAX package gathers to host numpy on every process.
"""

from __future__ import annotations

import torch

from nerf_sampling_tpu_torch.core.rays import get_rays
from nerf_sampling_tpu_torch.parallel.mesh import Mesh
from nerf_sampling_tpu_torch.parallel.ops import make_sharded_eval
from nerf_sampling_tpu_torch.render.engine import EvalMode, NeRFParams, Pipeline


def render_image_sharded(
    pipeline: Pipeline,
    params: NeRFParams,
    H: int,
    W: int,
    K,
    c2w,
    *,
    mesh: Mesh,
    device: torch.device | str,
    mode: EvalMode = EvalMode.DEPTH_NET,
    chunk: int = 1024 * 32,
    generator: torch.Generator | None = None,
    full_outputs: bool = False,
) -> dict[str, torch.Tensor]:
    """``render_image`` with the image's rays split over ``mesh``: [H, W, ...]
    maps on the host of every rank.

    H*W is padded to a multiple of the world size with rays of origin 0 and
    direction (0, 0, -1), rank r renders rows r*n/world .. (r+1)*n/world
    (K1 and K2 on them; K3 keyed by their global index, its seed drawn once
    from the shared ``generator``, so the maps equal one process's), and the
    gathered maps are cropped to H*W.
    """
    rays_o, rays_d = get_rays(H, W, K, c2w, device)
    ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    n = ro.shape[0]
    pad = (-n) % mesh.world
    if pad:
        ro = torch.cat([ro, ro.new_zeros((pad, 3))], 0)
        rd = torch.cat([rd, ro.new_tensor([[0.0, 0.0, -1.0]]).expand(pad, 3)], 0)
    flat = make_sharded_eval(pipeline, mesh, mode)(
        params, ro.contiguous(), rd.contiguous(), generator, chunk=chunk, full_outputs=full_outputs,
        H=H, W=W, focal=float(K[0][0]),
    )
    return {name: v[:n].reshape(H, W, *v.shape[1:]) for name, v in flat.items()}
