"""Camera-ray generation (nerf_sampling_tpu/core/rays.py:14-55).

NDC reprojection is not ported yet (ROADMAP S6).
"""

from __future__ import annotations

import numpy as np
import torch


def get_rays(
    H: int, W: int, K, c2w, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel grid -> world-space rays from intrinsics K and pose c2w.

    Returns (rays_o, rays_d), each [H, W, 3] fp32 on ``device``.
    """
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    dirs = torch.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -torch.ones_like(i)],
        dim=-1,
    )
    # dirs @ R^T as a broadcast multiply-sum: exact fp32 on every device
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(
    H: int, W: int, K: np.ndarray, c2w: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side numpy twin of get_rays (reference run_nerf_helpers.py:205-218)."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = np.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)], -1
    )
    rays_d = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], np.shape(rays_d))
    return rays_o, rays_d
