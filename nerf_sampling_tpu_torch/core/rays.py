"""Camera-ray generation and NDC reprojection (nerf_sampling_tpu/core/rays.py)."""

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


def ndc_rays(
    H: int, W: int, focal: float, near: float, rays_o: torch.Tensor, rays_d: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift rays to the near plane and project them to NDC space, in fp32
    and in the reference's operation order (run_nerf_helpers.py:221-246),
    for forward-facing (LLFF) scenes."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
