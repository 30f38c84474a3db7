"""Depth-population sampling (nerf_sampling_tpu/core/sampling.py:137-173).

``stratified_z_vals`` and ``sample_pdf`` are not ported yet (ROADMAP S2).
"""

from __future__ import annotations

import torch


def z_to_points(
    rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor
) -> torch.Tensor:
    """[N, 3] rays and [N, S] depths -> [N, S, 3] points o + d * z."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]


def sample_points_around_mean(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mean: torch.Tensor,
    n_samples: int = 32,
    mode: str = "gaussian",
    std: float = 0.1,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Populate z values around a predicted mean depth ``mean [N, 1]``.

    Modes: ``depth_only`` (the mean itself), ``gaussian`` (mean + std*N(0,1)
    draws plus the mean, sorted; noise from ``noise`` or ``generator``) and
    ``uniform`` (mean + linspace(-std, std, n-1) plus the mean, sorted, then
    clipped to the hard-coded [2, 6]). Returns (points [N, S, 3], z [N, S]).
    """
    if mode == "depth_only":
        z_vals = mean
    elif mode == "gaussian":
        if noise is None:
            if generator is None:
                raise ValueError("gaussian mode requires a torch.Generator or noise")
            noise = torch.randn(
                (mean.shape[0], n_samples - 1), generator=generator,
                device=mean.device, dtype=mean.dtype,
            )
        z_vals = torch.sort(torch.cat([mean + std * noise, mean], -1), -1).values
    elif mode == "uniform":
        grid = torch.linspace(-std, std, n_samples - 1, device=mean.device)
        z_vals = torch.sort(torch.cat([mean + grid[None, :], mean], -1), -1).values
        z_vals = torch.clamp(z_vals, 2, 6)
    else:
        raise ValueError(f"unknown sampling mode: {mode}")
    return z_to_points(rays_o, rays_d, z_vals), z_vals
