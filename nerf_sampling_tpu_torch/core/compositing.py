"""Alpha compositing (nerf_sampling_tpu/core/compositing.py:22-108).

Keeps the reference's constants: the 1e10 last interval, the +1e-10 inside
the exclusive transmittance product, the disparity formula and the S==0
fallback rgb_map = sum(rgb). ``composite_intervals`` is mip-NeRF's compositing
of intervals, with its own constants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerf_sampling_tpu_torch.core.sampling import Rows, _sequential_cumsum, rand


class _Cumprod(torch.autograd.Function):
    """torch.cumprod along the last axis, with the backward torch takes for
    an input without zeros, reversed_cumsum(output * grad) / input, bit for
    bit. torch's own backward first reads from the device whether the input
    holds a zero, which a CUDA graph cannot hold (train/dispatch.py); the
    transmittance's factors are 1 and 1 - alpha + 1e-10 >= 1e-10, never
    zero, so that branch is never the one taken."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(out * grad, [-1]), -1), [-1]) / x


def raw2alpha(raw: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """alpha_i = 1 - exp(-relu(sigma_i) * delta_i)."""
    return 1.0 - torch.exp(-torch.relu(raw) * dists)


class RenderOutputs(NamedTuple):
    rgb_map: torch.Tensor  # [N, 3]
    disp_map: torch.Tensor  # [N]
    acc_map: torch.Tensor  # [N]
    depth_map: torch.Tensor  # [N]
    density: torch.Tensor  # [N, S]
    alphas: torch.Tensor  # [N, S]
    weights: torch.Tensor  # [N, S]


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = True,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> RenderOutputs:
    """Raw [N, S, 4] network output + z [N, S] -> composited per-ray maps;
    ``rows`` is the rank's window of the global density noise
    (core/sampling.py)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    density = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            if generator is None:
                raise ValueError("raw_noise_std > 0 requires a torch.Generator or noise")
            noise = rand(density.shape, generator, density.device, rows=rows, normal=True) * raw_noise_std
        density_for_alpha = density + noise
    else:
        density_for_alpha = density

    alphas = raw2alpha(density_for_alpha, dists)
    transmittance = _Cumprod.apply(
        torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], -1)
    )[..., :-1]
    weights = alphas * transmittance

    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = 1.0 / torch.maximum(
        torch.full_like(depth_map, 1e-10), depth_map / (acc_map + 1e-10)
    )
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    if weights.shape[-1] == 0:
        rgb_map = torch.sum(rgb, -2)
    return RenderOutputs(rgb_map, disp_map, acc_map, depth_map, density, alphas, weights)


def composite_intervals(
    rgb: torch.Tensor, density: torch.Tensor, t_vals: torch.Tensor, rays_d: torch.Tensor, white_bkgd: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """mip-NeRF's compositing of S intervals (``mip.volumetric_rendering``):
    rgb [N, S, 3] and density [N, S] between t-values [N, S + 1] -> (rgb [N,
    3], distance [N], acc [N], weights [N, S]). delta = (t1 - t0) |d| (no
    1e10 tail), transmittance exp(-cumsum) (no 1e-10), the distance the
    weights' mean interval midpoint with NaN (no weight) taken as 0, as the
    published ``nan_to_num`` call does, then clipped to [t_0, t_S]; the white
    background. Sums run left to right, as the kernel's per-ray loop."""
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    delta = (t_vals[..., 1:] - t_vals[..., :-1]) * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    dd = density * delta
    cum = _sequential_cumsum(dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]), cum[..., :-1]], -1))
    weights = (1 - torch.exp(-dd)) * trans
    rgb_map = _sequential_cumsum((weights[..., None] * rgb).movedim(-1, -2))[..., -1]
    acc = _sequential_cumsum(weights)[..., -1]
    distance = _sequential_cumsum(weights * t_mids)[..., -1] / acc
    distance = torch.clamp(torch.nan_to_num(distance, nan=0.0), t_vals[..., 0], t_vals[..., -1])
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return rgb_map, distance, acc, weights
