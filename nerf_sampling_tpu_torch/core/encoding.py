"""Sinusoidal positional encoding (nerf_sampling_tpu/core/encoding.py).

Column order matches the reference: [x, sin(x*f0), cos(x*f0), sin(x*f1), ...],
each sin/cos block spanning all input channels. fp32 with accurate torch.sin:
the 2^9 frequency needs the full mantissa of the argument.

mip-NeRF's encodings (google/mipnerf ``internal/mip.py``): the Gaussian of a
conical frustum, its integrated positional encoding (IPE) and the view
direction's ``pos_enc``, each in its own column order.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def positional_encoding(
    x: torch.Tensor,
    multires: int,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode ``x [..., d]`` to ``[..., d * (include_input + 2*multires)]``."""
    if multires == 0:
        return x if include_input else x[..., :0]
    max_freq = multires - 1
    if log_sampling:
        freqs = 2.0 ** torch.linspace(0.0, max_freq, multires, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0**max_freq, multires, device=x.device)
    xf = x[..., None, :] * freqs[:, None].to(x.dtype)  # [..., F, d]
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, d]
    flat = sc.reshape(*x.shape[:-1], multires * 2 * x.shape[-1])
    if include_input:
        return torch.cat([x, flat], dim=-1)
    return flat


@dataclasses.dataclass(frozen=True)
class Embedder:
    """Static-config encoder; mirrors the reference Embedder's out_dim."""

    input_dims: int
    multires: int
    include_input: bool = True
    log_sampling: bool = True

    @property
    def out_dim(self) -> int:
        base = self.input_dims if self.include_input else 0
        return base + self.input_dims * 2 * self.multires

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return positional_encoding(
            x, self.multires, self.include_input, self.log_sampling
        )


# ------------------------------------------------------------------ mip-NeRF

SAFE_TRIG_WRAP = 100 * math.pi  # mip-NeRF's safe_sin threshold


def conical_frustum_to_gaussian(
    d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor, base_radius: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Gaussian of the conical frustums [t0, t1] [N, S] of rays d [N, 3]
    with base radii [N, 1] (mip-NeRF ``mip.conical_frustum_to_gaussian``, the
    stable form, diagonal covariance): mean offsets d t_mean and diagonal
    covariances t_var d^2 + r_var (1 - d^2 / |d|^2), [N, S, 3] each."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    mu2, hw2 = mu * mu, hw * hw
    den = 3 * mu2 + hw2
    hw4 = hw2 * hw2
    t_mean = mu + (2 * mu * hw2) / den
    t_var = hw2 / 3 - (4 / 15) * ((hw4 * (12 * mu2 - hw2)) / (den * den))
    r_var = base_radius * base_radius * (mu2 / 4 + (5 / 12) * hw2 - 4 / 15 * hw4 / den)
    d2 = d * d
    d_mag_sq = torch.clamp(d2[..., 0:1] + d2[..., 1:2] + d2[..., 2:3], min=1e-10)
    mean = d[..., None, :] * t_mean[..., None]
    cov = t_var[..., None] * d2[..., None, :] + r_var[..., None] * (1 - d2 / d_mag_sq)[..., None, :]
    return mean, cov


def cast_intervals(
    t_vals: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor, radii: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Means and diagonal covariances [N, S, 3] of the S intervals between
    t-values [N, S + 1] (mip-NeRF ``mip.cast_rays``, ray_shape 'cone')."""
    mean, cov = conical_frustum_to_gaussian(rays_d, t_vals[..., :-1], t_vals[..., 1:], radii)
    return mean + rays_o[..., None, :], cov


def safe_wrap(x: torch.Tensor) -> torch.Tensor:
    """x where |x| < 100 pi, else x modulo 100 pi, Python's modulus (the
    argument of mip-NeRF's ``math.safe_sin``)."""
    m = torch.fmod(x, SAFE_TRIG_WRAP)
    m = torch.where(m < 0, m + SAFE_TRIG_WRAP, m)
    return torch.where(x.abs() < SAFE_TRIG_WRAP, x, m)


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x), an argument of magnitude 100 pi or more taken modulo 100 pi
    first (mip-NeRF ``math.safe_sin``)."""
    return torch.sin(safe_wrap(x))


def integrated_pos_enc(mean: torch.Tensor, cov: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """mip-NeRF's integrated positional encoding of Gaussians [..., 3]: for
    each scale 2^l, l in [min_deg, max_deg), and axis, y = 2^l mean and var =
    4^l cov; the features exp(-var / 2) sin(y), every scale and axis
    (scale-major), then exp(-var / 2) sin(y + pi/2): [..., 6 (max - min)], no
    identity (``mip.integrated_pos_enc``, diag)."""
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)], device=mean.device)
    shape = (*mean.shape[:-1], -1)
    y = (mean[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (cov[..., None, :] * (scales * scales)[:, None]).reshape(shape)
    w = torch.exp(-0.5 * y_var)
    return torch.cat([w * safe_sin(y), w * safe_sin(y + 0.5 * math.pi)], -1)


def mip_pos_enc(x: torch.Tensor, max_deg: int) -> torch.Tensor:
    """mip-NeRF's ``pos_enc`` of a view direction with its identity: [x,
    sin(2^l x) for every scale and axis (scale-major), then sin(2^l x +
    pi/2)], [..., 3 + 6 max_deg]."""
    scales = torch.tensor([2.0**i for i in range(max_deg)], device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(xb), torch.sin(xb + 0.5 * math.pi)], -1)
