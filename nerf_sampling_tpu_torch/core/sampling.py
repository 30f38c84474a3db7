"""Ray sampling (nerf_sampling_tpu/core/sampling.py).

- ``stratified_z_vals``: coarse z, jittered within each stratum (:30-61);
- ``sample_pdf``: inverse-CDF fine z from coarse weights (:64-113);
- ``sample_points_around_mean``: the DepthNet's depth population (:137-173);
- ``scale_points_with_weights`` and ``scale_to_near_far`` (:116-134), the
  reference's depth_nets/utils.py helpers, kept for capability parity.

Random draws come from an explicit ``torch.Generator`` or are injected
(``t_rand=``, ``u=``, ``noise=``), as the JAX functions take a key or the
same injection parameters. Under data parallelism a rank holds rows
``lo .. lo + N - 1`` of a global batch of ``n_global`` rays: with
``rows=(lo, n_global)`` the draws are made at the global shape from the
shared generator and the rank's rows kept (``rand``), so every rank draws
for its rays what one process draws for them on the whole batch.
"""

from __future__ import annotations

import torch

Rows = tuple[int, int]  # (the rank's first global row, the global row count)


def rand(shape: tuple[int, ...], generator: torch.Generator, device, *, rows: Rows | None = None,
         normal: bool = False) -> torch.Tensor:
    """torch.rand (``normal``: torch.randn) of ``shape`` from ``generator``;
    with ``rows=(lo, n_global)``, drawn as [n_global, *shape[1:]] and rows
    lo:lo + shape[0] kept."""
    fn = torch.randn if normal else torch.rand
    if rows is None:
        return fn(shape, generator=generator, device=device)
    lo, n_global = rows
    return fn((n_global, *shape[1:]), generator=generator, device=device)[lo:lo + shape[0]]


def z_to_points(
    rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor
) -> torch.Tensor:
    """[N, 3] rays and [N, S] depths -> [N, S, 3] points o + d * z."""
    return rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]


def linspace01(n: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """linspace(0, 1, n) in fp32 as jnp.linspace computes it, bit for bit:
    i * fl(1/(n-1)) with the last entry exactly 1 (torch.linspace rounds
    some entries the other way)."""
    if n == 1:
        return torch.zeros(1, device=device)
    i = torch.arange(n, dtype=torch.float32, device=device)
    t = i * torch.full((), 1.0 / (n - 1), dtype=torch.float32, device=device)
    return torch.where(i == n - 1, 1.0, t)  # device work only: a CUDA graph can hold it


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    N_samples: int,
    *,
    generator: torch.Generator | None = None,
    perturb: float = 0.0,
    lindisp: bool = False,
    t_rand: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> torch.Tensor:
    """Coarse z [N, N_samples] between near and far [N, 1], jittered within
    each stratum when ``perturb > 0`` (reference Trainer.py:604-626);
    ``rows`` is the rank's window of the global draws."""
    t_vals = linspace01(N_samples, near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(near.shape[0], N_samples)
    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if t_rand is None:
            if generator is None:
                raise ValueError("perturb > 0 requires a torch.Generator or t_rand")
            t_rand = rand(z_vals.shape, generator, near.device, rows=rows)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis, added left to right: the rounding
    of XLA's CPU sum and cumsum and of K6's per-ray loop (torch.sum and
    torch.cumsum round otherwise, and the inverse CDF amplifies a last-bit
    difference by bin width / bin mass)."""
    acc = x[..., 0]
    out = [acc]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
        out.append(acc)
    return torch.stack(out, -1)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    N_samples: int,
    *,
    generator: torch.Generator | None = None,
    det: bool = False,
    u: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> torch.Tensor:
    """Fine z [N, N_samples] by inverting the CDF of ``weights`` [N, B-1]
    over the bin edges ``bins`` [N, B] (reference run_nerf_helpers.py:250-293);
    ``rows`` is the rank's window of the global draws."""
    weights = weights + 1e-5  # prevent nans
    pdf = weights / _sequential_cumsum(weights)[..., -1:]
    cdf = _sequential_cumsum(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [N, B]
    if u is None:
        shape = (*cdf.shape[:-1], N_samples)
        if det:
            u = linspace01(N_samples, cdf.device).expand(shape)
        else:
            if generator is None:
                raise ValueError("stochastic sample_pdf requires a torch.Generator or u")
            u = rand(shape, generator, cdf.device, rows=rows)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def scale_points_with_weights(
    z_vals: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor
) -> torch.Tensor:
    """Points o + d * z (reference depth_nets/utils.py:5-11)."""
    return z_to_points(rays_o, rays_d, z_vals)


def scale_to_near_far(
    outputs: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor, near: float, far: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """[0, 1] outputs as sorted z in [near, far], and their points
    (reference depth_nets/utils.py:14-19)."""
    z_vals = torch.sort(near * (1 - outputs) + far * outputs, dim=-1).values
    return scale_points_with_weights(z_vals, rays_o, rays_d), z_vals


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
        z_vals = torch.sort(torch.cat([mean + std * noise, mean], -1), dim=-1, stable=True).values
    elif mode == "uniform":
        grid = torch.linspace(-std, std, n_samples - 1, device=mean.device)
        z_vals = torch.sort(torch.cat([mean + grid[None, :], mean], -1), -1).values
        z_vals = torch.clamp(z_vals, 2, 6)
    else:
        raise ValueError(f"unknown sampling mode: {mode}")
    return z_to_points(rays_o, rays_d, z_vals), z_vals
