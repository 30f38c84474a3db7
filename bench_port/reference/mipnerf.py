"""The plain reference of the mip-NeRF render, from raw arrays.

Plain PyTorch in float32 with TF32 off (``strict_fp32``), written from the
published code of mip-NeRF (Barron et al., ICCV 2021, arXiv:2103.13415;
github.com/google/mipnerf), function by function and line by line, and not
from the program:

- ``rays``: the Blender dataset's ``_generate_rays`` (``internal/datasets.py``):
  rays through pixel centres, ``(x - W/2 + 0.5) / focal``, unit view
  directions, and base radii ``dx * 2 / sqrt(12)`` from the distance ``dx``
  between the directions of vertically adjacent pixels (the last row takes
  the row above's);
- ``linspace``: ``jnp.linspace``'s arithmetic, ``start (1 - i/n) + stop i/n``
  with the end point pinned (i/n as XLA computes it, i times fl(1/n));
- ``cast_rays``, ``conical_frustum_to_gaussian`` (the stable form) and
  ``lift_gaussian`` with diag=True (``internal/mip.py``);
- ``integrated_pos_enc``, ``expected_sin`` and ``safe_sin`` (``mip.py``,
  ``internal/math.py``): exp(-var/2) sin(y), the cosines as sines of
  y + pi/2, an argument of magnitude 100 pi or more wrapped by ``x % (100
  pi)`` (Python's modulus: the sign of the divisor);
- ``pos_enc`` of the view direction with its identity;
- ``mlp``: ``models.MLP``: ``net_depth`` ReLU layers of ``net_width``, the
  input concatenated after every ``skip_layer``-th layer (``[x, inputs]``),
  the density head on the trunk, a bottleneck, the view encoding, one ReLU
  layer of ``net_width_condition`` and the rgb head;
- ``volumetric_rendering``: interval compositing with delta = (t1 - t0)
  |d|, transmittance exp(-cumsum), depth as the weights' mean interval
  midpoint, clipped to the first and last t-value;
- ``resample_along_rays``' blurpool and padding and
  ``sorted_piecewise_constant_pdf`` with ``randomized`` False: the eps
  padding of the weights' sum, the CDF pinned to 0 and 1, u =
  ``linspace(0, 1 - eps_f32, n)``, each u's interval by the mask max/min
  form, not a search;
- ``render``: ``MipNerfModel.__call__`` at test time, one MLP for every
  level.

A network is its raw tree: ``{"mlp": [layers]}``, the layers as flax
creates them in ``MLP`` (the trunk's, the density head, the bottleneck, the
condition layers, the rgb head), each ``{"weight": [in, out], "bias":
[out]}`` applied by ``model.dense`` (so that a precision control that
rounds the NeRF reference's products rounds these too); ``glorot`` draws
one from a seed, as mip-NeRF initialises its kernels (glorot-uniform, zero
biases). Run it under ``model.strict_fp32``.

Departures from the published code, each a rounding of the same operations:

- sums over a ray (``jnp.sum``, ``jnp.cumsum``) in torch's order;
- ``nan_to_num``: the published calls ``jnp.nan_to_num(x, jnp.inf)`` and
  ``jnp.nan_to_num(x, 0)`` pass their second argument as NumPy's ``copy``,
  so NaN becomes 0 in both (and infinities the largest finite floats); this
  reference does what those calls do, so a ray with no weight (0 / 0) gets
  the depth of its first t-value;
- the rays and radii in float32 throughout (the published dataset code
  divides by NumPy float64 scalars, the focal and ``np.sqrt(12)``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference import model as M

EPS_F32 = float(np.finfo(np.float32).eps)
HALF_PI = 0.5 * math.pi
WRAP = 100 * math.pi  # safe_sin's threshold


def layer_shapes(net: dict) -> list[tuple[int, int]]:
    """(in, out) of every layer of the raw tree, in flax's order."""
    pts = 6 * (net["max_deg_point"] - net["min_deg_point"])
    views = 3 + 6 * net["deg_view"]
    W, D, k = net["net_width"], net["net_depth"], net["skip_layer"]
    shapes, width = [], pts
    for i in range(D):
        shapes.append((width, W))
        width = W + pts if (i % k == 0 and i > 0) else W
    shapes += [(width, 1), (width, W)]
    width = W + views
    for _ in range(net["net_depth_condition"]):
        shapes.append((width, net["net_width_condition"]))
        width = net["net_width_condition"]
    return shapes + [(width, 3)]


def glorot(seed: int, net: dict) -> dict:
    """The raw tree of a freshly initialised MLP: glorot-uniform kernels
    (U(-a, a), a = sqrt(6 / (in + out))) and zero biases, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x6D6970])  # "mip"
    layers = []
    for n_in, n_out in layer_shapes(net):
        a = math.sqrt(6.0 / (n_in + n_out))
        layers.append({"weight": rng.uniform(-a, a, (n_in, n_out)).astype(np.float32),
                       "bias": np.zeros(n_out, np.float32)})
    return {"mlp": layers}


def rays(size: int, focal: float, c2w: np.ndarray, rows: np.ndarray | None, device):
    """Origins, directions, unit view directions [n, 3] and radii [n, 1] of
    the pixels ``rows`` (row-major; all when None) of a size x size frame."""
    x, y = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32), indexing="xy")
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    w = h = size
    camera_dirs = torch.stack([(x - w * 0.5 + 0.5) / focal, -(y - h * 0.5 + 0.5) / focal, -torch.ones_like(x)], -1)
    R = torch.from_numpy(np.asarray(c2w, np.float32)[:3, :3])
    directions = (camera_dirs[..., None, :] * R).sum(-1)
    origins = torch.from_numpy(np.asarray(c2w, np.float32)[:3, -1]).expand(directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    dx = torch.sqrt(((directions[:-1, :, :] - directions[1:, :, :]) ** 2).sum(-1))
    dx = torch.cat([dx, dx[-2:-1, :]], 0)
    radii = dx[..., None] * 2 / math.sqrt(12)
    out = [t.reshape(-1, t.shape[-1]) for t in (origins, directions, viewdirs, radii)]
    if rows is not None:
        idx = torch.from_numpy(np.asarray(rows, np.int64))
        out = [t[idx] for t in out]
    return [t.contiguous().to(device) for t in out]


def linspace(start, stop, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)``: start (1 - step) + stop step, step
    = i / (num - 1) as XLA computes it (i times the float32 reciprocal of num
    - 1), the last point ``stop`` itself."""
    step = torch.arange(num - 1, dtype=torch.float32, device=device) * torch.tensor(1.0 / (num - 1), device=device)
    out = start * (1 - step) + stop * step
    return torch.cat([out, out.new_full((1,), stop)], -1)


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """mip.conical_frustum_to_gaussian, stable=True, diag=True."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw**2) / (3 * mu**2 + hw**2)
    t_var = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / (3 * mu**2 + hw**2) ** 2)
    r_var = base_radius**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - 4 / 15 * (hw**4) / (3 * mu**2 + hw**2))
    return lift_gaussian(d, t_mean, t_var, r_var)


def lift_gaussian(d, t_mean, t_var, r_var):
    """mip.lift_gaussian, diag=True."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp((d**2).sum(-1, keepdim=True), min=1e-10)
    d_outer_diag = d**2
    null_outer_diag = 1 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def cast_rays(t_vals, origins, directions, radii):
    """mip.cast_rays with ray_shape 'cone': means and diagonal covariances [N, S, 3]."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    means, covs = conical_frustum_to_gaussian(directions, t0, t1, radii)
    return means + origins[..., None, :], covs


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    """math.safe_sin: sin(x), x taken modulo 100 pi (Python's modulus) where |x| >= 100 pi."""
    m = torch.fmod(x, WRAP)
    m = torch.where((m != 0) & (m < 0), m + WRAP, m)
    return torch.sin(torch.where(x.abs() < WRAP, x, m))


def integrated_pos_enc(means, covs, min_deg: int, max_deg: int) -> torch.Tensor:
    """mip.integrated_pos_enc, diag=True: [.., 6 (max - min)], the sines
    (scale-major, axis-minor), then the cosines, no identity."""
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)], device=means.device)
    shape = list(means.shape[:-1]) + [-1]
    y = (means[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (covs[..., None, :] * scales[:, None] ** 2).reshape(shape)
    x, x_var = torch.cat([y, y + HALF_PI], -1), torch.cat([y_var] * 2, -1)
    return torch.exp(-0.5 * x_var) * safe_sin(x)  # expected_sin's mean


def pos_enc(x, min_deg: int, max_deg: int) -> torch.Tensor:
    """mip.pos_enc with append_identity."""
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)], device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(list(x.shape[:-1]) + [-1])
    four_feat = torch.sin(torch.cat([xb, xb + HALF_PI], -1))
    return torch.cat([x, four_feat], -1)


def mlp(tree: dict, net: dict, x: torch.Tensor, condition: torch.Tensor):
    """models.MLP: (raw_rgb [N, S, 3], raw_density [N, S, 1]) of samples x [N, S, C]
    under per-ray conditions [N, Cv]."""
    layers = tree["mlp"]
    n, s = x.shape[:2]
    x = x.reshape(n * s, -1)
    inputs = x
    D = net["net_depth"]
    for i in range(D):
        x = torch.relu(M.dense(layers[i], x))
        if i % net["skip_layer"] == 0 and i > 0:
            x = torch.cat([x, inputs], -1)
    raw_density = M.dense(layers[D], x).reshape(n, s, 1)
    bottleneck = M.dense(layers[D + 1], x)
    condition = condition[:, None, :].expand(n, s, condition.shape[-1]).reshape(n * s, -1)
    x = torch.cat([bottleneck, condition], -1)
    for i in range(net["net_depth_condition"]):
        x = torch.relu(M.dense(layers[D + 2 + i], x))
    raw_rgb = M.dense(layers[D + 2 + net["net_depth_condition"]], x).reshape(n, s, 3)
    return raw_rgb, raw_density


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd: bool):
    """mip.volumetric_rendering: (comp_rgb, distance, acc, weights)."""
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], -1)], -1))
    weights = alpha * trans
    comp_rgb = (weights[..., None] * rgb).sum(-2)
    acc = weights.sum(-1)
    distance = (weights * t_mids).sum(-1) / acc
    distance = torch.clamp(torch.nan_to_num(distance, nan=0.0), t_vals[:, 0], t_vals[:, -1])
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, distance, acc, weights


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int):
    """math.sorted_piecewise_constant_pdf with randomized False."""
    eps = 1e-5
    weight_sum = weights.sum(-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], -1)
    u = linspace(0.0, 1.0 - EPS_F32, num_samples, bins.device).expand(*cdf.shape[:-1], num_samples)
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.where(mask, x[..., None], x[..., :1, None]).amax(-2)
        x1 = torch.where(~mask, x[..., None], x[..., -1:, None]).amin(-2)
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(origins, directions, radii, t_vals, weights, resample_padding: float):
    """mip.resample_along_rays with randomized False: the blurpool, the
    padding, the new t-values and their Gaussians."""
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights = weights_blur + resample_padding
    new_t_vals = sorted_piecewise_constant_pdf(t_vals, weights, t_vals.shape[-1])
    return new_t_vals, cast_rays(new_t_vals, origins, directions, radii)


def render(tree: dict, cfg: dict, o, d, viewdirs, radii, *, disable_integration: bool = False) -> dict:
    """The last level's rgb [N, 3], depth (distance) [N] and acc [N] of rays
    [N, 3] with radii [N, 1]: MipNerfModel at test time, ``cfg`` the
    configuration file (near, far, white background and ``mipnerf``)."""
    net = cfg["mipnerf"]
    near = torch.full_like(o[:, :1], cfg["near"])
    far = torch.full_like(o[:, :1], cfg["far"])
    view_enc = pos_enc(viewdirs, 0, net["deg_view"])
    out = None
    for level in range(net["num_levels"]):
        if level == 0:
            t01 = linspace(0.0, 1.0, net["num_samples"] + 1, o.device)
            t_vals = (near * (1.0 - t01) + far * t01).expand(o.shape[0], -1)
            samples = cast_rays(t_vals, o, d, radii)
        else:
            t_vals, samples = resample_along_rays(o, d, radii, t_vals, weights, net["resample_padding"])
        if disable_integration:
            samples = (samples[0], torch.zeros_like(samples[1]))
        enc = integrated_pos_enc(samples[0], samples[1], net["min_deg_point"], net["max_deg_point"])
        raw_rgb, raw_density = mlp(tree, net, enc, view_enc)
        rgb = torch.sigmoid(raw_rgb) * (1 + 2 * net["rgb_padding"]) - net["rgb_padding"]
        x = raw_density + net["density_bias"]
        density = torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus
        comp_rgb, distance, acc, weights = volumetric_rendering(rgb, density, t_vals, d, cfg["white_bkgd"])
        out = {"rgb": comp_rgb, "depth": distance, "acc": acc}
    return out
