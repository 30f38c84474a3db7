"""mip-NeRF's model as an nn.Module (Barron et al., ICCV 2021; google/mipnerf ``internal/models.py``).

``MipNeRFConfig`` holds ``MipNerfModel``'s fields that a render reads: the
MLP's widths (``MLP``'s defaults), the encodings' degrees, the samples per
level, the resampling padding and the output activations' constants.
``MipNeRF`` is ``MLP``: ``net_depth`` ReLU layers of ``net_width`` over the
integrated positional encoding of a conical frustum (no identity), the
encoding concatenated after every ``skip_layer``-th layer (``[h, inputs]``),
a density head on the trunk, a bottleneck, concatenated with the view
encoding, ``net_depth_condition`` ReLU layers of ``net_width_condition`` and
the rgb head. One MLP serves every level. It returns the raw outputs; the
render applies softplus(raw density + density_bias) and
sigmoid(raw rgb) (1 + 2 rgb_padding) - rgb_padding.

``init_glorot`` draws mip-NeRF's initialisation (glorot-uniform kernels,
zero biases) from a torch generator; ``load_raw`` loads a raw tree of
``[in, out]`` kernels in flax's layer order (``{"mlp": [{"weight",
"bias"}, ...]}``). ``render_levels`` is the model's render at test time
(cones, t linear in depth), given how to query the MLP: the port's plain
route queries the module, K11's plain version the kernel's bf16 chain.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from nerf_sampling_tpu_torch.core.compositing import composite_intervals
from nerf_sampling_tpu_torch.core.encoding import cast_intervals
from nerf_sampling_tpu_torch.core.sampling import interval_t_vals, resample_intervals


@dataclasses.dataclass(frozen=True)
class MipNeRFConfig:
    """mip-NeRF's model fields (``MipNerfModel`` and ``MLP`` defaults)."""

    net_depth: int = 8
    net_width: int = 256
    skip_layer: int = 4
    net_depth_condition: int = 1
    net_width_condition: int = 128
    min_deg_point: int = 0
    max_deg_point: int = 16
    deg_view: int = 4
    num_samples: int = 128
    num_levels: int = 2
    resample_padding: float = 0.01
    density_bias: float = -1.0
    rgb_padding: float = 0.001
    # mip-NeRF's own option: the encoding of the means alone (every variance 0)
    disable_integration: bool = False

    @property
    def input_ch(self) -> int:
        return 6 * (self.max_deg_point - self.min_deg_point)

    @property
    def input_ch_views(self) -> int:
        return 3 + 6 * self.deg_view

    def skip_after(self, i: int) -> bool:
        """Whether the inputs join the trunk after layer i."""
        return i % self.skip_layer == 0 and i > 0


class MipNeRF(nn.Module):
    def __init__(self, cfg: MipNeRFConfig):
        super().__init__()
        self.cfg = cfg
        W, C = cfg.net_width, cfg.input_ch
        widths = [C] + [W + C if cfg.skip_after(i) else W for i in range(cfg.net_depth - 1)]
        self.pts_linears = nn.ModuleList([nn.Linear(n, W) for n in widths])
        last = W + C if cfg.skip_after(cfg.net_depth - 1) else W
        self.density_linear = nn.Linear(last, 1)
        self.bottleneck_linear = nn.Linear(last, W)
        conds = [W + cfg.input_ch_views] + [cfg.net_width_condition] * (cfg.net_depth_condition - 1)
        self.views_linears = nn.ModuleList([nn.Linear(n, cfg.net_width_condition) for n in conds])
        self.rgb_linear = nn.Linear(cfg.net_width_condition, 3)

    def layers(self) -> list[nn.Linear]:
        """Every layer in flax's creation order (the raw tree's)."""
        return [*self.pts_linears, self.density_linear, self.bottleneck_linear, *self.views_linears, self.rgb_linear]

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(raw rgb [..., 3], raw density [..., 1]) of encoded samples x [..., C]
        under their view encodings [..., Cv]."""
        inputs = h = x
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if self.cfg.skip_after(i):
                h = torch.cat([h, inputs], -1)
        raw_density = self.density_linear(h)
        h = torch.cat([self.bottleneck_linear(h), condition], -1)
        for layer in self.views_linears:
            h = F.relu(layer(h))
        return self.rgb_linear(h), raw_density


@torch.no_grad()
def init_glorot(model: MipNeRF, generator: torch.Generator | None = None) -> MipNeRF:
    """mip-NeRF's initialisation: every kernel glorot-uniform, every bias zero."""
    for layer in model.layers():
        n_out, n_in = layer.weight.shape
        a = math.sqrt(6.0 / (n_in + n_out))
        layer.weight.copy_(torch.rand(layer.weight.shape, generator=generator) * (2 * a) - a)
        layer.bias.zero_()
    return model


@torch.no_grad()
def load_raw(model: MipNeRF, tree: dict) -> MipNeRF:
    """Loads ``{"mlp": [{"weight": [in, out], "bias": [out]}, ...]}`` (flax's
    layer order, numpy or torch leaves) into ``model``; raises on a shape
    that does not fit."""
    layers = model.layers()
    if len(tree["mlp"]) != len(layers):
        raise ValueError(f"the raw tree has {len(tree['mlp'])} layers, the model {len(layers)}")
    for layer, raw in zip(layers, tree["mlp"]):
        w = torch.as_tensor(raw["weight"], dtype=torch.float32).T
        b = torch.as_tensor(raw["bias"], dtype=torch.float32)
        if tuple(w.shape) != tuple(layer.weight.shape) or tuple(b.shape) != tuple(layer.bias.shape):
            raise ValueError(f"a raw layer of {tuple(w.T.shape)} does not fit {tuple(layer.weight.T.shape)}")
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    return model


def render_levels(cfg: MipNeRFConfig, rays_o: torch.Tensor, rays_d: torch.Tensor, radii: torch.Tensor, near: float,
                  far: float, white_bkgd: bool, query) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mip-NeRF at test time (``MipNerfModel.__call__``, randomized off) over
    rays [N, 3] with radii [N, 1]: the first level's intervals from near to
    far, each next level's resampled from the last one's weights; each
    interval's Gaussian (its covariance 0 under ``disable_integration``);
    ``query(mean, cov, last)`` -> (raw rgb [N, S, 3], or None where ``last``
    is False, raw density [N, S]); softplus(raw + density_bias),
    sigmoid(raw) (1 + 2 rgb_padding) - rgb_padding and the interval
    compositing. Returns the last level's rgb [N, 3], distance [N], acc [N]."""
    t_vals = interval_t_vals(torch.full_like(radii, near), torch.full_like(radii, far), cfg.num_samples)
    weights = None
    for level in range(cfg.num_levels):
        last = level == cfg.num_levels - 1
        if level > 0:
            t_vals = resample_intervals(t_vals, weights, cfg.resample_padding)
        mean, cov = cast_intervals(t_vals, rays_o, rays_d, radii)
        if cfg.disable_integration:
            cov = torch.zeros_like(cov)
        raw_rgb, raw_density = query(mean, cov, last)
        x = raw_density + cfg.density_bias
        density = torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus
        rgb = (torch.sigmoid(raw_rgb) * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding if raw_rgb is not None
               else density.new_zeros(*density.shape, 3))
        rgb_map, distance, acc, weights = composite_intervals(rgb, density, t_vals, rays_d, white_bkgd)
    return rgb_map, distance, acc
