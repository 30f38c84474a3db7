"""NeRF MLP as an nn.Module (nerf_sampling_tpu/models/nerf.py:28-112).

Attribute names follow the reference (run_nerf_helpers.py:67-134), so its
state dicts load with strict=True. The skip layer re-concatenates the input
points FIRST: cat([input_pts, h]) after the ReLU of layer ``skips``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from nerf_sampling_tpu_torch.core import prng


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Static NeRF architecture config (reference NeRF.__init__ args)."""

    D: int = 8
    W: int = 256
    input_ch: int = 3
    input_ch_views: int = 3
    output_ch: int = 4
    skips: tuple[int, ...] = (4,)
    use_viewdirs: bool = False


class NeRF(nn.Module):
    def __init__(self, cfg: NeRFConfig):
        super().__init__()
        self.cfg = cfg
        W, C = cfg.W, cfg.input_ch
        self.pts_linears = nn.ModuleList(
            [nn.Linear(C, W)]
            + [nn.Linear(W + C if i in cfg.skips else W, W) for i in range(cfg.D - 1)]
        )
        if cfg.use_viewdirs:
            self.feature_linear = nn.Linear(W, W)
            self.alpha_linear = nn.Linear(W, 1)
            self.views_linears = nn.ModuleList([nn.Linear(cfg.input_ch_views + W, W // 2)])
            self.rgb_linear = nn.Linear(W // 2, 3)
        else:
            self.output_linear = nn.Linear(W, cfg.output_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Embedded input [..., input_ch + input_ch_views] -> raw [..., 4]."""
        cfg = self.cfg
        input_pts = x[..., : cfg.input_ch]
        input_views = x[..., cfg.input_ch : cfg.input_ch + cfg.input_ch_views]
        h = input_pts
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in cfg.skips:
                h = torch.cat([input_pts, h], -1)
        if not cfg.use_viewdirs:
            return self.output_linear(h)
        alpha = self.alpha_linear(h)
        h = torch.cat([self.feature_linear(h), input_views], -1)
        for layer in self.views_linears:
            h = F.relu(layer(h))
        return torch.cat([self.rgb_linear(h), alpha], -1)


def init_like_jax(model: NeRF, key) -> NeRF:
    """``model``'s weights as the JAX package's ``nerf_init(key, cfg)`` draws
    them (core/prng.py): key i of ``split(key, D + 4)`` for trunk layer i,
    then the feature, alpha, views and rgb layers (D .. D + 3), or the
    output layer (D) without view directions."""
    D = model.cfg.D
    keys = prng.split(key, D + 4)
    layers = list(zip(model.pts_linears, keys[:D]))
    if model.cfg.use_viewdirs:
        layers += [(model.feature_linear, keys[D]), (model.alpha_linear, keys[D + 1]),
                   (model.views_linears[0], keys[D + 2]), (model.rgb_linear, keys[D + 3])]
    else:
        layers.append((model.output_linear, keys[D]))
    prng.init_linears(layers)
    return model
