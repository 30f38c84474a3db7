"""DepthNet as an nn.Module (nerf_sampling_tpu/models/depth_net.py:35-147).

Module layout follows the reference (depth_nets/depth_net.py:22-116), so its
state dicts load with strict=True: three skip-concat towers (origin,
direction, the flattened [N, 6] ray-sphere intersections), each applied
WITHOUT activation (the reference builds LeakyReLUs there but never calls
them); a trunk over cat([o_out, d_out, i_out, o_emb, d_emb, i_emb]) with
LeakyReLU(0.01); a sigmoid head scaled to [near, far]. Rays that miss the
bounding sphere give NaN depth.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from nerf_sampling_tpu_torch.core import prng
from nerf_sampling_tpu_torch.core.encoding import Embedder
from nerf_sampling_tpu_torch.core.geometry import find_intersection_points_with_sphere


@dataclasses.dataclass(frozen=True)
class DepthNetConfig:
    """Static DepthNet architecture config (reference DepthNet.__init__)."""

    hidden_sizes: tuple[int, ...] = (128, 128, 128, 128, 128, 128)
    cat_hidden_sizes: tuple[int, ...] = (128, 128, 128, 128, 256)
    origin_channels: int = 3
    direction_channels: int = 3
    multires: int = 10
    sphere_radius: float = 2.0
    near: float = 2.0
    far: float = 6.0

    @property
    def origin_dims(self) -> int:
        return Embedder(self.origin_channels, self.multires).out_dim

    @property
    def direction_dims(self) -> int:
        return Embedder(self.direction_channels, self.multires).out_dim

    @property
    def intersection_dims(self) -> int:
        return Embedder(6, self.multires).out_dim


def _tower(hidden: tuple[int, ...], emb_dim: int, skip_dim: int) -> nn.Sequential:
    layers = [nn.Linear(emb_dim + emb_dim, hidden[0])]
    for i, size in enumerate(hidden[:-1]):
        layers.append(nn.Linear(size + skip_dim, hidden[i + 1]))
    return nn.Sequential(*layers)


def _tower_apply(tower: nn.Sequential, emb: torch.Tensor) -> torch.Tensor:
    h = emb
    for layer in tower:
        h = layer(torch.cat([h, emb], -1))
    return h


class DepthNet(nn.Module):
    def __init__(self, cfg: DepthNetConfig):
        super().__init__()
        self.cfg = cfg
        H, C = cfg.hidden_sizes, cfg.cat_hidden_sizes
        eo, ed, ei = cfg.origin_dims, cfg.direction_dims, cfg.intersection_dims
        self.origin_layers = _tower(H, eo, eo)
        # sic: the reference sizes the direction tower's skips with origin_dims
        self.direction_layers = _tower(H, ed, eo)
        self.intersection_layers = _tower(H, ei, ei)
        cat = [nn.Linear(H[-1] * 3 + eo + ed + ei, C[0]), nn.LeakyReLU()]
        for i, size in enumerate(C[:-1]):
            cat += [nn.Linear(size, C[i + 1]), nn.LeakyReLU()]
        self.cat_layers = nn.Sequential(*cat)
        self.to_depth = nn.Sequential(nn.Linear(C[-1], 1), nn.Sigmoid())

    def embed(self, rays_o: torch.Tensor, rays_d: torch.Tensor):
        """(origin, direction, intersection) embeddings of [N, 3] rays."""
        cfg = self.cfg
        _, inters = find_intersection_points_with_sphere(rays_o, rays_d, cfg.sphere_radius)
        return (
            Embedder(cfg.origin_channels, cfg.multires)(rays_o),
            Embedder(cfg.direction_channels, cfg.multires)(rays_d),
            Embedder(6, cfg.multires)(inters.reshape(rays_o.shape[0], 6)),
        )

    def forward(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
        """Predicted depth [N, 1] for [N, 3] rays."""
        o_emb, d_emb, i_emb = self.embed(rays_o, rays_d)
        h = torch.cat(
            [
                _tower_apply(self.origin_layers, o_emb),
                _tower_apply(self.direction_layers, d_emb),
                _tower_apply(self.intersection_layers, i_emb),
                o_emb,
                d_emb,
                i_emb,
            ],
            -1,
        )
        depth = self.to_depth(self.cat_layers(h))
        return self.cfg.near * (1 - depth) + self.cfg.far * depth


def init_like_jax(model: DepthNet, key) -> DepthNet:
    """``model``'s weights as the JAX package's ``depth_net_init(key, cfg)``
    draws them (core/prng.py): one key of ``split(key, n)`` per dense
    layer, in the order origin tower, direction tower, intersection tower,
    trunk, depth head."""
    linears = [*model.origin_layers, *model.direction_layers, *model.intersection_layers,
               *(m for m in model.cat_layers if isinstance(m, nn.Linear)), model.to_depth[0]]
    prng.init_linears(zip(linears, prng.split(key, len(linears))))
    return model
