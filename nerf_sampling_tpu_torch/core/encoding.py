"""Sinusoidal positional encoding (nerf_sampling_tpu/core/encoding.py).

Column order matches the reference: [x, sin(x*f0), cos(x*f0), sin(x*f1), ...],
each sin/cos block spanning all input channels. fp32 with accurate torch.sin:
the 2^9 frequency needs the full mantissa of the argument.
"""

from __future__ import annotations

import dataclasses

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
