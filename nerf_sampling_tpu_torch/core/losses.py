"""Loss functions for the depth network (nerf_sampling_tpu/core/losses.py).

The reference's loss_functions.py:8-50. The live training loss is a plain
MSE between the DepthNet's depth and the argmax-weight depth (reference
Trainer.py:537); these auxiliary losses are kept for capability parity.
"""

from __future__ import annotations

import math
from enum import Enum

import torch


def alphas_or_weights_loss(alphas_or_weights: torch.Tensor) -> torch.Tensor:
    """1 - mean(x): minimizing drives alphas or weights (in [0, 1]) toward 1."""
    return 1 - torch.mean(alphas_or_weights)


def mean_density_loss(density: torch.Tensor) -> torch.Tensor:
    """-mean(density): minimizing maximizes density."""
    return -torch.mean(density)


def gaussian_distribution(x: torch.Tensor, m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The Gaussian pdf at x, mean m, std s."""
    return 1 / (s * math.sqrt(2 * math.pi)) * torch.exp(-0.5 * ((x - m) / s) ** 2)


def gaussian_log_likelihood(x: torch.Tensor, m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Negative Gaussian log-likelihood (reference loss_functions.py:35-42)."""
    N = x.shape[1]
    term1 = (-N / 2.0) * torch.log(2 * math.pi * s**2)
    term2 = (1 / (2 * s**2)) * torch.sum((x - m) ** 2)
    return -(term1 - term2)


class SamplerLossInput(Enum):
    """Options for the depth-net loss's input (reference loss_functions.py:45-50)."""

    DENSITY = 0
    ALPHAS = 1
    WEIGHTS = 2
