"""Optimizer and train state (nerf_sampling_tpu/train/state.py).

The DepthNet's optimizer is Adam at a constant learning rate with
b1 0.9, b2 0.999 and eps 1e-8, optax.adam's update rule (reference
sampling_trainer.py:78-80 never decays it). The NeRF's decayed Adam comes
with NeRF training (ROADMAP S3).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """One optimized model: its step count, the module (updated in place)
    and its optimizer."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def make_depth_optimizer(model: nn.Module, depth_net_lr: float = 1e-4) -> torch.optim.Adam:
    """Constant-lr Adam for the depth network."""
    return torch.optim.Adam(model.parameters(), lr=depth_net_lr, betas=(0.9, 0.999), eps=1e-8)


def init_state(model: nn.Module, depth_net_lr: float = 1e-4, step: int = 0) -> TrainState:
    return TrainState(step, model, make_depth_optimizer(model, depth_net_lr))
