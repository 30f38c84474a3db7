"""Optimizers and train state (nerf_sampling_tpu/train/state.py).

- The DepthNet's optimizer is Adam at a constant learning rate (reference
  sampling_trainer.py:78-80 never decays it).
- The NeRF's is Adam at lrate * 0.1^(count / (lrate_decay * 1000))
  (reference Trainer.py:546-551, the JAX ``nerf_lr_schedule``), where
  count is the optimizer's own number of updates (optax's count, restored
  with its moments), not the global step: a run that resumes without
  optimizer state restarts the schedule at lrate, as the JAX Trainer does.

Both use b1 0.9, b2 0.999 and eps 1e-8, optax.adam's update rule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """One optimized model: its step count, the module (updated in place),
    its optimizer and, for a decayed learning rate, the schedule of the
    optimizer's update count."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float] | None = None


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates ``optimizer`` has made (optax's count)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


def apply_update(state: TrainState) -> None:
    """One optimizer update of ``state.model`` from its gradients, at the
    schedule's learning rate for this update."""
    if state.lr_schedule is not None:
        lr = state.lr_schedule(adam_count(state.optimizer))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()


def nerf_lr_schedule(lrate: float, lrate_decay: int) -> Callable[[int], float]:
    """count -> lrate * 0.1^(count / (lrate_decay * 1000)), continuous, in
    fp32 as optax.exponential_decay computes it."""
    steps = np.float32(lrate_decay * 1000)

    def schedule(count: int) -> float:
        return float(np.float32(lrate) * np.float32(0.1) ** (np.float32(count) / steps))

    return schedule


def make_depth_optimizer(model: nn.Module, depth_net_lr: float = 1e-4) -> torch.optim.Adam:
    """Constant-lr Adam for the depth network."""
    return torch.optim.Adam(model.parameters(), lr=depth_net_lr, betas=(0.9, 0.999), eps=1e-8)


def make_nerf_optimizer(model: nn.Module, lrate: float = 5e-4) -> torch.optim.Adam:
    """Adam for the NeRF; its learning rate is set per update from
    ``nerf_lr_schedule`` (``apply_update``)."""
    return torch.optim.Adam(model.parameters(), lr=lrate, betas=(0.9, 0.999), eps=1e-8)


def init_state(model: nn.Module, depth_net_lr: float = 1e-4, step: int = 0) -> TrainState:
    return TrainState(step, model, make_depth_optimizer(model, depth_net_lr))


def init_nerf_state(model: nn.Module, lrate: float = 5e-4, lrate_decay: int = 250,
                    step: int = 0) -> TrainState:
    """The NeRF's state: ``model`` is the ``nerf_modules`` of coarse and fine."""
    return TrainState(step, model, make_nerf_optimizer(model, lrate), nerf_lr_schedule(lrate, lrate_decay))


def nerf_modules(coarse: nn.Module, fine: nn.Module | None) -> nn.ModuleDict:
    """The NeRFs that train together, as one module (parameter names
    ``coarse.*`` and ``fine.*``)."""
    mods = {"coarse": coarse}
    if fine is not None:
        mods["fine"] = fine
    return nn.ModuleDict(mods)
