"""Optimizers and train state (nerf_sampling_tpu/train/state.py).

- The DepthNet's optimizer is Adam at a constant learning rate (reference
  sampling_trainer.py:78-80 never decays it).
- The NeRF's is Adam at lrate * 0.1^(count / (lrate_decay * 1000))
  (reference Trainer.py:546-551, the JAX ``nerf_lr_schedule``), where
  count is the optimizer's own number of updates (optax's count, restored
  with its moments), not the global step: a run that resumes without
  optimizer state restarts the schedule at lrate, as the JAX Trainer does.

Both use b1 0.9, b2 0.999 and eps 1e-8, optax.adam's update rule. On the
card both are ``capturable`` (their step counts and the update's bias
corrections on the device, the learning rate a 0-d device tensor, the
NeRF's filled from the host schedule before each update), so that a CUDA
graph can hold the update (train/dispatch.py); the per-step loop uses them
too, so one update rule serves both loops. On the CPU they are torch's default Adam.
The update count that the schedule reads is kept on the host
(``TrainState.updates``), read from the optimizer once: a captured step
cannot read a device value.
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
    its optimizer, for a decayed learning rate the schedule of the
    optimizer's update count, and that count on the host (None until the
    first update reads it from the optimizer, whose state a checkpoint may
    have restored after the state was made)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float] | None = None
    updates: int | None = None


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates ``optimizer`` has made (optax's count); a
    device read for a capturable optimizer."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


def update_count(state: TrainState) -> int:
    """The updates ``state.optimizer`` has made, kept on the host."""
    if state.updates is None:
        state.updates = adam_count(state.optimizer)
    return state.updates


def schedule_lr(state: TrainState) -> None:
    """Set the learning rate of the next update from the schedule: into the
    0-d device tensor of a capturable optimizer (a fill, no host sync), or
    the group's float."""
    if state.lr_schedule is None:
        return
    lr = state.lr_schedule(update_count(state))
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def apply_update(state: TrainState) -> None:
    """One optimizer update of ``state.model`` from its gradients, at the
    schedule's learning rate for this update. Inside a CUDA graph's capture
    the learning rate is not set: a fill with this update's value would be
    frozen into the graph, so the dispatcher sets it before each replay."""
    update_count(state)
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        schedule_lr(state)
    state.optimizer.step()
    state.updates += 1


def nerf_lr_schedule(lrate: float, lrate_decay: int) -> Callable[[int], float]:
    """count -> lrate * 0.1^(count / (lrate_decay * 1000)), continuous, in
    fp32 as optax.exponential_decay computes it."""
    steps = np.float32(lrate_decay * 1000)

    def schedule(count: int) -> float:
        return float(np.float32(lrate) * np.float32(0.1) ** (np.float32(count) / steps))

    return schedule


def _adam(model: nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam's Adam of ``model``'s parameters: capturable on the card,
    the learning rate a 0-d fp32 device tensor; torch's default Adam on the
    CPU."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    lr = torch.full((), lr, dtype=torch.float32, device=device)
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=True)


def make_depth_optimizer(model: nn.Module, depth_net_lr: float = 1e-4) -> torch.optim.Adam:
    """Constant-lr Adam for the depth network."""
    return _adam(model, depth_net_lr)


def make_nerf_optimizer(model: nn.Module, lrate: float = 5e-4) -> torch.optim.Adam:
    """Adam for the NeRF; its learning rate is set per update from
    ``nerf_lr_schedule`` (``apply_update``), on the card into its device
    tensor."""
    return _adam(model, lrate)


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
