"""Step-rate accounting (nerf_sampling_tpu/utils/profiling.py:23-53).

``StepTimer`` counts steps and, where it reads the clock, first waits for
the device (``torch.cuda.synchronize``): PyTorch returns before a CUDA
step finishes, so an unsynchronized clock measures the enqueue.
"""

from __future__ import annotations

import time

import torch


class StepTimer:
    """Steady-state throughput meter: call tick() once per step."""

    def __init__(self, rays_per_step: int, warmup: int = 10, device: torch.device | str = "cpu"):
        self.rays_per_step = rays_per_step
        self.warmup = warmup
        self.device = torch.device(device)
        self._count = 0
        self._t0: float | None = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def tick(self) -> None:
        self._count += 1
        if self._count == self.warmup:
            self._t0 = self._now()

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._count <= self.warmup:
            return 0.0
        return (self._count - self.warmup) / (self._now() - self._t0)

    def metrics(self) -> dict[str, float]:
        sps = self.steps_per_sec  # one clock read
        return {"steps_per_sec": sps, "rays_per_sec": sps * self.rays_per_step}
