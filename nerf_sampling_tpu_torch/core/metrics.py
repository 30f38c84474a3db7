"""Image metrics (nerf_sampling_tpu/core/metrics.py)."""

from __future__ import annotations

import math

import numpy as np
import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two images or ray batches."""
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 * log10(mse)."""
    return -10.0 * torch.log(mse) / math.log(10.0)


def psnr_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """Host-side PSNR over full images (reference nerf_utils.py:306-308)."""
    return float(-10.0 * np.log10(np.mean(np.square(pred - gt))))


def to8b(x: np.ndarray) -> np.ndarray:
    """Clip to [0, 1] and quantize to uint8 for PNG export."""
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)
