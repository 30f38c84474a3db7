"""Uniform dataset record shared by the loaders (nerf_sampling_tpu/data/types.py)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SceneData:
    """What a renderer or trainer needs from any dataset."""

    images: np.ndarray  # [N, H, W, 3 or 4] float32 in [0, 1]
    poses: np.ndarray  # [N, 4, 4] or [N, 3, 5] c2w
    render_poses: np.ndarray  # [P, 4, 4] smooth path for videos
    hwf: tuple[int, int, float]
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    near: float
    far: float
    K: np.ndarray | None = None  # optional explicit intrinsics (LINEMOD)

    def composite_white_background(self) -> None:
        """RGBA -> RGB over white (reference Blender.py:26-29)."""
        if self.images.shape[-1] == 4:
            rgb, a = self.images[..., :3], self.images[..., -1:]
            self.images = rgb * a + (1.0 - a)

    def drop_alpha(self) -> None:
        if self.images.shape[-1] == 4:
            self.images = self.images[..., :3]

    def intrinsics(self) -> np.ndarray:
        """K built from hwf unless provided (reference Trainer.py:136-146)."""
        if self.K is not None:
            return self.K
        H, W, focal = self.hwf
        return np.array(
            [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float64
        )
