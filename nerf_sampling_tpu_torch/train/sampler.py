"""Host-side random ray batches (nerf_sampling_tpu/train/sampler.py).

The same ``np.random.default_rng(seed)`` stream and the same calls as the
JAX sampler, so both packages draw bit-identical batches:

- per-image mode (no_batching): a random train image, N_rand pixels without
  replacement, an optional center precrop for the first precrop_iters
  steps; ``single_image`` pins image 42, ``single_ray`` pins flat pixel 91;
- batching mode: rays of every train image, shuffled, walked in N_rand
  windows and reshuffled each epoch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nerf_sampling_tpu_torch.core.rays import get_rays_np
from nerf_sampling_tpu_torch.data.types import SceneData
from nerf_sampling_tpu_torch.utils import profiling


@dataclasses.dataclass
class SamplerConfig:
    N_rand: int = 1024
    use_batching: bool = False
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    single_image: bool = False
    single_ray: bool = False


class RaySampler:
    """Stateful host sampler; yields (rays_o, rays_d, target) numpy batches."""

    def __init__(self, scene: SceneData, cfg: SamplerConfig, seed: int = 42):
        self.scene = scene
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.K = scene.intrinsics()
        self.H, self.W, _ = scene.hwf
        self._rays_rgb = None
        self._i_batch = 0
        self._ray_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._coords_cache: dict[bool, np.ndarray] = {}
        if cfg.use_batching:
            self._build_batched_rays()

    def _build_batched_rays(self) -> None:
        """Stack and shuffle all train rays (reference Trainer.py:236-260)."""
        scene = self.scene
        rays = np.stack(
            [np.stack(get_rays_np(self.H, self.W, self.K, p[:3, :4]), 0)
             for p in scene.poses[scene.i_train]],
            0,
        )  # [N, 2, H, W, 3]
        rgb = scene.images[scene.i_train][:, None]  # [N, 1, H, W, 3]
        rays_rgb = np.concatenate([rays, rgb], 1)
        rays_rgb = np.transpose(rays_rgb, [0, 2, 3, 1, 4])  # [N, H, W, 3, 3]
        rays_rgb = rays_rgb.reshape(-1, 3, 3).astype(np.float32)
        self.rng.shuffle(rays_rgb)
        self._rays_rgb = rays_rgb
        self._i_batch = 0

    def sample(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Ray batch for train iteration ``i`` (the recorder's ``nst.sampler.sample`` span)."""
        with profiling.span("nst.sampler.sample"):
            if self.cfg.use_batching:
                return self._sample_batched()
            return self._sample_per_image(i)

    def _sample_batched(self):
        n = self.cfg.N_rand
        batch = self._rays_rgb[self._i_batch : self._i_batch + n]
        self._i_batch += n
        if self._i_batch >= self._rays_rgb.shape[0]:
            perm = self.rng.permutation(self._rays_rgb.shape[0])
            self._rays_rgb = self._rays_rgb[perm]
            self._i_batch = 0
        return batch[:, 0], batch[:, 1], batch[:, 2]

    def _sample_per_image(self, i: int):
        scene, cfg = self.scene, self.cfg
        if cfg.single_image:
            # raw image id 42 when it is a train image, else a fixed train image
            if 42 in scene.i_train:
                img_i = 42
            else:
                img_i = int(scene.i_train[42 % len(scene.i_train)])
        else:
            img_i = self.rng.choice(scene.i_train)
        target = scene.images[img_i]
        if img_i not in self._ray_cache:  # per-image rays, cached as float32
            ro, rd = get_rays_np(self.H, self.W, self.K, scene.poses[img_i, :3, :4])
            self._ray_cache[img_i] = (
                np.ascontiguousarray(ro, dtype=np.float32),
                np.ascontiguousarray(rd, dtype=np.float32),
            )
        rays_o, rays_d = self._ray_cache[img_i]

        precrop = i < cfg.precrop_iters
        coords = self._coords_cache.get(precrop)
        if coords is None:
            if precrop:
                dH = int(self.H // 2 * cfg.precrop_frac)
                dW = int(self.W // 2 * cfg.precrop_frac)
                rows = np.arange(self.H // 2 - dH, self.H // 2 + dH)
                cols = np.arange(self.W // 2 - dW, self.W // 2 + dW)
            else:
                rows, cols = np.arange(self.H), np.arange(self.W)
            coords = np.stack(np.meshgrid(rows, cols, indexing="ij"), -1).reshape(-1, 2)
            self._coords_cache[precrop] = coords

        if cfg.single_ray:
            select = np.array([91])  # fixed pixel (reference Trainer.py:459-461)
        else:
            select = self.rng.choice(coords.shape[0], size=cfg.N_rand, replace=False)
        sc = coords[select]
        return (
            rays_o[sc[:, 0], sc[:, 1]].astype(np.float32),
            rays_d[sc[:, 0], sc[:, 1]].astype(np.float32),
            target[sc[:, 0], sc[:, 1]].astype(np.float32),
        )
