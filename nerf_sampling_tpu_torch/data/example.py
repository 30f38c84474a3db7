"""Procedural example scene (nerf_sampling_tpu/data/example.py:63-210).

A lambertian sphere of radius 0.9 at the origin, albedo keyed to the surface
normal, lit from a fixed direction, on a white background; cameras orbit at
radius 4. Ray-traced analytically in numpy and written in blender format, so
the render path runs with no external data. The JAX package's other
variants and formats wait for ROADMAP S6.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_sampling_tpu_torch.core.rays import get_rays_np
from nerf_sampling_tpu_torch.data.blender import pose_spherical, write_png

_SPHERE_R = 0.9
_LIGHT = np.array([0.577, 0.577, 0.577], dtype=np.float32)
_CAMERA_ANGLE_X = 0.6911112070083618  # standard blender-synthetic FOV


def _trace_rays(ro: np.ndarray, rd: np.ndarray) -> np.ndarray:
    """Shade flat rays analytically -> [N, 3] float32 (white background)."""
    d = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    b = 2 * np.sum(d * ro, -1)
    c = np.sum(ro * ro, -1) - _SPHERE_R**2
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2.0, np.inf)
    closer = hit & (t > 1e-3) & (t < np.inf)
    p = ro + np.where(np.isfinite(t), t, 0.0)[:, None] * d
    n = p / _SPHERE_R
    lambert = np.clip(np.sum(n * _LIGHT, -1, keepdims=True), 0.15, 1.0)
    rgb = np.where(closer[:, None], (0.5 + 0.5 * n) * lambert, np.ones((ro.shape[0], 3), np.float32))
    return rgb.astype(np.float32)


def _render_analytic(H: int, W: int, focal: float, c2w: np.ndarray) -> np.ndarray:
    """Ray-trace the scene analytically -> [H, W, 3] float32."""
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    ro, rd = get_rays_np(H, W, K, c2w.astype(np.float32)[:3, :4])
    return _trace_rays(ro.reshape(-1, 3), rd.reshape(-1, 3)).reshape(H, W, 3)


def _orbit_poses(n: int, seed: int, phi_range=(-60.0, -10.0)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    thetas = rng.uniform(-180, 180, n)
    phis = rng.uniform(*phi_range, n)
    return np.stack([pose_spherical(t, p, 4.0) for t, p in zip(thetas, phis)], 0)


def generate_example_dataset(
    basedir: str,
    H: int = 100,
    W: int = 100,
    n_train: int = 100,
    n_val: int = 10,
    n_test: int = 4,
) -> str:
    """Write the example scene to ``basedir`` in blender transforms_*.json format."""
    focal = 0.5 * W / np.tan(0.5 * _CAMERA_ANGLE_X)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    os.makedirs(basedir, exist_ok=True)
    for si, (split, n) in enumerate(counts.items()):
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        frames = []
        for i, pose in enumerate(_orbit_poses(n, si)):
            rgb = _render_analytic(H, W, focal, pose)
            rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
            fname = f"{split}/r_{i}"
            write_png(os.path.join(basedir, fname + ".png"), (rgba * 255).astype(np.uint8))
            frames.append({"file_path": f"./{fname}", "transform_matrix": pose.tolist()})
        meta = {"camera_angle_x": _CAMERA_ANGLE_X, "frames": frames}
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as fp:
            json.dump(meta, fp)
    return basedir
