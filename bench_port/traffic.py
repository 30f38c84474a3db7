"""The general traffic generator: what a cell's data file asks for, made from the seed.

Every seed gets the same sizes and the same amount of work in another
order: the same frame size and number of train views, the same batch
size; only the cameras, the target colours and the draws differ.

- Cameras on the Blender orbit (the synthetic scenes' camera path): radius
  ``radius``, azimuth uniform over [-180, 180) degrees, elevation uniform
  over ``elevation`` degrees, looking at the origin; intrinsics from
  ``camera_angle_x`` at the frame's width.
- Train targets: ``n_train`` images of uniform random colours. They enter
  only the loss.
- Step seeds: a pure function of (seed, step), 31 bits, as a trainer
  derives them.
"""

from __future__ import annotations

import numpy as np


def stream(seed: int, what: str) -> np.random.Generator:
    """An independent numpy stream of the run's seed for one purpose."""
    return np.random.default_rng([int(seed), sum(ord(c) << (8 * i) for i, c in enumerate(what)) & 0xFFFFFFFF])


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world [4, 4] of the orbit camera at azimuth theta and
    elevation phi (degrees), nerf-pytorch's ``pose_spherical`` in closed form."""
    th, ph = np.deg2rad(theta), np.deg2rad(phi)
    ct, st, cp, sp = np.cos(th), np.sin(th), np.cos(ph), np.sin(ph)
    return np.array([[-ct, st * sp, st * cp, radius * st * cp],
                     [st, ct * sp, ct * cp, radius * ct * cp],
                     [0.0, cp, -sp, -radius * sp],
                     [0.0, 0.0, 0.0, 1.0]], np.float32)


def orbit_poses(seed: int, n: int, traffic: dict, what: str = "poses") -> np.ndarray:
    """n camera poses [n, 4, 4] drawn from the seed."""
    rng = stream(seed, what)
    theta = rng.uniform(-180.0, 180.0, n)
    phi = rng.uniform(*traffic["elevation"], n)
    return np.stack([pose_spherical(t, p, traffic["radius"]) for t, p in zip(theta, phi)])


def intrinsics(size: int, camera_angle_x: float) -> np.ndarray:
    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    return np.array([[focal, 0.0, 0.5 * size], [0.0, focal, 0.5 * size], [0.0, 0.0, 1.0]], np.float32)


def train_images(seed: int, n: int, size: int) -> np.ndarray:
    """[n, size, size, 3] float32 targets in [0, 1)."""
    return stream(seed, "targets").random((n, size, size, 3), dtype=np.float32)


def step_seed(seed: int, i: int) -> int:
    """The seed of train step i."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1)[0] >> 1)
