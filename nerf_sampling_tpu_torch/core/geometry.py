"""Ray-sphere intersection (nerf_sampling_tpu/core/geometry.py:14-53).

Rays that miss the sphere get NaN (sqrt of a negative discriminant), as in
the reference; the NaN carries through to the DepthNet's depth.
"""

from __future__ import annotations

import torch


def solve_quadratic_equation(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
) -> torch.Tensor:
    """Solve ax^2 + bx + c = 0 elementwise -> [2, ...]; NaN without a real root."""
    delta = b**2 - 4 * a * c
    pm = torch.stack([torch.ones_like(delta), -torch.ones_like(delta)])
    return (-b - pm * torch.sqrt(delta)) / (2 * a)


def find_intersection_points_with_sphere(
    origin: torch.Tensor, direction: torch.Tensor, sphere_radius: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intersect [n, 3] rays with an origin-centred sphere.

    Returns t [n, 2] and points [n, 2, 3], NaN where the ray misses.
    """
    b = 2.0 * torch.sum(direction * origin, dim=1)
    c = torch.sum(origin * origin, dim=1) - float(sphere_radius) ** 2
    a = torch.sum(direction * direction, dim=1)
    t = solve_quadratic_equation(a, b, c).T  # [n, 2]
    points = origin[:, None, :] + t[:, :, None] * direction[:, None, :]
    return t, points
