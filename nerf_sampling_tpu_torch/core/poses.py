"""LLFF-lineage camera-pose math, numpy on the host (nerf_sampling_tpu/core/poses.py).

The pose processing every NeRF codebase inherits from the LLFF project
(github.com/Fyusion/LLFF, BSD) through bmild/nerf and nerf-pytorch, which
the reference copies too (load_llff.py:136-264, :296-330): the average-pose
viewmatrix, recentering, the spiral render path and the 360
spherification down to its [0.1, 0.2, 0.3] cross-product seed. It stays
operation for operation that lineage's, so poses agree with datasets and
checkpoints made by it. It runs once per dataset load.
"""

from __future__ import annotations

import numpy as np


def normalize(x: np.ndarray) -> np.ndarray:
    """Unit-normalize a vector (load_llff.py:136-137)."""
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Camera-to-world [3, 4] from forward/up/position (load_llff.py:140-145)."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average pose [3, 5] (center / mean z / mean up; load_llff.py:155-163)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def render_path_spiral(c2w, up, rads, focal, zrate, rots, N):
    """Spiral of render poses around the average pose (load_llff.py:166-180).

    N may arrive as a float when halved by path_zflat (the reference does
    ``N_views /= 2``, load_llff.py:322) — np.linspace accepts it; the
    trailing pose is dropped as upstream does.
    """
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, int(N) + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly move all poses so their average is the identity
    (load_llff.py:183-194)."""
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_44 = np.linalg.inv(c2w) @ poses_44
    poses_[:, :3, :4] = poses_44[:, :3, :4]
    return poses_


def spherify_poses(poses, bds):
    """Re-center 360 captures on the point nearest all camera axes and build
    a circular render path (load_llff.py:198-264)."""
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ (b_i).mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        -1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        -1,
    )
    return poses_reset, new_poses, bds
