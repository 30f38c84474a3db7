"""DeepVoxels dataset loader (nerf_sampling_tpu/data/deepvoxels.py).

The reference's load_deepvoxels.py:6-134 and DeepvoxelsTrainer
(deepvoxels.py:44-58): ``intrinsics.txt``, the per-split ``pose/`` and
``rgb/`` directories at the fixed 512x512, the test poses as the render
path, and near/far one unit either side of the mean camera radius. PNGs
are read with Pillow.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_sampling_tpu_torch.data.blender import read_png
from nerf_sampling_tpu_torch.data.types import SceneData


def _parse_intrinsics(filepath: str, trgt_sidelength: int, invert_y: bool = False):
    """(full_intrinsic [4, 4], grid_barycenter, scale, near_plane, world2cam_poses)."""
    with open(filepath) as file:
        f, cx, cy = list(map(float, file.readline().split()))[:3]
        grid_barycenter = np.array(list(map(float, file.readline().split())))
        near_plane = float(file.readline())
        scale = float(file.readline())
        height, width = map(float, file.readline().split())
        try:
            world2cam_poses = bool(int(file.readline()))
        except ValueError:
            world2cam_poses = False

    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    f = trgt_sidelength / height * f
    fy = -f if invert_y else f
    full_intrinsic = np.array([[f, 0.0, cx, 0.0], [0.0, fy, cy, 0], [0.0, 0, 1, 0], [0, 0, 0, 1]])
    return full_intrinsic, grid_barycenter, scale, near_plane, world2cam_poses


def _load_pose(filename: str) -> np.ndarray:
    with open(filename) as fp:
        nums = fp.read().split()
    return np.array([float(x) for x in nums]).reshape([4, 4]).astype(np.float32)


def _dir2poses(posedir: str) -> np.ndarray:
    """The c2w [N, 3, 4] of a pose directory: each stored matrix times diag(1, -1, -1, 1)."""
    poses = np.stack([_load_pose(os.path.join(posedir, f)) for f in sorted(os.listdir(posedir))
                      if f.endswith("txt")], 0)
    transf = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
    return (poses @ transf)[:, :3, :4].astype(np.float32)


def _load_split_imgs(imgdir: str, skip: int = 1) -> np.ndarray:
    files = [f for f in sorted(os.listdir(imgdir)) if f.endswith("png")]
    return np.stack([read_png(os.path.join(imgdir, f)) / 255.0 for f in files[::skip]], 0).astype(np.float32)


def load_dv_data(scene: str = "cube", basedir: str = "/data/deepvoxels", testskip: int = 8):
    """(imgs, poses, render_poses, [H, W, focal], i_split)."""
    H = W = 512
    base = os.path.join(basedir, "train", scene)
    full_intrinsic, *_ = _parse_intrinsics(os.path.join(base, "intrinsics.txt"), H)
    focal = full_intrinsic[0, 0]

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(os.path.join(basedir, "test", scene, "pose"))[::testskip]
    valposes = _dir2poses(os.path.join(basedir, "validation", scene, "pose"))[::testskip]

    imgs = _load_split_imgs(os.path.join(base, "rgb"))
    testimgs = _load_split_imgs(os.path.join(basedir, "test", scene, "rgb"), testskip)
    valimgs = _load_split_imgs(os.path.join(basedir, "validation", scene, "rgb"), testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    return (np.concatenate(all_imgs, 0), np.concatenate([poses, valposes, testposes], 0), testposes,
            [H, W, focal], i_split)


def load_deepvoxels_scene(cfg) -> SceneData:
    """DeepvoxelsTrainer.load_data -> SceneData; writes near/far into ``cfg``."""
    images, poses, render_poses, hwf, i_split = load_dv_data(
        scene=cfg.shape, basedir=cfg.datadir, testskip=cfg.testskip)
    print("Loaded deepvoxels", images.shape, render_poses.shape, hwf, cfg.datadir)
    hemi_R = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
    near, far = hemi_R - 1.0, hemi_R + 1.0
    cfg.near, cfg.far = near, far
    return SceneData(
        images=images,
        poses=poses,
        render_poses=render_poses,
        hwf=(int(hwf[0]), int(hwf[1]), float(hwf[2])),
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=near,
        far=far,
    )
