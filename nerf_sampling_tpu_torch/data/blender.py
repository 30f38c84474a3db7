"""Blender synthetic dataset loader (nerf_sampling_tpu/data/blender.py:83).

PNGs are read and written with Pillow (the same codec imageio uses for PNG),
and half resolution is cv2's INTER_AREA, as in the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_sampling_tpu_torch.data.types import SceneData


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world for a spherical orbit pose, in closed form."""
    th, ph = np.deg2rad(theta), np.deg2rad(phi)
    ct, st = np.cos(th), np.sin(th)
    cp, sp = np.cos(ph), np.sin(ph)
    return np.array(
        [
            [-ct, st * sp, st * cp, radius * st * cp],
            [st, ct * sp, ct * cp, radius * ct * cp],
            [0.0, cp, -sp, -radius * sp],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def read_png(path: str) -> np.ndarray:
    """PNG -> uint8 array [H, W, C]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W, C] -> PNG."""
    from PIL import Image

    Image.fromarray(img).save(path)


_SPLITS = ("train", "val", "test")


def _split_frames(basedir: str, split: str, testskip: int) -> tuple:
    """One split's images (uint8 -> unit float) and c2w poses."""
    with open(os.path.join(basedir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)
    step = testskip if (split != "train" and testskip != 0) else 1
    frames = meta["frames"][::step]
    images = np.stack(
        [read_png(os.path.join(basedir, f["file_path"] + ".png")) for f in frames]
    )
    poses = np.stack([f["transform_matrix"] for f in frames]).astype(np.float32)
    return (images / 255.0).astype(np.float32), poses, meta


def _halve_resolution(images: np.ndarray) -> np.ndarray:
    """Area-downsample every image to half size (load_blender.py:88-99)."""
    import cv2

    H2, W2 = images.shape[1] // 2, images.shape[2] // 2
    return np.stack(
        [cv2.resize(im, (W2, H2), interpolation=cv2.INTER_AREA) for im in images]
    )


def load_blender_data(
    basedir: str, half_res: bool = False, testskip: int = 1
) -> SceneData:
    """Load a blender-format scene, keeping all 4 RGBA channels."""
    per_split = {s: _split_frames(basedir, s, testskip) for s in _SPLITS}

    images = np.concatenate([per_split[s][0] for s in _SPLITS], 0)
    poses = np.concatenate([per_split[s][1] for s in _SPLITS], 0)
    edges = np.cumsum([0] + [len(per_split[s][0]) for s in _SPLITS])
    i_train, i_val, i_test = (np.arange(edges[k], edges[k + 1]) for k in range(3))

    H, W = images.shape[1:3]
    camera_angle_x = float(per_split["train"][2]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    orbit = np.linspace(-180, 180, 41)[:-1]
    render_poses = np.stack([pose_spherical(t, -30.0, 4.0) for t in orbit], 0)

    if half_res:
        images = _halve_resolution(images)
        H, W, focal = H // 2, W // 2, focal / 2.0

    return SceneData(
        images=images,
        poses=poses,
        render_poses=render_poses,
        hwf=(int(H), int(W), focal),
        i_train=i_train,
        i_val=i_val,
        i_test=i_test,
        near=2.0,
        far=6.0,
    )
