"""LINEMOD dataset loader (nerf_sampling_tpu/data/linemod.py).

The reference's load_LINEMOD.py:45-107 and LinemodTrainer (Linemod.py:
44-63): blender-style transforms jsons whose frames carry their own
``intrinsic_matrix`` (the train split's first one goes into
``SceneData.K``), near and far from the metadata (floor of the smaller,
ceil of the larger), ``half_res`` through cv2 INTER_AREA, and
white-background compositing. PNGs are read with Pillow.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_sampling_tpu_torch.data.blender import pose_spherical, read_png
from nerf_sampling_tpu_torch.data.types import SceneData


def load_linemod_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """(imgs, poses, render_poses, [H, W, focal], K, i_split, near, far)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for idx, frame in enumerate(metas[s]["frames"][::skip]):
            fname = frame["file_path"]
            if not os.path.isabs(fname):
                fname = os.path.join(basedir, fname)
            if s == "test":
                print(f"{idx}th test frame: {fname}")
            imgs.append(read_png(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.array(poses).astype(np.float32))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    K = np.array(metas["train"]["frames"][0]["intrinsic_matrix"], dtype=np.float64)
    focal = float(K[0][0])
    print(f"Focal: {focal}")

    render_poses = np.stack([pose_spherical(a, -30.0, 4.0) for a in np.linspace(-180, 180, 41)[:-1]], 0)

    if half_res:
        import cv2

        H, W = H // 2, W // 2
        focal = focal / 2.0
        K = K.copy()
        K[:2] = K[:2] / 2.0
        imgs_half = np.zeros((imgs.shape[0], H, W, imgs.shape[-1]), dtype=np.float32)
        for i, img in enumerate(imgs):
            imgs_half[i] = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        imgs = imgs_half

    near = float(np.floor(min(metas["train"]["near"], metas["test"]["near"])))
    far = float(np.ceil(max(metas["train"]["far"], metas["test"]["far"])))
    return imgs, poses, render_poses, [H, W, focal], K, i_split, near, far


def load_linemod_scene(cfg) -> SceneData:
    """LinemodTrainer.load_data -> SceneData; writes near/far into ``cfg``."""
    images, poses, render_poses, hwf, K, i_split, near, far = load_linemod_data(
        cfg.datadir, cfg.half_res, cfg.testskip)
    print(f"Loaded LINEMOD, images shape: {images.shape}, hwf: {hwf}, K: {K}")
    print(f"near: {near}, far: {far}.")
    cfg.near, cfg.far = near, far
    scene = SceneData(
        images=images,
        poses=poses,
        render_poses=render_poses,
        hwf=(int(hwf[0]), int(hwf[1]), float(hwf[2])),
        i_train=i_split[0],
        i_val=i_split[1],
        i_test=i_split[2],
        near=near,
        far=far,
        K=np.asarray(K, dtype=np.float64),
    )
    if cfg.white_bkgd and scene.images.shape[-1] == 4:
        scene.composite_white_background()
    else:
        scene.drop_alpha()
    return scene
