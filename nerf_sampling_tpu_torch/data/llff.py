"""LLFF forward-facing dataset loader: poses_bounds.npy + images/ (nerf_sampling_tpu/data/llff.py).

The reference's load_llff.py and LLFTrainer.load_data (LLF.py:45-86):
images downsampled by a factor or to a resolution, the bounds rescaled
by ``bd_factor``, the poses recentered, optionally spherified, a spiral
render path (or the ``path_zflat`` half spiral), the ``llffhold`` test
split and the NDC-or-bounds near/far. The reference's ``_minify`` calls
ImageMagick's ``mogrify``; this loader downsamples with cv2 INTER_AREA in
process into the same cache directories (``images_{factor}`` /
``images_{W}x{H}``). PNGs are read and written with Pillow, without gamma
(the reference reads them with ``ignoregamma``). The pose math is
``core/poses.py``.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_sampling_tpu_torch.core.poses import normalize, poses_avg, recenter_poses, render_path_spiral, spherify_poses
from nerf_sampling_tpu_torch.data.blender import read_png, write_png
from nerf_sampling_tpu_torch.data.types import SceneData

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def _image_files(imgdir: str) -> list[str]:
    return [f for f in sorted(os.listdir(imgdir)) if f.lower().endswith(_IMAGE_EXTS)]


def _minify(basedir: str, factor: int | None = None, resolution: tuple[int, int] | None = None) -> str:
    """The downsampled image directory, made if absent: ``images_{factor}/``
    at 1/factor size, or ``images_{W}x{H}/`` for resolution=(H, W)
    (the reference's naming, load_llff.py:36-42)."""
    import cv2

    if resolution is not None:
        h, w = resolution
        imgdir = os.path.join(basedir, f"images_{w}x{h}")
    else:
        imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return imgdir
    srcdir = os.path.join(basedir, "images")
    os.makedirs(imgdir)
    print("Minifying", factor if resolution is None else resolution, basedir)
    for f in _image_files(srcdir):
        img = read_png(os.path.join(srcdir, f))
        if resolution is not None:
            new_wh = (resolution[1], resolution[0])
        else:
            hh, ww = img.shape[:2]
            new_wh = (ww // factor, hh // factor)
        small = cv2.resize(img, new_wh, interpolation=cv2.INTER_AREA)
        write_png(os.path.join(imgdir, os.path.splitext(f)[0] + ".png"), small)
    return imgdir


def _load_data(basedir: str, factor: int | None = None, width: int | None = None, height: int | None = None):
    """(poses [3, 5, N], bds [2, N], imgs [H, W, 3, N]) from poses_bounds.npy
    and the (downsampled) images (reference load_llff.py:67-133)."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    srcdir = os.path.join(basedir, "images")
    sh0 = read_png(os.path.join(srcdir, _image_files(srcdir)[0])).shape

    if factor is not None and factor != 1:
        imgdir = _minify(basedir, factor=factor)
    elif height is not None:
        factor = sh0[0] / float(height)
        width = int(sh0[1] / factor)
        imgdir = _minify(basedir, resolution=(height, width))
    elif width is not None:
        factor = sh0[1] / float(width)
        height = int(sh0[0] / factor)
        imgdir = _minify(basedir, resolution=(height, width))
    else:
        factor = 1
        imgdir = srcdir

    imgfiles = [os.path.join(imgdir, f) for f in _image_files(imgdir)]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    sh = read_png(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = np.stack([read_png(f)[..., :3] / 255.0 for f in imgfiles], -1)
    return poses, bds, imgs


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float | None = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
    width: int | None = None,
    height: int | None = None,
):
    """(images, poses [N, 3, 5], bds, render_poses, i_test): the reference's
    load_llff_data (load_llff.py:267-343)."""
    poses, bds, imgs = _load_data(basedir, factor=factor, width=width, height=height)
    print("Loaded", basedir, bds.min(), bds.max())

    # rotation columns: LLFF's [down, right, back] -> [right, up, back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / (((1.0 - dt) / close_depth + dt / inf_depth))
        rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:  # the flattened half spiral (load_llff.py:317-323)
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views /= 2
        render_poses = render_path_spiral(c2w_path, up, rads, focal, zrate=0.5, rots=N_rots, N=N_views)

    render_poses = np.array(render_poses).astype(np.float32)
    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    print("HOLDOUT view is", i_test)
    return images, poses, bds, render_poses, i_test


def load_llff_scene(cfg) -> SceneData:
    """LLFTrainer.load_data -> SceneData. Writes near/far into ``cfg``
    (0, 1 under NDC; 0.9 of the smallest bound and the largest under
    ``no_ndc``): the pipeline is built from them afterwards."""
    images, poses, bds, render_poses, i_test = load_llff_data(
        cfg.datadir, cfg.factor, recenter=True, bd_factor=0.75, spherify=cfg.spherify,
        path_zflat=getattr(cfg, "path_zflat", False),
    )
    hwf = poses[0, :3, -1]
    poses = poses[:, :3, :4]
    i_test = [i_test]
    if cfg.llffhold > 0:
        print("Auto LLFF holdout,", cfg.llffhold)
        i_test = np.arange(images.shape[0])[:: cfg.llffhold]
    i_test = np.asarray(i_test)
    i_train = np.array([i for i in np.arange(images.shape[0]) if i not in i_test])
    if cfg.no_ndc:
        near, far = float(bds.min()) * 0.9, float(bds.max()) * 1.0
    else:
        near, far = 0.0, 1.0
    print("NEAR FAR", near, far)
    cfg.near, cfg.far = near, far
    return SceneData(
        images=images,
        poses=poses,
        render_poses=render_poses[:, :3, :4],  # the 5th column carries hwf
        hwf=(int(hwf[0]), int(hwf[1]), float(hwf[2])),
        i_train=i_train,
        i_val=i_test,
        i_test=i_test,
        near=near,
        far=far,
    )
