"""Procedural example scenes (nerf_sampling_tpu/data/example.py).

Scenes ray-traced analytically in numpy and written in the formats the
loaders read, so every path runs with no external data:

- ``generate_example_dataset`` (``-d example``, ``example_hard``): blender
  format; a lambertian sphere of radius 0.9 at the origin, albedo keyed to
  the surface normal (``variant="sphere"``), or three occluding spheres
  with a high-frequency checker albedo (``"multi"``); cameras orbit at
  radius 4, on a white background.
- ``generate_example_llff_dataset`` (``example_llff``): a forward-facing
  scene in LLFF's ``images/`` + ``poses_bounds.npy`` layout.
- ``generate_example_linemod_dataset`` (``example_linemod``) and
  ``generate_example_deepvoxels_dataset`` (``example_deepvoxels``): the
  "multi" scene in those two formats.

``maybe_generate_example_dataset`` maps the five names to them. PNGs are
written with Pillow (``data/blender.py::write_png``).
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

# the "multi" (hard) variant: three spheres of different sizes, all inside
# DepthNet's r=2 bounding sphere, with high-frequency procedural albedo —
# a much harder target than the single lambertian sphere (multiple argmax
# depths per view direction, occlusions, fine texture detail)
_MULTI_OBJECTS = (
    (np.array([-0.70, -0.35, -0.20], np.float32), 0.55,
     np.array([0.95, 0.35, 0.30], np.float32)),
    (np.array([0.65, 0.05, 0.25], np.float32), 0.50,
     np.array([0.30, 0.55, 0.95], np.float32)),
    (np.array([0.05, 0.70, -0.40], np.float32), 0.40,
     np.array([0.35, 0.90, 0.45], np.float32)),
)
_TEX_FREQ = 14.0

# the "llff" (forward-facing) variant: content spread IN DEPTH in front of
# a near-planar camera cluster at z~0 looking down -z — the geometry class
# the NDC parameterization exists for (reference load_llff.py + ndc_rays,
# run_nerf_helpers.py:216-246). Three textured foreground spheres at
# staggered depths plus a huge backdrop sphere so every ray has finite
# depth (like a real captured scene; an infinite background would have
# undefined argmax-depth targets for the DepthNet).
_LLFF_OBJECTS = (
    (np.array([-0.55, -0.20, -2.6], np.float32), 0.45,
     np.array([0.95, 0.40, 0.30], np.float32)),
    (np.array([0.60, 0.15, -3.8], np.float32), 0.60,
     np.array([0.30, 0.55, 0.95], np.float32)),
    (np.array([-0.05, 0.55, -5.2], np.float32), 0.75,
     np.array([0.40, 0.90, 0.45], np.float32)),
    # backdrop: surface crosses z ~ -8 behind the content
    (np.array([0.0, 0.0, -30.0], np.float32), 22.0,
     np.array([0.75, 0.70, 0.60], np.float32)),
)


def _trace_rays(
    ro: np.ndarray, rd: np.ndarray, variant: str, return_t: bool = False
):
    """Shade flat rays analytically -> [N, 3] float32 (white background).

    ``return_t=True`` also returns the per-ray hit distance along the
    NORMALIZED direction (inf where nothing is hit) — the LLFF generator
    derives its per-image poses_bounds depth bounds from it."""
    d = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    if variant == "sphere":
        objects = ((np.zeros(3, np.float32), _SPHERE_R, None),)
    elif variant == "multi":
        objects = _MULTI_OBJECTS
    elif variant == "llff":
        objects = _LLFF_OBJECTS
    else:
        raise ValueError(f"unknown example variant: {variant}")

    n_rays = ro.shape[0]
    best_t = np.full(n_rays, np.inf, np.float32)
    rgb = np.ones((n_rays, 3), np.float32)
    for center, radius, base in objects:
        oc = ro - center
        b = 2 * np.sum(d * oc, -1)
        c = np.sum(oc * oc, -1) - radius**2
        disc = b * b - 4 * c
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2.0, np.inf)
        closer = hit & (t > 1e-3) & (t < best_t)
        # shade with a finite placeholder t for missing rays (their shading
        # is discarded by the `closer` select below) — inf*d would put
        # +inf/-inf into p and make the lambert dot reduce emit NaN
        # RuntimeWarnings that pollute clean artifacts
        p = ro + np.where(np.isfinite(t), t, 0.0)[:, None] * d
        n = (p - center) / radius
        if base is None:  # classic variant: normal-keyed color
            albedo = 0.5 + 0.5 * n
        else:  # hard variant: high-frequency 3D checker over a base color
            tex = (
                np.sin(_TEX_FREQ * p[:, 0])
                * np.sin(_TEX_FREQ * p[:, 1])
                * np.sin(_TEX_FREQ * p[:, 2])
            )
            albedo = base * (0.55 + 0.45 * np.sign(tex)[:, None])
        lambert = np.clip(np.sum(n * _LIGHT, -1, keepdims=True), 0.15, 1.0)
        shaded = albedo * lambert
        rgb = np.where(closer[:, None], shaded, rgb)
        best_t = np.where(closer, t, best_t)
    if return_t:
        return rgb.astype(np.float32), best_t
    return rgb.astype(np.float32)


def _render_analytic(
    H: int, W: int, focal: float, c2w: np.ndarray, variant: str = "sphere"
) -> np.ndarray:
    """Ray-trace the scene analytically -> [H, W, 3] float32."""
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    ro, rd = get_rays_np(H, W, K, c2w.astype(np.float32)[:3, :4])
    rgb = _trace_rays(ro.reshape(-1, 3), rd.reshape(-1, 3), variant)
    return rgb.reshape(H, W, 3)


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
    variant: str = "sphere",
) -> str:
    """Write the example scene to disk in blender transforms_*.json format.

    The result loads through load_blender_data unchanged, so the whole CLI
    stack can be exercised without external data. ``variant="multi"`` is the
    hard proxy scene (3 occluding spheres, high-frequency checker albedo).

    n_train defaults to 100 to match the blender-synthetic convention the
    reference trains on (lego: 100 train views). With only ~20 views the
    DepthNet's origin tower memorizes the per-view-constant ray origins and
    its depth predictions do not generalize to held-out views (measured:
    17x higher fg depth-MSE on test views than train views at 20 views).
    """
    focal = 0.5 * W / np.tan(0.5 * _CAMERA_ANGLE_X)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    os.makedirs(basedir, exist_ok=True)
    for si, (split, n) in enumerate(counts.items()):
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        poses = _orbit_poses(n, si)
        frames = []
        for i, pose in enumerate(poses):
            rgb = _render_analytic(H, W, focal, pose, variant)
            rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
            fname = f"{split}/r_{i}"
            write_png(os.path.join(basedir, fname + ".png"), (rgba * 255).astype(np.uint8))
            frames.append(
                {"file_path": f"./{fname}", "transform_matrix": pose.tolist()}
            )
        meta = {"camera_angle_x": _CAMERA_ANGLE_X, "frames": frames}
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as fp:
            json.dump(meta, fp)
    return basedir


def generate_example_linemod_dataset(
    basedir: str,
    H: int = 400,
    W: int = 400,
    n_train: int = 60,
    n_val: int = 6,
    n_test: int = 4,
) -> str:
    """Write the hard proxy scene in LINEMOD transforms format
    (reference load_LINEMOD.py:45-107): blender-style split jsons whose
    frames carry a per-frame ``intrinsic_matrix`` instead of a global
    camera_angle_x, plus ``near``/``far`` metadata the loader floors/ceils.
    Exercises the K-from-metadata intrinsics path (SceneData.K) end to end.
    """
    focal = 0.5 * W / np.tan(0.5 * _CAMERA_ANGLE_X)
    K = [[focal, 0.0, 0.5 * W], [0.0, focal, 0.5 * H], [0.0, 0.0, 1.0]]
    counts = {"train": n_train, "val": n_val, "test": n_test}
    os.makedirs(basedir, exist_ok=True)
    for si, (split, n) in enumerate(counts.items()):
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        poses = _orbit_poses(n, si)
        frames = []
        for i, pose in enumerate(poses):
            rgb = _render_analytic(H, W, focal, pose, "multi")
            rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
            fname = f"{split}/r_{i}.png"
            write_png(os.path.join(basedir, fname), (rgba * 255).astype(np.uint8))
            frames.append(
                {
                    "file_path": fname,
                    "transform_matrix": pose.tolist(),
                    "intrinsic_matrix": K,
                }
            )
        meta = {"frames": frames, "near": 2.2, "far": 5.8}
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as fp:
            json.dump(meta, fp)
    return basedir


def generate_example_deepvoxels_dataset(
    basedir: str,
    scene: str = "cube",
    n_train: int = 30,
    n_val: int = 8,
    n_test: int = 8,
) -> str:
    """Write the hard proxy scene in DeepVoxels on-disk layout
    (reference load_deepvoxels.py:6-134): {split}/{scene}/intrinsics.txt +
    pose/*.txt (4x4, the loader right-multiplies diag(1,-1,-1,1)) +
    rgb/*.png at the loader's fixed 512x512. Cameras orbit at radius 4,
    so the hemisphere-derived near/far (DeepvoxelsTrainer semantics,
    deepvoxels.py:44-58) come out 3/5 around the r<=1.2 content.
    """
    H = W = 512
    focal = 0.5 * W / np.tan(0.5 * _CAMERA_ANGLE_X)
    transf = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    splits = {"train": n_train, "validation": n_val, "test": n_test}
    for si, (split, n) in enumerate(splits.items()):
        base = os.path.join(basedir, split, scene)
        os.makedirs(os.path.join(base, "pose"), exist_ok=True)
        os.makedirs(os.path.join(base, "rgb"), exist_ok=True)
        with open(os.path.join(base, "intrinsics.txt"), "w") as fp:
            fp.write(f"{focal} {0.5 * W} {0.5 * H} 0.\n")
            fp.write("0. 0. 0.\n")  # grid barycenter
            fp.write("0.\n")  # near plane (unused by the loader)
            fp.write("1.\n")  # scale
            fp.write(f"{H}. {W}.\n")
            fp.write("0\n")  # world2cam flag
        poses = _orbit_poses(n, si)
        for i, pose in enumerate(poses):
            rgb = _render_analytic(H, W, focal, pose, "multi")
            write_png(os.path.join(base, "rgb", f"{i:06d}.png"), (rgb * 255).astype(np.uint8))
            p44 = np.concatenate(
                [pose.astype(np.float32)[:3, :4],
                 np.array([[0, 0, 0, 1]], np.float32)], 0
            )
            # the loader computes c2w = stored @ transf; transf^2 = I
            stored = p44 @ transf
            with open(os.path.join(base, "pose", f"{i:06d}.txt"), "w") as fp:
                fp.write(" ".join(str(float(v)) for v in stored.ravel()))
    return basedir


def _lookat_c2w(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """[right, up, back] c2w rotation + eye translation (OpenGL convention,
    the one get_rays_np expects)."""
    back = eye - target
    back = back / np.linalg.norm(back)
    up_world = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up_world, back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, eye], -1).astype(np.float32)  # [3, 4]


def generate_example_llff_dataset(
    basedir: str,
    H: int = 400,
    W: int = 400,
    n_images: int = 24,
    seed: int = 0,
) -> str:
    """Write a procedural FORWARD-FACING scene in the exact LLFF on-disk
    format the reference reads (load_llff.py:67-76): ``images/`` PNGs +
    ``poses_bounds.npy`` ([N, 17]: 3x5 pose with LLFF [down, right, back]
    rotation columns and an hwf 5th column, then [near, far] depth bounds
    per image from the analytic geometry — the role SfM point depths play
    in real captures).

    Cameras sit on a jittered grid near z=0 (lateral spread +-0.5, depth
    jitter +-0.1) all aimed at a shared convergence point — the capture
    pattern the NDC reprojection (run_nerf_helpers.py:216-246) and the
    recenter/spiral pose math assume. Content spans z in [-2.2, -8.5], so
    after the loader's bd_factor rescale the scene exercises real NDC
    depth range, unlike the blender-format orbit scenes.
    """
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.5 * _CAMERA_ANGLE_X)
    target = np.array([0.0, 0.1, -4.0], np.float32)

    imgdir = os.path.join(basedir, "images")
    os.makedirs(imgdir, exist_ok=True)
    rows = []
    # jittered grid: LLFF-style handheld capture pattern
    side = int(np.ceil(np.sqrt(n_images)))
    lin = np.linspace(-0.5, 0.5, side)
    grid = [(x, y) for y in lin for x in lin][:n_images]
    for i, (gx, gy) in enumerate(grid):
        eye = np.array(
            [
                gx + rng.uniform(-0.04, 0.04),
                gy * 0.6 + rng.uniform(-0.04, 0.04),
                rng.uniform(-0.1, 0.1),
            ],
            np.float32,
        )
        c2w = _lookat_c2w(eye, target)
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
        ro, rd = get_rays_np(H, W, K, c2w)
        rgb, t_hit = _trace_rays(
            ro.reshape(-1, 3), rd.reshape(-1, 3), "llff", return_t=True
        )
        write_png(os.path.join(imgdir, f"image{i:03d}.png"), (rgb.reshape(H, W, 3) * 255).astype(np.uint8))
        # per-image z-depth bounds (distance along the camera forward axis)
        d_norm = rd.reshape(-1, 3)
        d_norm = d_norm / np.linalg.norm(d_norm, axis=-1, keepdims=True)
        fwd = -c2w[:, 2]
        zdepth = t_hit * (d_norm @ fwd)
        zdepth = zdepth[np.isfinite(zdepth)]
        near_i, far_i = float(zdepth.min() * 0.9), float(zdepth.max() * 1.1)
        # stored rotation columns are [down(-up), right, back] — the loader
        # reorders them back with concat([c1, -c0, c2]) (load_llff.py:250)
        rot = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2]], -1)
        pose35 = np.concatenate(
            [rot, c2w[:, 3:4], np.array([[H], [W], [focal]], np.float32)], -1
        )
        rows.append(np.concatenate([pose35.ravel(), [near_i, far_i]]))
    np.save(
        os.path.join(basedir, "poses_bounds.npy"),
        np.stack(rows).astype(np.float64),
    )
    return basedir


# the built-in scenes of ``-d <name>``: (what is generated, the generator and its arguments)
EXAMPLE_DATASETS = {
    "example": ("example", generate_example_dataset, dict(H=800, W=800, variant="sphere")),
    "example_hard": ("example", generate_example_dataset, dict(H=800, W=800, variant="multi")),
    "example_llff": ("example LLFF", generate_example_llff_dataset, dict(H=400, W=400)),
    "example_linemod": ("example LINEMOD", generate_example_linemod_dataset, {}),
    "example_deepvoxels": ("example DeepVoxels", generate_example_deepvoxels_dataset, {}),
}


def maybe_generate_example_dataset(dataset_name: str, datadir: str) -> None:
    """Generate the named built-in scene at ``datadir`` unless the directory
    exists; the one map from ``-d`` names to generators (run.py, render.py
    and study.py). A name that is not built in must name an existing
    directory: otherwise ValueError lists the built-in names."""
    if os.path.exists(datadir):
        return
    if dataset_name not in EXAMPLE_DATASETS:
        raise ValueError(f"no dataset at {datadir}, and {dataset_name!r} is not a built-in scene "
                         f"({', '.join(EXAMPLE_DATASETS)})")
    what, generate, kwargs = EXAMPLE_DATASETS[dataset_name]
    print(f"Generating {what} dataset at {datadir}")
    generate(datadir, **kwargs)
