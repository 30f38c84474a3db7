"""PSNR of the committed checkpoint's test views through the JAX package's fp32 path.

    python3 reference_psnr.py [--views 4]

The reference number that ``chip_smoke.py`` gates the port on
(REFERENCE_PSNR_VIEW0). It uses only the JAX package (``nerf_sampling_tpu``),
on whatever backend jax picks, with ``mlp_impl="xla"``: the production
recipe of ``bench.py::production_render_setup`` (DEPTH_NET, uniform
population of 64 samples, distance 1.0, run.py's 10x256 DepthNet) on test
views of the ``example`` scene at 400x400.

The ground truth is made in memory with the JAX package's own scene code:
the analytic 800x800 render, quantized to uint8 as ``generate_example_dataset``
writes it, scaled to [0, 1] and halved with cv2 INTER_AREA as
``load_blender_data(half_res=True)`` reads it. That is the scene on disk
without its PNG round trip (PNG is lossless), so no image library is needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "evidence", "ckpt", "example_depth.npz")
CONFIG = os.path.join(HERE, "nerf_sampling_tpu", "experiments", "configs", "lego.yaml")


def ground_truth(n_views: int, size: int = 800) -> tuple[np.ndarray, np.ndarray, float]:
    """Test views at size/2 on white, their c2w poses [n, 3, 4] and the focal."""
    from nerf_sampling_tpu.data.blender import _halve_resolution
    from nerf_sampling_tpu.data.example import _CAMERA_ANGLE_X, _orbit_poses, _render_analytic

    focal = 0.5 * size / np.tan(0.5 * _CAMERA_ANGLE_X)
    poses = _orbit_poses(4, 2)[:n_views]  # the test split is seed 2 of 4 poses
    images = []
    for pose in poses:
        rgb = _render_analytic(size, size, focal, pose)
        rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
        images.append((rgba * 255).astype(np.uint8))
    images = _halve_resolution((np.stack(images) / 255.0).astype(np.float32))
    rgb, a = images[..., :3], images[..., -1:]
    return rgb * a + (1.0 - a), poses[:, :3, :4].astype(np.float32), focal / 2


def production_pipeline():
    from nerf_sampling_tpu.utils.config import load_trainer_config

    cfg = load_trainer_config(CONFIG, "recommended_depth_net_module")
    # run.py's hard overrides (reference run.py:101-109): the checkpoint's DepthNet is 10x256
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    return dataclasses.replace(
        cfg.pipeline(with_depth=True), n_depth_samples=64, sampling_mode="uniform",
        distance=1.0, mlp_impl="xla",
    )


def load_params(pipeline):
    import jax
    import jax.numpy as jnp

    from nerf_sampling_tpu.models import depth_net_init, nerf_init
    from nerf_sampling_tpu.render import NeRFParams
    from nerf_sampling_tpu.train.checkpoint import load_checkpoint

    k = jax.random.PRNGKey(0)
    template = NeRFParams(coarse=nerf_init(k, pipeline.nerf), fine=nerf_init(k, pipeline.fine),
                          depth=depth_net_init(k, pipeline.depth))
    tree, _ = load_checkpoint(CKPT, {"params": template})
    # the committed storage is fp16; the fp32 path computes in fp32
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float32), tree["params"])


def reference_psnrs(n_views: int, size: int = 800) -> list[tuple[float, float]]:
    """(PSNR, image std) of each of the first ``n_views`` test views."""
    import jax

    from nerf_sampling_tpu.render import EvalMode, render_image

    gts, c2ws, focal = ground_truth(n_views, size)
    H = W = size // 2
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    pipeline = production_pipeline()
    params = load_params(pipeline)
    render = jax.jit(lambda p, c2w: render_image(
        pipeline, p, H=H, W=W, K=K, c2w=c2w, key=jax.random.PRNGKey(0), mode=EvalMode.DEPTH_NET,
    )["depth_net_rgb_map"])
    out = []
    for gt, c2w in zip(gts, c2ws):
        img = np.asarray(render(params, c2w), np.float32)
        if not np.isfinite(img).all():
            raise AssertionError("the reference render is not finite")
        out.append((float(-10 * np.log10(np.mean((img - gt) ** 2))), float(img.std())))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--views", type=int, default=4, choices=range(1, 5))
    args = parser.parse_args()
    import jax

    t0 = time.perf_counter()
    for i, (psnr, std) in enumerate(reference_psnrs(args.views)):
        print(f"view {i}: {psnr:.4f} dB, std {std:.5f}", flush=True)
    print(f"jax {jax.__version__} on {jax.devices()[0]}, {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
