"""Render a list of poses with PSNR, PNGs, psnr.txt and scene data (nerf_sampling_tpu/render/path.py).

The rendering entry point of the port: one render_image per pose (the
"requests"), per-view PSNR against ground truth, ``{i:03d}.png`` and a
``psnr.txt`` with per-image and average lines (and the compare MSE in
COMPARE_NERF), ``render_factor`` downscaling, the ``scene_data.npz``
point cloud, and each pose through a logger's ``log_render`` (its image
and ray plots). With a ``mesh`` (parallel/) each pose renders through
``render_image_sharded``, and every rank gets the whole image; files are
written where ``savedir`` is given, which the Trainer gives on rank 0 only.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from nerf_sampling_tpu_torch.core.metrics import psnr_np, to8b
from nerf_sampling_tpu_torch.core.rays import get_rays_np
from nerf_sampling_tpu_torch.data.blender import write_png
from nerf_sampling_tpu_torch.render.engine import EvalMode, NeRFParams, Pipeline, render_image


def compare_mse(maps: dict[str, torch.Tensor]) -> float:
    """The COMPARE diagnostic: mean over the image of (max_z - z)^2, the
    NeRF's argmax depth [.., 1] broadcast against the DepthNet population's
    z [.., S] (reference nerf_utils.py:318-322). A ray that misses the
    bounding sphere has NaN z, and makes the mean NaN, as in the reference."""
    return float(torch.mean((maps["max_z_vals"] - maps["depth_net_z_vals"]) ** 2))


def render_path(
    pipeline: Pipeline,
    params: NeRFParams,
    render_poses: Sequence[np.ndarray],
    hwf: tuple[int, int, float],
    K: np.ndarray,
    *,
    device: torch.device | str,
    mode: EvalMode = EvalMode.DEPTH_NET,
    chunk: int = 1024 * 32,
    gt_imgs: np.ndarray | None = None,
    savedir: str | None = None,
    render_factor: int = 0,
    save_scene_data: bool = False,
    step: int = 0,
    logger: Any = None,
    verbose: bool = True,
    generator: torch.Generator | None = None,
    mesh: Any = None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Render every pose; return (rgbs [P,H,W,3], disps [P,H,W], avg_psnr).

    ``render_factor`` divides H, W and the focal length (no PSNR then);
    ``save_scene_data`` renders with per-sample outputs (the plain path)
    and writes their points and weights to ``scene_data.npz``. ``logger``
    (utils.logging.MetricsLogger) gets each pose's maps and rays, under
    ``step``.
    """
    render = render_image
    if mesh is not None:  # imported here: parallel/ imports the train steps, which import this package
        from nerf_sampling_tpu_torch.parallel.render import render_image_sharded

        render = functools.partial(render_image_sharded, mesh=mesh)
    H, W, focal = hwf
    if render_factor != 0:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    scored = gt_imgs is not None and render_factor == 0
    rgbs, disps = [], []
    all_pts, all_weights = [], []
    total_psnr, total_mse = 0.0, 0.0
    n_poses = len(render_poses)
    t = time.time()
    for i, c2w in enumerate(render_poses):
        if verbose:
            print(i, time.time() - t)
        t = time.time()
        maps = render(
            pipeline, params, H, W,
            np.asarray(K, np.float32), np.asarray(c2w[:3, :4], np.float32),
            device=device, mode=mode, chunk=chunk, generator=generator, full_outputs=save_scene_data,
        )
        rgb = maps["depth_net_rgb_map"].cpu().numpy()
        disp = maps["depth_net_disp_map"].cpu().numpy()
        rgbs.append(rgb)
        disps.append(disp)

        psnr_info = None
        if scored:
            psnr = psnr_np(rgb, np.asarray(gt_imgs[i]))
            psnr_info = f"{i:03d}.png, PSNR: {psnr}"
            if mode == EvalMode.COMPARE_NERF:
                mse = compare_mse(maps)
                total_mse += mse
                psnr_info += f", MSE: {mse}"
            total_psnr += psnr
            if verbose:
                print(psnr_info)

        if savedir is not None:
            write_png(os.path.join(savedir, f"{i:03d}.png"), to8b(rgb))
            if psnr_info is not None:
                with open(os.path.join(savedir, "psnr.txt"), "a") as fp:
                    fp.write(f"{psnr_info}\n")
                    if i == n_poses - 1:
                        fp.write(f"Avg of {n_poses} images:\nPSNR: {total_psnr / n_poses}\n")
                        if total_mse > 0:
                            fp.write(f"MSE: {total_mse / n_poses}")
            if save_scene_data:
                all_pts.append(maps["depth_net_pts"].cpu().numpy().reshape(-1, 3))
                all_weights.append(maps["depth_net_weights"].cpu().numpy().reshape(-1))

        if logger is not None:  # the ray geometry of the reference's ray plots, on the host
            ro, rd = get_rays_np(H, W, np.asarray(K), np.asarray(c2w[:3, :4]))
            logger.log_render(maps, i, step, rays_o=ro, rays_d=rd)

    if save_scene_data and savedir is not None:
        np.savez(os.path.join(savedir, "scene_data.npz"), all_pts=np.concatenate(all_pts),
                 all_weights=np.concatenate(all_weights))
    avg = total_psnr / n_poses if scored else 0.0
    return np.stack(rgbs, 0), np.stack(disps, 0), avg
