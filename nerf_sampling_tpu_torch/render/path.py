"""Render a list of poses with PSNR, PNGs and psnr.txt (nerf_sampling_tpu/render/path.py).

The rendering entry point of the port: one render_image per pose (the
"requests"), per-view PSNR against ground truth, ``{i:03d}.png`` and a
``psnr.txt`` with per-image and average lines. ``render_factor``, the
scene-data export and multi-device rendering wait for ROADMAP S4/S7.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from nerf_sampling_tpu_torch.core.metrics import psnr_np, to8b
from nerf_sampling_tpu_torch.data.blender import write_png
from nerf_sampling_tpu_torch.render.engine import EvalMode, NeRFParams, Pipeline, render_image


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
    verbose: bool = True,
    generator: torch.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Render every pose; return (rgbs [P,H,W,3], disps [P,H,W], avg_psnr)."""
    H, W, _ = hwf
    rgbs, disps = [], []
    total_psnr = 0.0
    n_poses = len(render_poses)
    t = time.time()
    for i, c2w in enumerate(render_poses):
        if verbose:
            print(i, time.time() - t)
        t = time.time()
        maps = render_image(
            pipeline, params, H, W,
            np.asarray(K, np.float32), np.asarray(c2w[:3, :4], np.float32),
            device=device, mode=mode, chunk=chunk, generator=generator,
        )
        rgb = maps["depth_net_rgb_map"].cpu().numpy()
        disp = maps["depth_net_disp_map"].cpu().numpy()
        rgbs.append(rgb)
        disps.append(disp)

        psnr_info = None
        if gt_imgs is not None:
            psnr = psnr_np(rgb, np.asarray(gt_imgs[i]))
            psnr_info = f"{i:03d}.png, PSNR: {psnr}"
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
    avg = total_psnr / n_poses if gt_imgs is not None else 0.0
    return np.stack(rgbs, 0), np.stack(disps, 0), avg
