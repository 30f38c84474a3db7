"""Metrics logging (nerf_sampling_tpu/utils/logging.py).

wandb when it is installed and ``wandb_mode`` is not "disabled"; an
append-only ``metrics.jsonl`` in the experiment directory in every case
(the only stream when wandb is missing, with the JAX logger's message);
and the ``psnr.txt`` side channel of the reference (Trainer.py:389-391):
every ``i_print`` line is printed and appended there in the JAX package's
format. wandb and matplotlib are imported where they are used: the GPU
machine has neither.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MetricsLogger:
    def __init__(self, logdir: str, wandb_mode: str = "disabled", config: Any = None, enabled: bool = True):
        """``enabled=False`` makes every method a no-op (no file, no wandb
        run): the JAX logger's switch for processes that do not own the
        experiment directory."""
        self.logdir = logdir
        self.enabled = enabled
        self._jsonl = None
        self._wandb = None
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if wandb_mode != "disabled":
            try:
                import wandb
            except ImportError:
                print("[logging] wandb not installed; falling back to jsonl")
            else:
                wandb.init(project="nerf-sampling-tpu", config=vars(config) if config is not None else None,
                           mode=wandb_mode, dir=logdir)
                self._wandb = wandb

    def log(self, metrics: dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def print_line(self, info: str) -> None:
        """Print an ``Iter: ...`` line and append it to psnr.txt."""
        if not self.enabled:
            return
        print(info)
        with open(os.path.join(self.logdir, "psnr.txt"), "a") as f:
            f.write(f"{info}\n")

    def log_render(self, maps: dict, pose_idx: int, step: int, rays_o=None, rays_d=None) -> None:
        """One rendered pose (reference log_wandb, nerf_utils.py:363-390): the
        image to wandb, and a plot of 5 of its rays with their sampled
        points (blue) and, where the mode has them, the NeRF's argmax points
        (black), to wandb or else to ``ray_plots/rays_{step:06d}_{pose:03d}``
        .png and .pkl (viz.visualize.view_plot reopens it). The kernel paths
        return no per-sample points, so they get no plot; nor does a run
        without matplotlib."""
        if not self.enabled:
            return
        if self._wandb is not None:
            self._wandb.log({f"render_{step}/pose_{pose_idx}": self._wandb.Image(_np(maps["depth_net_rgb_map"]))})
        pts = maps.get("depth_net_pts")
        if pts is None or rays_o is None or rays_d is None or pts.shape[-2] == 0:
            return
        pts = _np(pts).reshape(-1, pts.shape[-2], 3)  # [H*W, S, 3]
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        from nerf_sampling_tpu_torch.viz import visualize

        ro, rd = _np(rays_o).reshape(-1, 3), _np(rays_d).reshape(-1, 3)
        idx = np.random.default_rng(pose_idx).choice(len(ro), size=min(5, len(ro)), replace=False)
        fig, ax = visualize.visualize_rays_pts(
            rays_o=ro[idx], rays_d=rd[idx], pts=pts[idx], c=[[(0.0, 0.0, 1.0)]],
            title="{:03d}.png, y_pred: blue, y: black".format(pose_idx),
        )
        max_pts = maps.get("max_pts")
        if max_pts is not None:  # COMPARE_NERF and NERF_MAX
            visualize._plot_points(ax, _np(max_pts).reshape(-1, 3)[idx], c=[[(0.0, 0.0, 0.0)]])
        if self._wandb is not None:
            self._wandb.log({f"Ray plot {step}": self._wandb.Image(fig)})
        else:
            plotdir = os.path.join(self.logdir, "ray_plots")
            os.makedirs(plotdir, exist_ok=True)
            base = os.path.join(plotdir, f"rays_{step:06d}_{pose_idx:03d}")
            fig.savefig(base + ".png")
            visualize.save_figure_pickle(fig, base + ".pkl")
        plt.close(fig)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
