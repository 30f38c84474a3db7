"""Back-to-back mip-NeRF frames through the render engine, one in flight (a closed loop).

The model is mip-NeRF at its published widths, its weights drawn from the
seed as mip-NeRF initialises them (``reference/mipnerf.py``'s ``glorot``),
handed as raw arrays to the reference and to the program's loader. Each
frame is a new camera from the seed's stream, rendered by ``render_image``
(FULL_NERF: K11, both levels in one launch) and complete when its maps
(rgb, depth, acc) are on the host. ``Cell`` is a subclass of
``render_frames``': the frames, the window, its spans (``engine``,
``to_host``) and its slice are that driver's.

``correct``: once the window has closed, a sample of the completed frames
drawn from the seed, and of each one's rays, is rendered again by the
plain reference (``reference/mipnerf.py``) and compared as ``render_frames``
compares: the worst sampled frame's rgb mean squared gap, its mean depth gap
over the rays the reference finds opaque (acc > 0.5) and its mean acc gap.

Variants, for ``readings.py``: "program"; "no_integration", the program
with mip-NeRF's ``disable_integration`` (the kernel's IPE without the
variances: a different model, a fault the check must catch);
"control_fp8", the reference in the program's place with every MLP
product's operands rounded to fp8 (e4m3, per-tensor scale). A cell that
ran no window (``readings.py``: set-up, release, check) renders the frames
its check samples as it is released.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_port import traffic as T
from bench_port.drivers import render_frames
from bench_port.drivers.render_frames import gap
from bench_port.drivers.train_chunks import rounded_operands
from bench_port.reference import mipnerf as RM
from bench_port.reference.model import strict_fp32, to_torch
from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig, load_raw
from nerf_sampling_tpu_torch.render.engine import NeRFParams, Pipeline, make_nerf_slices, pack_kernel_weights

BLOCK = 4096  # rays a reference block (its interval search holds [rays, S + 1, S + 1])


def model_config(cfg: dict, **overrides) -> MipNeRFConfig:
    """The program's MipNeRFConfig of the configuration file (cones, t linear
    in depth, no density noise: what the program renders)."""
    net = cfg["mipnerf"]
    if (net["ray_shape"], net["lindisp"], net["density_noise"]) != ("cone", False, 0.0):
        raise ValueError("the program renders cones, linear in depth, without density noise")
    fields = {f.name for f in dataclasses.fields(MipNeRFConfig)}
    return MipNeRFConfig(**{k: v for k, v in net.items() if k in fields}, **overrides)


class Cell(render_frames.Cell):
    """A subclass of ``render_frames``' ``Cell``: its frames, window, spans
    and check, with mip-NeRF's set-up and reference."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.windowed = False

    def setup(self) -> None:
        t = self.traffic
        self.raw = RM.glorot(self.seed, self.cfg["mipnerf"])
        self.K = T.intrinsics(self.size, t["camera_angle_x"])
        self.poses = T.orbit_poses(self.seed, t["n_poses"], t)
        if self.variant == "control_fp8":  # readings only: no program, no window
            return
        over = {"disable_integration": True} if self.variant == "no_integration" else {}
        mc = model_config(self.cfg, **over)
        self.pipe = Pipeline(nerf=mc, near=self.cfg["near"], far=self.cfg["far"], white_bkgd=self.cfg["white_bkgd"],
                             mlp_impl="cuda", matmul_precision=self.cfg["matmul_precision"])
        model = load_raw(MipNeRF(mc), self.raw).to(self.device)
        self.params = pack_kernel_weights(NeRFParams(coarse=model))
        make_nerf_slices(self.params.kernels)
        for c2w in T.orbit_poses(self.seed, 2, t, "warm-up"):
            self._frame(c2w, keep=False)

    def window(self, seconds: float, tracer) -> dict:
        """``render_frames``' window, and the widths of the run's configuration,
        which ``roofline.mip_kernel`` reads."""
        self.windowed = True
        return {**super().window(seconds, tracer), "mipnerf": self.cfg["mipnerf"]}

    def release(self) -> None:
        if self.variant == "control_fp8":
            return
        if not self.windowed:  # readings.py: the frames its check samples
            self.run_frames(self.traffic["check_frames"])
        super().release()

    def gaps(self) -> dict[str, float]:
        """The numbers compared: the worst sampled frame's ``rgb_mse``,
        ``depth_gap`` (opaque rays) and ``acc_gap``."""
        t = self.traffic
        rng = T.stream(self.seed, "check")
        n = len(self.frames) if self.variant != "control_fp8" else t["check_frames"]
        picks = rng.choice(n, size=min(t["check_frames"], n), replace=False)
        net = to_torch(self.raw, self.device)
        rgb = depth = acc = 0.0
        for f in picks:
            i = int(f) if self.variant == "control_fp8" else self.frames[int(f)][0]
            rows = np.arange(self.size * self.size)
            if t.get("check_rays"):
                rows = np.sort(rng.choice(rows.size, size=t["check_rays"], replace=False))
            rays = RM.rays(self.size, float(self.K[0, 0]), self.poses[i % len(self.poses)], rows, self.device)
            want = reference(net, self.cfg, *rays)
            if self.variant == "control_fp8":
                with rounded_operands():
                    got = reference(net, self.cfg, *rays)
            else:
                got = self.frames[int(f)][1][torch.from_numpy(rows)].to(self.device)
            rgb = max(rgb, gap(((got[:, :3] - want[:, :3]) ** 2).mean(1)))
            fg = want[:, 4] > 0.5
            depth = max(depth, gap((got[fg, 3] - want[fg, 3]).abs()))
            acc = max(acc, gap((got[:, 4] - want[:, 4]).abs()))
        return {"rgb_mse": rgb, "depth_gap": depth, "acc_gap": acc}


@torch.no_grad()
def reference(net: dict, cfg: dict, o, d, viewdirs, radii) -> torch.Tensor:
    """[n, 5] maps (rgb, depth, acc) of the plain reference, in blocks of rays."""
    out = []
    with strict_fp32():
        for s in range(0, o.shape[0], BLOCK):
            r = RM.render(net, cfg, o[s:s + BLOCK], d[s:s + BLOCK], viewdirs[s:s + BLOCK], radii[s:s + BLOCK])
            out.append(torch.cat([r["rgb"], r["depth"][:, None], r["acc"][:, None]], -1))
    return torch.cat(out)
