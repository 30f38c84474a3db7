"""Back-to-back frames through the render engine, one in flight (a closed loop).

Each frame is a new camera from the seed's stream, rendered by
``render_image`` and complete when its maps (rgb, depth, acc) are on the
host, as a user of the renderer receives them. The window renders frames
until ``seconds`` have passed and the frame in flight has landed; every
frame's latency is taken from the call to its maps on the host.

``correct``: once the window has closed, a sample of the completed frames
drawn from the seed (and, where the workload says so, a sample of each
one's rays) is rendered again by the plain reference from the raw
checkpoint arrays and compared: the worst sampled frame's rgb mean squared
gap, its mean depth gap over the rays the reference finds opaque (acc >
0.5) and its mean acc gap.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port import traffic as T
from bench_port.drivers import port
from bench_port.harness import Check, checkpoint
from bench_port.reference import model as M
from nerf_sampling_tpu_torch.data.types import SceneData
from nerf_sampling_tpu_torch.render.engine import EvalMode, eval_packs, make_nerf_slices, pack_kernel_weights, \
    render_image
from nerf_sampling_tpu_torch.render.quantize import calibrate_pipeline

BLOCK = 8192  # rays a reference block


class Cell:
    """``variant``: "program" (the configuration's kernels), or "control"
    (the program's own int8 path, ``mlp_impl="cuda_int8"``)."""

    def __init__(self, workload: dict, config: dict, seed: int, device: torch.device, spans, variant: str = "program"):
        self.wl, self.cfg, self.seed, self.device, self.spans = workload, config, seed, device, spans
        self.traffic = workload["traffic"]
        self.variant = variant
        self.mode = EvalMode[self.traffic["mode"]]
        self.size = self.traffic["size"]
        self.frames: list[tuple[int, torch.Tensor]] = []  # (pose index, host maps [H*W, 5])
        self.latencies: list[float] = []

    def setup(self) -> None:
        t = self.traffic
        self.raw = checkpoint(self.cfg)
        with_depth = self.mode == EvalMode.DEPTH_NET
        pipe = port.pipeline(self.cfg, "cuda_int8" if self.variant == "control" else "cuda", **t["pipeline"])
        params = port.modules(pipe, self.raw, self.device, with_depth)
        self.K = T.intrinsics(self.size, t["camera_angle_x"])
        self.poses = T.orbit_poses(self.seed, t["n_poses"], t)
        if self.variant == "control":
            scene = SceneData(images=np.zeros((1, 1, 1, 3), np.float32), poses=self.poses[:1], render_poses=self.poses[:1],
                              hwf=(self.size, self.size, float(self.K[0, 0])), i_train=np.array([0]),
                              i_val=np.array([], int), i_test=np.array([], int), near=self.cfg["near"],
                              far=self.cfg["far"], K=self.K)
            pipe = calibrate_pipeline(pipe, params, scene)
        params = pack_kernel_weights(params, **eval_packs(pipe, self.mode, params))
        make_nerf_slices(params.kernels)
        self.pipe, self.params = pipe, params
        for c2w in T.orbit_poses(self.seed, 2, t, "warm-up"):
            self._frame(c2w, keep=False)

    def _frame(self, c2w: np.ndarray, keep: bool = True) -> torch.Tensor:
        t0 = time.perf_counter()
        with self.spans("engine"):
            out = render_image(self.pipe, self.params, self.size, self.size, self.K, c2w[:3, :4],
                               device=self.device, mode=self.mode)
        with self.spans("to_host"):
            maps = torch.cat([out["depth_net_rgb_map"], out["depth_net_z_vals"][..., None],
                              out["depth_net_weights"][..., None]], -1).reshape(-1, 5).cpu()
        if keep:
            self.latencies.append(time.perf_counter() - t0)
        return maps

    def run_frames(self, n: int) -> None:
        for _ in range(n):
            i = len(self.frames)
            self.frames.append((i, self._frame(self.poses[i % len(self.poses)])))

    def window(self, seconds: float, tracer) -> dict:
        a, b = self.traffic["trace_frames"]
        t0 = time.perf_counter()
        slice_units = 0
        while not self.frames or time.perf_counter() - t0 < seconds:
            if len(self.frames) == a and tracer.enabled:
                with tracer.slice():
                    self.run_frames(b - a)
                slice_units = b - a
            else:
                self.run_frames(1)
        window_s = time.perf_counter() - t0
        n = len(self.frames)
        return {"window_s": window_s, "units": n, "rays": n * self.size * self.size,
                "latencies_s": list(self.latencies), "slice_units": slice_units,
                "attempted": n, "failed": sum(not bool(torch.isfinite(m).all()) for _, m in self.frames)}

    def release(self) -> None:
        del self.params, self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[Check]:
        gaps = self.gaps()
        return [Check(name, gaps[name], limit) for name, limit in self.wl["limits"].items()]

    def gaps(self) -> dict[str, float]:
        """The numbers compared: the worst sampled frame's ``rgb_mse``,
        ``depth_gap`` (opaque rays) and ``acc_gap``."""
        t = self.traffic
        rng = T.stream(self.seed, "check")
        n = len(self.frames)
        picks = rng.choice(n, size=min(t["check_frames"], n), replace=False)
        net = M.to_torch(self.raw, self.device)
        cfg, pipe_cfg = self.cfg, t["pipeline"]
        rgb = depth = acc = 0.0
        for f in picks:
            i, maps = self.frames[int(f)]
            rows = np.arange(self.size * self.size)
            if t.get("check_rays"):
                rows = np.sort(rng.choice(rows.size, size=t["check_rays"], replace=False))
            o, d = rays(self.size, self.K, self.poses[i % len(self.poses)], rows, self.device)
            want = reference(net, cfg, pipe_cfg, self.mode, o, d)
            got = maps[torch.from_numpy(rows)].to(self.device)
            rgb = max(rgb, gap(((got[:, :3] - want[:, :3]) ** 2).mean(1)))
            fg = want[:, 4] > 0.5
            depth = max(depth, gap((got[fg, 3] - want[fg, 3]).abs()))
            acc = max(acc, gap((got[:, 4] - want[:, 4]).abs()))
        return {"rgb_mse": rgb, "depth_gap": depth, "acc_gap": acc}


def gap(x: torch.Tensor) -> float:
    """The mean of a gap (0 over no rays), or inf when a value the reference has is missing (non-finite)."""
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    return float(x.mean()) if x.numel() else 0.0


def rays(size: int, K: np.ndarray, c2w: np.ndarray, rows: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Origins and directions [n, 3] of the frame's pixels ``rows`` (row-major),
    the pinhole camera of nerf-pytorch's ``get_rays``."""
    j, i = np.divmod(rows, size)
    dirs = np.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -np.ones(rows.size)], -1).astype(np.float32)
    R = c2w[:3, :3].astype(np.float32)
    d = torch.from_numpy((dirs[:, None, :] * R).sum(-1)).to(device)
    o = torch.from_numpy(np.broadcast_to(c2w[:3, 3], (rows.size, 3)).astype(np.float32)).to(device)
    return o, d


@torch.no_grad()
def reference(net: dict, cfg: dict, pipe_cfg: dict, mode: EvalMode, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[n, 5] maps (rgb, depth, acc) of the plain reference, in blocks of rays."""
    out = []
    with M.strict_fp32():
        for s in range(0, o.shape[0], BLOCK):
            ob, db = o[s:s + BLOCK], d[s:s + BLOCK]
            if mode == EvalMode.DEPTH_NET:
                dn = cfg["depth_net"]
                z = M.depth_net(net["depth"], ob, db, multires=dn["multires"], radius=dn["sphere_radius"],
                                near=cfg["near"], far=cfg["far"])
                z = M.uniform_population(z, pipe_cfg["n_depth_samples"], pipe_cfg["distance"], cfg["near"], cfg["far"])
                pts = ob[:, None, :] + db[:, None, :] * z[..., None]
                viewdirs = db / torch.linalg.norm(db, dim=-1, keepdim=True)
                r = M.composite(M.query(net["fine"], pts, viewdirs, cfg["nerf"]["multires"],
                                        cfg["nerf"]["multires_views"]), z, db)
            else:
                r = M.hierarchical(net["coarse"], net["fine"], ob, db, n_coarse=cfg["N_samples"],
                                   n_fine=cfg["N_importance"], near=cfg["near"], far=cfg["far"],
                                   multires=cfg["nerf"]["multires"], multires_views=cfg["nerf"]["multires_views"])
            out.append(torch.cat([r["rgb"], r["depth"][:, None], r["acc"][:, None]], -1))
    return torch.cat(out)
