"""Back-to-back calls of several views each through the render engine, one call in flight.

Each call takes ``views`` new cameras from the seed's stream, makes their
rays on the device (the program's ``get_rays``), renders all of them in one
``render_flat_rays`` call, as a user batches the views of a test set or a
video path to fill the card, and is complete when every view's maps (rgb,
depth, acc) are on the host. A unit is a call. The rest is
``render_frames``' ``Cell``, of which this is a subclass: its set-up (each
warm-up pose rendered ``views`` times, a call's shape), its window and
spans (``engine``, the rays and the render call up to its return;
``to_host``), its variants ("program"; "control", the program's own int8
path) and its check.

``correct``: once the window has closed, ``check_calls`` of the completed
calls drawn from the seed are rendered again, every ray of every view, by
``render_frames``' plain reference on ``render_frames``' rays, and compared
as there: the worst view's rgb mean squared gap, its mean depth gap over
the rays the reference finds opaque (acc > 0.5) and its mean acc gap. A
cell that ran no window (``readings.py``) renders the calls its check
samples as it is released.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port import traffic as T
from bench_port.drivers import render_frames
from bench_port.drivers.render_frames import gap, rays, reference
from bench_port.reference import model as M
from nerf_sampling_tpu_torch.core.rays import get_rays
from nerf_sampling_tpu_torch.render.engine import render_flat_rays


class Cell(render_frames.Cell):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.views = self.traffic["views"]
        self.windowed = False

    def _frame(self, c2w: np.ndarray, keep: bool = True) -> torch.Tensor:
        """One call over the poses ``c2w`` [views, 4, 4] (a warm-up pose [4, 4]
        ``views`` times): the views' maps [views * H * W, 5] on the host."""
        c2ws = c2w if c2w.ndim == 3 else np.repeat(c2w[None], self.views, 0)
        t0 = time.perf_counter()
        with self.spans("engine"):
            per_view = [get_rays(self.size, self.size, self.K, p[:3, :4], self.device) for p in c2ws]
            ro = torch.cat([o.reshape(-1, 3) for o, _ in per_view])
            rd = torch.cat([d.reshape(-1, 3) for _, d in per_view])
            out = render_flat_rays(self.pipe, self.params, ro, rd, mode=self.mode)
        with self.spans("to_host"):
            maps = torch.cat([out["depth_net_rgb_map"], out["depth_net_z_vals"].reshape(-1, 1),
                              out["depth_net_weights"].reshape(-1, 1)], -1).cpu()
        if keep:
            self.latencies.append(time.perf_counter() - t0)
        return maps

    def run_frames(self, n: int) -> None:
        """``n`` calls; ``frames`` holds (the first view's pose index, maps)."""
        for _ in range(n):
            i = (len(self.frames) * self.views) % len(self.poses)
            self.frames.append((i, self._frame(self.poses[i:i + self.views])))

    def window(self, seconds: float, tracer) -> dict:
        self.windowed = True
        stats = super().window(seconds, tracer)
        return {**stats, "rays": stats["rays"] * self.views}

    def release(self) -> None:
        if not self.windowed:  # readings.py: the calls its check samples
            self.run_frames(self.traffic["check_calls"])
        super().release()

    def gaps(self) -> dict[str, float]:
        """The numbers compared: the worst view's ``rgb_mse``, ``depth_gap``
        (opaque rays) and ``acc_gap`` over the sampled calls."""
        t = self.traffic
        rng = T.stream(self.seed, "check")
        picks = rng.choice(len(self.frames), size=min(t["check_calls"], len(self.frames)), replace=False)
        net = M.to_torch(self.raw, self.device)
        hw = self.size * self.size
        rows = np.arange(hw)
        rgb = depth = acc = 0.0
        for c in picks:
            i, maps = self.frames[int(c)]
            for v in range(self.views):
                o, d = rays(self.size, self.K, self.poses[(i + v) % len(self.poses)], rows, self.device)
                want = reference(net, self.cfg, t["pipeline"], self.mode, o, d)
                got = maps[v * hw:(v + 1) * hw].to(self.device)
                rgb = max(rgb, gap(((got[:, :3] - want[:, :3]) ** 2).mean(1)))
                fg = want[:, 4] > 0.5
                depth = max(depth, gap((got[fg, 3] - want[fg, 3]).abs()))
                acc = max(acc, gap((got[:, 4] - want[:, 4]).abs()))
        return {"rgb_mse": rgb, "depth_gap": depth, "acc_gap": acc}
