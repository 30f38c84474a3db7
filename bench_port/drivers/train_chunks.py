"""Train steps in chunks of K per host sync, as the program's Trainer runs them.

Set-up builds one train state from the raw checkpoint arrays (the
DepthNet's against the frozen NeRFs, or both NeRFs) and one
``StepDispatcher`` over the program's step, and drives them from the seed
through their first steps: steps 1, 2 and 3 one per call (the first runs
eagerly and captures the step's CUDA graph, the next two replay it), then
one chunk of K. The window then runs chunks of K, each chunk's batches
drawn by the program's ``RaySampler`` while the device runs the one
before (as ``Trainer._train_chunked``), until ``seconds`` have passed and
the chunk in flight has read back its metrics.

``correct``: the reference follows the first three steps from the same
raw arrays, batches and draws (the oracle's Philox stream, or the step's
generator seed) and compares the steps' losses, the norm of each leaf's
first gradient (the program's read from its Adam state after step 1:
m = (1 - b1) g), of each leaf's change after step 3 and, in the depth
step, the targets that step 1's oracle pass gave (``gaps`` lists the
numbers; a cell's limits name those it compares).
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from bench_port import traffic as T
from bench_port.drivers import port
from bench_port.harness import Check, checkpoint
from bench_port.reference import model as M
from bench_port.reference import philox
from bench_port.reference import train as R
from nerf_sampling_tpu_torch.data.types import SceneData
from nerf_sampling_tpu_torch.render.engine import make_nerf_slices, pack_kernel_weights
from nerf_sampling_tpu_torch.render.quantize import calibrate_pipeline
from nerf_sampling_tpu_torch.train.dispatch import StepDispatcher
from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
from nerf_sampling_tpu_torch.train.steps import make_depth_net_train_step, make_nerf_train_step

B1 = 0.9  # Adam's first-moment decay, in the program and the reference alike
FIRST = 3  # steps the reference follows


class Cell:
    """``variant``: "program"; for the depth step "control_tf32" (the
    program's own TF32 path for its float32 products, the control) or
    "control" (its int8 oracle, K10 in K6); for the NeRF step
    "control_fp8": the reference in the program's place with its MLP
    products' operands rounded to fp8 (e4m3, per-tensor scale), the NeRF
    kernels having no lower path of their own."""

    def __init__(self, workload: dict, config: dict, seed: int, device: torch.device, spans, variant: str = "program"):
        self.wl, self.cfg, self.seed, self.device, self.spans = workload, config, seed, device, spans
        self.traffic = workload["traffic"]
        self.kind = self.traffic["step"]
        self.variant = variant
        self.K = self.traffic["steps_per_dispatch"]
        self.losses: list[float] = []  # every step's loss, the first three included
        self.parts: list[dict[str, float]] = []  # the first steps' losses by part
        self.batches: list[tuple[np.ndarray, int]] = []  # the first steps' [N, 9] rows and seeds
        self.oracle_out: dict | None = None  # the depth step's first oracle targets (``_oracle_seen``)

    # ------------------------------------------------------------------ set-up

    def setup(self) -> None:
        t, cfg = self.traffic, self.cfg
        self.raw = checkpoint(cfg)
        size = t["size"]
        K = T.intrinsics(size, t["camera_angle_x"])
        poses = T.orbit_poses(self.seed, t["n_train"], t, "train")
        scene = SceneData(images=T.train_images(self.seed, t["n_train"], size), poses=poses, render_poses=poses[:1],
                          hwf=(size, size, float(K[0, 0])), i_train=np.arange(t["n_train"]),
                          i_val=np.array([], int), i_test=np.array([], int), near=cfg["near"], far=cfg["far"])
        self.sampler = RaySampler(scene, SamplerConfig(N_rand=cfg["N_rand"]), seed=int(self.seed))
        if self.variant == "control_fp8":  # readings only: no program, no window
            for i in range(1, FIRST + 1):
                stack, seeds = self._sample(i, 1)
                self.batches.append((stack[0], seeds[0]))
            self.parts, grad1, change = self._reference_steps(torch.float8_e4m3fn)
            self.grad1 = {k: float(g.norm()) for k, g in grad1.items()}
            self.change = {k: float(c.norm()) for k, c in change.items()}
            return
        self._program(scene)
        for i in range(1, FIRST + 1):
            stack, seeds = self._sample(i, 1)
            self.batches.append((stack[0], seeds[0]))
            with self._oracle_seen() if i == 1 else contextlib.nullcontext():
                self.parts.append(self._parts(self._run(stack, seeds), 0))
            if i == 1:
                self.grad1 = self._first_grads()
            if i == FIRST:
                self.change = {k: float((p.detach() - self.w0[k]).norm()) for k, p in self.named.items()}
        self.step = FIRST + 1
        self.chunk = self._sample(self.step, self.K)
        self._run(*self.chunk, overlap=self._next_chunk)

    def _program(self, scene) -> None:
        cfg = self.cfg
        mlp = "cuda_int8" if self.variant == "control" else "cuda"
        over = {"matmul_precision": "high"} if self.variant == "control_tf32" else {}
        pipe = port.pipeline(cfg, mlp, **over)
        params = port.modules(pipe, self.raw, self.device, with_depth=self.kind == "depth")
        if self.kind == "depth":
            pipe = calibrate_pipeline(pipe, params, scene)
            frozen = pack_kernel_weights(params._replace(depth=None), with_hier=True, quant_pair=pipe.quant_calib)
            make_nerf_slices(frozen.kernels)
            state = init_state(params.depth.requires_grad_(True), cfg["depth_net_lr"])
            step = make_depth_net_train_step(pipe, frozen)
        else:
            state = init_nerf_state(nerf_modules(params.coarse.requires_grad_(True), params.fine.requires_grad_(True)),
                                    cfg["lrate"], cfg["lrate_decay"])
            step = make_nerf_train_step(pipe)
        self.state = state
        self.dispatcher = StepDispatcher(lambda batch, s: step(state, batch, s)[1], [state], self.device)
        names = port.param_names(self.kind)
        self.named = {names[k]: p for k, p in state.model.named_parameters()}
        self.w0 = {k: p.detach().clone() for k, p in self.named.items()}

    @contextlib.contextmanager
    def _oracle_seen(self):
        """Keeps the targets of the first oracle pass the step runs (step 1's,
        eager, before its graph is captured): ``max_z`` [N] and the fine
        ``acc_map`` [N], as K6 returned them to the step."""
        from nerf_sampling_tpu_torch.kernels import fused_hier

        real = fused_hier.fused_render_hier

        def seen(*args, **kwargs):
            out = real(*args, **kwargs)
            if self.oracle_out is None:
                self.oracle_out = {k: out[k].detach().reshape(-1).clone() for k in ("max_z", "acc_map")}
            return out

        fused_hier.fused_render_hier = seen
        try:
            yield
        finally:
            fused_hier.fused_render_hier = real

    def _first_grads(self) -> dict[str, float]:
        """Each leaf's first gradient as the optimizer got it (none: 0)."""
        opt = self.state.optimizer
        by_param = {id(p): k for k, p in self.named.items()}
        return {by_param[id(p)]: float((opt.state[p]["exp_avg"] / (1.0 - B1)).norm()) if p in opt.state else 0.0
                for g in opt.param_groups for p in g["params"]}

    def _sample(self, i0: int, k: int) -> tuple[np.ndarray, list[int]]:
        with self.spans("sampler"):
            rows = [np.concatenate(self.sampler.sample(i), -1) for i in range(i0, i0 + k)]
            return np.stack(rows), [T.step_seed(self.seed, i) for i in range(i0, i0 + k)]

    def _parts(self, host: dict, j: int) -> dict[str, float]:
        """Step j's losses by part, from a chunk's metrics: the depth step's
        total and image loss (its DepthNet and point query, which the oracle
        does not reach), the NeRF step's total."""
        if self.kind == "depth":
            return {"loss": float(host["loss"][j] + host["depth_net_loss"][j]), "img_loss": float(host["loss"][j])}
        return {"loss": float(host["loss"][j])}

    def _run(self, stack: np.ndarray, seeds: list[int], overlap=None) -> dict:
        """One chunk through the dispatcher, its metrics read back to the
        host; ``overlap`` is host work done while the device runs it."""
        with self.spans("dispatch"):
            out = self.dispatcher.run(stack, seeds)
        if overlap is not None:
            overlap()
        with self.spans("read"):
            host = self.dispatcher.read(out)
        self.losses.extend(self._parts(host, j)["loss"] for j in range(len(seeds)))
        return host

    def _next_chunk(self) -> None:
        """The next chunk's batches, as the Trainer samples them while the device runs the last."""
        self.step += self.K
        self.chunk = self._sample(self.step, self.K)

    # ------------------------------------------------------------------ window

    def window(self, seconds: float, tracer) -> dict:
        a, b = self.traffic["trace_chunks"]
        first = len(self.losses)
        t0 = time.perf_counter()
        chunks = slice_units = 0
        while chunks == 0 or time.perf_counter() - t0 < seconds:
            traced = tracer.enabled and chunks == a
            with tracer.slice() if traced else contextlib.nullcontext():
                for _ in range(b - a if traced else 1):
                    self._run(*self.chunk, overlap=self._next_chunk)
                    chunks += 1
            if traced:
                slice_units = (b - a) * self.K
        window_s = time.perf_counter() - t0
        steps = chunks * self.K
        losses = np.asarray(self.losses[first:])
        return {"window_s": window_s, "units": steps, "rays": steps * self.cfg["N_rand"], "latencies_s": [],
                "slice_units": slice_units, "attempted": steps, "failed": int((~np.isfinite(losses)).sum())}

    def release(self) -> None:
        for name in ("dispatcher", "state"):
            if hasattr(self, name):
                delattr(self, name)
        self.named = self.w0 = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ check

    def _reference_steps(self, operands: torch.dtype | None = None) -> tuple[list[float], dict, dict]:
        """(each of the first steps' losses by part, the first gradients by
        leaf, the leaves' change after them) of the reference; with
        ``operands``, its products' operands rounded to that type."""
        cfg = self.cfg
        cfg_r = {**cfg, "multires": cfg["nerf"]["multires"], "multires_views": cfg["nerf"]["multires_views"]}
        if self.kind == "depth":
            frozen = M.to_torch({"coarse": self.raw["coarse"], "fine": self.raw["fine"]}, self.device)
            trained = M.to_torch(self.raw["depth"], self.device, requires_grad=True)
            cfg_r.update(depth_multires=cfg["depth_net"]["multires"], sphere_radius=cfg["depth_net"]["sphere_radius"])
            adam = R.Adam(M.leaves(trained), cfg["depth_net_lr"])
        else:
            trained = M.to_torch({"coarse": self.raw["coarse"], "fine": self.raw["fine"]}, self.device,
                                 requires_grad=True)
            adam = R.Adam(M.leaves(trained), R.nerf_lr(cfg["lrate"], cfg["lrate_decay"]))
        start = {k: p.detach().clone() for k, p in adam.params.items()}
        losses, grad1 = [], None
        with M.strict_fp32(), (rounded_operands(operands) if operands else contextlib.nullcontext()):
            for row, seed in self.batches[:FIRST]:
                batch = tuple(torch.from_numpy(np.ascontiguousarray(row[:, c:c + 3])).to(self.device) for c in (0, 3, 6))
                n = row.shape[0]
                if self.kind == "depth":
                    draws = torch.from_numpy(philox.hier_draws(seed, n, cfg["N_samples"] + cfg["N_importance"]))
                    parts, grads = R.depth_step(frozen, trained, batch, draws.to(self.device), cfg_r)
                    losses.append({"loss": parts["img_loss"] + parts["depth_loss"], "img_loss": parts["img_loss"]})
                    if grad1 is None:
                        self.ref_targets = (parts["max_z"], parts["acc"])
                else:
                    g = torch.Generator(device=self.device).manual_seed(seed)
                    t_rand = torch.rand((n, cfg["N_samples"]), generator=g, device=self.device)
                    u = torch.rand((n, cfg["N_importance"]), generator=g, device=self.device)
                    parts, grads = R.nerf_step(trained, batch, t_rand, u, cfg_r)
                    losses.append({"loss": parts["img_loss"] + parts["img_loss0"]})
                if grad1 is None:
                    grad1 = grads
                adam.update(grads)
        change = {k: (p.detach() - start[k]) for k, p in adam.params.items()}
        return losses, grad1, change

    def check(self) -> list[Check]:
        gaps = self.gaps()
        return [Check(name, gaps[name], limit) for name, limit in self.wl["limits"].items()]

    def gaps(self) -> dict[str, float]:
        """Every number the check can compare (a cell's limits name those it does):

        - ``loss_gap``: the largest relative gap of a step's loss over the
          first steps, ``loss1_gap`` the first step's, ``img_loss1_gap``
          the depth step's image loss at the first step (the part the
          oracle does not reach);
        - ``targets_apart`` (depth step): the reference's foreground rays
          (fine acc > 0.5) of step 1 whose target, the depth of the largest
          fine weight, the program's oracle put more than 0.05 from the
          reference's, or gave none;
        - ``grad_gap``, ``change_gap``: the worst leaf's gap of first
          gradient and of change after the first steps, each over the larger
          of its reference norm and the median counted leaf's;
          ``grad_median_gap``, ``change_median_gap`` the median leaf's.

        Leaves whose reference gradient is under a thousandth of the median
        leaf's (0 for a net without density) are not counted: Adam moves
        them by round-off alone."""
        losses, grad1, change = self._reference_steps()
        g_ref = {k: float(g.norm()) for k, g in grad1.items()}
        d_ref = {k: float(c.norm()) for k, c in change.items()}
        by_step = {k: [abs(p[k] - r[k]) / abs(r[k]) for p, r in zip(self.parts, losses)] for k in losses[0]}
        g_all = float(np.median(list(g_ref.values())))
        counted = [k for k in g_ref if g_ref[k] > 0 and g_ref[k] >= 1e-3 * g_all]
        g_med = float(np.median([g_ref[k] for k in counted]))
        d_med = float(np.median([d_ref[k] for k in counted]))
        grad = {k: abs(self.grad1[k] - g_ref[k]) / max(g_ref[k], g_med) for k in counted}
        change = {k: abs(self.change[k] - d_ref[k]) / max(d_ref[k], d_med) for k in counted}
        self.detail = {"worst_grad": max(grad, key=grad.get), "worst_change": max(change, key=change.get),
                       "loss_gap_by_step": by_step["loss"], "counted_leaves": len(counted)}
        out = {"loss_gap": max(by_step["loss"]), "loss1_gap": by_step["loss"][0], "grad_gap": max(grad.values()),
               "grad_median_gap": float(np.median(list(grad.values()))), "change_gap": max(change.values()),
               "change_median_gap": float(np.median(list(change.values())))}
        if "img_loss" in by_step:
            out["img_loss1_gap"] = by_step["img_loss"][0]
            self.detail["img_loss_gap_by_step"] = by_step["img_loss"]
        if self.kind == "depth":  # an oracle pass the step never ran reads NaN, which no limit passes
            seen = self.oracle_out is not None
            out["targets_apart"] = targets_apart(self.oracle_out["max_z"], *self.ref_targets) if seen else math.nan
            self.detail["fg_rays"] = int((self.ref_targets[1] > 0.5).sum())
        return out


def targets_apart(got: torch.Tensor, want: torch.Tensor, acc: torch.Tensor, tol: float = 0.05) -> float:
    """The foreground rays (``acc`` > 0.5) whose target ``got`` lies more
    than ``tol`` from ``want``; rays past the end of ``got`` count as apart."""
    fg = acc > 0.5
    n = min(got.shape[0], want.shape[0])
    apart = fg.clone()
    apart[:n] &= (got[:n].to(want.device) - want[:n]).abs() > tol
    return float(apart.sum())


@contextlib.contextmanager
def rounded_operands(dtype: torch.dtype = torch.float8_e4m3fn):
    """The reference's dense layers with both operands rounded to ``dtype``,
    accumulated in fp32: fp8 (e4m3) under a per-tensor scale (amax to 448),
    bfloat16 as it is. The gradients pass the rounding unchanged."""
    plain = M.dense

    def rnd(x: torch.Tensor) -> torch.Tensor:
        if dtype == torch.bfloat16:
            return x + (x.to(dtype).to(x.dtype) - x).detach()
        s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return x + ((x / s).to(dtype).to(x.dtype) * s - x).detach()

    def dense(layer: dict, x: torch.Tensor) -> torch.Tensor:
        return rnd(x) @ rnd(layer["weight"]) + layer["bias"]

    M.dense = dense
    try:
        yield
    finally:
        M.dense = plain
