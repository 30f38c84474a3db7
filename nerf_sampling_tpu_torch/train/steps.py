"""The train steps (nerf_sampling_tpu/train/steps.py).

- ``make_depth_net_train_step`` (:103-231): the reference's only working
  step (Trainer.core_optimization_loop, Trainer.py:506-544). It steps only
  the sampling optimizer on ``img_loss + mse(depth_z, max_z)``: the
  DepthNet gets the sum of both gradients and the frozen NeRF none. Here the
  NeRF modules are frozen (``requires_grad_(False)``), gradients still flow
  through the query points to the DepthNet, and the differentiable part
  runs at the Pipeline's ``matmul_precision`` (strict fp32 by default, as
  the JAX package's "highest"; every step applies it in a scope).
  Under ``"cuda"`` the frozen-NeRF target pass (about 98% of the step's
  FLOPs) is K6, ``fused_render_hier`` with the step's seed, under no_grad
  (under NDC, as in JAX, the composable hierarchical pass with K4 queries);
  then the DepthNet and the single depth-point fine-NeRF query in plain
  autograd (the JAX step's oracle branch with ``force_xla=True``). Under
  ``"cuda_int8"`` that pass is K6 in int8 (W8A8), on the frozen NeRFs'
  int8 packs (JAX ``steps.py:127-159``).
- ``make_nerf_train_step`` (:234-281): coarse and fine NeRFs trained
  together on img2mse(fine) + img2mse(coarse) (the reference's NeRF
  optimizer is created and decayed but never stepped, SURVEY.md defect #4).
- ``make_joint_train_step`` (:383-490): the NeRFs and the DepthNet in one
  step. The NeRFs' loss adds the DepthNet's photometric term (its gradient
  reaches the fine NeRF through the depth-point query) and the DepthNet's
  depth MSE; with ``joint_depth_warmup`` both depth terms stay out, and the
  DepthNet's parameters and Adam state are left exactly as they were, until
  the NeRF's step count reaches it.

Under ``"cuda"`` the NeRF queries of the nerf and joint steps' hierarchical
pass run on K4 with K5 as their backward (``render.engine.query_nerf``); the
depth-point query stays plain fp32. A "cuda" config outside a kernel's
envelope raises; it does not drop to the plain path. The draws of a step
come from its seed, or are injected (``StepDraws``), which is how the tests
feed both packages the same numbers.

Data parallelism (parallel/ops.py) runs these steps on each rank's rows of
the global batch with three keywords of the step makers: ``shard=(rank,
world)``, under which a step of n rows holds global rows ``rank * n ..``
of ``world * n`` and takes their draws (the generator's draws made at the
global shape and windowed, injected draws given at the global shape and
sliced, K6 keyed by the global ray index through ``ray_base``);
``reduce_grads``, called on the trained modules between ``backward()`` and
the update; and ``reduce_metrics``, which turns the rank's means and sums
into the whole batch's before the PSNRs and the fg/bg ratios are formed.
Left at their defaults, the steps are the one-device steps.

A step's ``seed`` is an int, or a ``StepSeed``: K6's seed as a 0-d device
tensor and one generator for the torch draws, which is how a step captured
in a CUDA graph takes a new seed at every replay (train/dispatch.py, the
counterpart of the JAX ``make_multi_step``). Both give the draws of the
same int seed. The step bodies launch only device work, with no host read
of a device value and no host-to-device copy, so a graph can hold them;
their host bookkeeping (the step counts, the update counts) is the
dispatcher's to repeat at each replay.

Each step marks its phases with ``utils.profiling.phase``: ``oracle`` (the
depth step's K6 target pass), ``forward`` (the rest of the forward and the
loss), ``backward``, ``all_reduce`` (data parallelism) and ``adam``. On
the card, inside ``profiling.step_phases`` where the step is timed, a
marker is a CUDA event that a captured graph keeps as a node, so the
phases' device times survive a replay. A phase runs to the next marker,
and the last to the step's return, so the phases tile the step from its
first marker on: ``adam`` holds what follows the update too (the NeRF
step's PSNR), and the batch's preparation before the first marker
(``make_ray_batch``) is in none.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from nerf_sampling_tpu_torch.core.compositing import raw2outputs
from nerf_sampling_tpu_torch.core.metrics import img2mse, mse2psnr
from nerf_sampling_tpu_torch.core.sampling import Rows, z_to_points
from nerf_sampling_tpu_torch.kernels import fused_hier, quant
from nerf_sampling_tpu_torch.models.depth_net import DepthNet
from nerf_sampling_tpu_torch.render.engine import (
    CUDA_INT8,
    KERNEL_IMPLS,
    NeRFParams,
    Pipeline,
    RayBatch,
    _query_fine_or_coarse,
    check_kernel_queries,
    make_ray_batch,
    render_rays_joint,
    render_rays_train,
    render_rays_vanilla,
)
from nerf_sampling_tpu_torch.train.state import TrainState, apply_update
from nerf_sampling_tpu_torch.utils import profiling
from nerf_sampling_tpu_torch.utils.precision import matmul_precision


class StepDraws(NamedTuple):
    """Injected draws of one step: stratified jitter and inverse-CDF uniforms."""

    t_rand: torch.Tensor  # [N, N_samples]
    u: torch.Tensor  # [N, N_importance]


class StepSeed(NamedTuple):
    """A step's seed as a captured step reads it: K6's from device memory,
    the torch draws from a generator registered with the graph, both set
    to the step's int seed before each replay."""

    k6: torch.Tensor  # 0-d int32 on the device
    generator: torch.Generator


def _generator(seed: int | StepSeed, device: torch.device) -> torch.Generator:
    """The step's generator: a ``StepSeed``'s, or a fresh one seeded with
    the int seed."""
    if isinstance(seed, StepSeed):
        return seed.generator
    return torch.Generator(device=device).manual_seed(seed)


def _in_precision(p: Pipeline, step: Callable) -> Callable:
    """``step`` run at the pipeline's matmul precision (forward, backward and
    update), the global setting restored after it (utils/precision.py)."""

    @functools.wraps(step)
    def run(*args, **kwargs):
        with matmul_precision(p.matmul_precision):
            return step(*args, **kwargs)

    return run


def check_hier_oracle(p: Pipeline) -> bool:
    """True when the step's target pass runs on K6 (``mlp_impl="cuda"``, or
    in int8 under "cuda_int8").

    The JAX step checks the same envelope (``_can_use_hier_oracle``) and
    drops to its XLA path outside it; here a "cuda" config outside it
    raises, naming what is missing. Under NDC it is False, as JAX's
    ``not p.ndc``: the target pass is then the composable hierarchical
    render with K4 queries (``render_rays_train``), and "cuda_int8" raises,
    having no int8 route there.
    """
    if p.mlp_impl not in KERNEL_IMPLS:
        return False
    check_kernel_queries(p)
    if p.ndc:
        if p.mlp_impl == CUDA_INT8:
            raise ValueError("mlp_impl='cuda_int8' has no NDC route: under NDC the target pass runs K4 in bf16 "
                             "(mlp_impl='cuda')")
        return False
    if p.raw_noise_std != 0.0:
        raise ValueError("mlp_impl='cuda' (K6) takes raw_noise_std=0 only")
    if p.N_samples < 4 or p.N_importance < 1 or p.N_samples + p.N_importance > 512:
        raise ValueError(
            "mlp_impl='cuda' (K6) takes N_samples >= 4, N_importance >= 1 and at most 512 "
            f"samples in all; got {p.N_samples} + {p.N_importance}"
        )
    return True


def _weighted_depth_loss(depth_z, max_z, acc, bg_weight: float) -> torch.Tensor:
    """Depth MSE with background rays (acc <= 0.5) weighted by ``bg_weight``."""
    fg = (acc.reshape(-1, 1) > 0.5).to(depth_z.dtype)
    w = fg + bg_weight * (1.0 - fg)
    return torch.mean(w * (depth_z - max_z) ** 2)


def _fg_bg_sums(depth_z, max_z, acc, thresh: float = 0.5) -> dict[str, torch.Tensor]:
    """The sums and counts of the fg/bg split of the depth loss."""
    acc = acc.reshape(-1, 1)
    se = (depth_z - max_z) ** 2
    fg = (acc > thresh).to(se.dtype)
    return {"se_fg": torch.sum(se * fg), "se_bg": torch.sum(se * (1.0 - fg)), "n_fg": torch.sum(fg),
            "n": torch.full((), float(se.shape[0]), dtype=se.dtype, device=se.device)}


def _fg_bg_depth_diagnostics(sums: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The depth loss split into foreground and background rays (metrics only)."""
    n_fg, n = sums["n_fg"], sums["n"]
    return {
        "depth_loss_fg": sums["se_fg"] / torch.clamp(n_fg, min=1.0),
        "depth_loss_bg": sums["se_bg"] / torch.clamp(n - n_fg, min=1.0),
        "fg_frac": n_fg / n,
    }


def _reduced(means: dict, sums: dict, reduce_metrics: Callable | None) -> tuple[dict, dict]:
    """The batch's means and sums: the rank's, reduced over the ranks under
    data parallelism."""
    return (means, sums) if reduce_metrics is None else reduce_metrics(means, sums)


def _rows(shard: tuple[int, int], n: int) -> Rows | None:
    """The row window of a rank's n rows: None on one device."""
    rank, world = shard
    return None if world == 1 else (rank * n, world * n)


def _window(draws: StepDraws | None, rows: Rows | None, n: int) -> StepDraws | None:
    """The rank's rows of the global batch's injected draws."""
    if draws is None or rows is None:
        return draws
    lo = rows[0]
    return StepDraws(draws.t_rand[lo:lo + n], draws.u[lo:lo + n])


def depth_net_loss(
    pipeline: Pipeline,
    frozen: NeRFParams,
    depth: DepthNet,
    rays: RayBatch,
    target: torch.Tensor,
    seed: int | StepSeed,
    draws: StepDraws | None = None,
    *,
    rows: Rows | None = None,
    reduce_metrics: Callable | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(img_loss + depth_loss, detached metrics) of one batch; backward()
    on the loss leaves the DepthNet's gradients in its parameters. ``rows``
    places the batch in a global one (its draws), ``reduce_metrics`` makes
    the metrics the global batch's (module docstring)."""
    p = pipeline
    if check_hier_oracle(p):
        hier = frozen.kernels.hier if frozen.kernels is not None else None
        if hier is None or quant.is_int8(hier["fine"]) != (p.mlp_impl == CUDA_INT8):
            raise ValueError(f"the K6 branch of mlp_impl={p.mlp_impl!r} needs the frozen NeRFs' hier packs "
                             "(pack_kernel_weights(with_hier=True), with the quant_pair under cuda_int8)")
        fine = frozen.fine if frozen.fine is not None else frozen.coarse
        with torch.no_grad(), profiling.phase("oracle"):
            hm = fused_hier.fused_render_hier(
                hier, frozen.coarse.cfg, fine.cfg, rays.rays_o, rays.rays_d,
                n_coarse=p.N_samples, n_importance=p.N_importance, near=p.near, far=p.far,
                white_bkgd=p.white_bkgd, lindisp=p.lindisp, seed=seed.k6 if isinstance(seed, StepSeed) else seed,
                ray_base=0 if rows is None else rows[0],
                draws=None if draws is None else torch.cat([draws.t_rand, draws.u], -1).contiguous(),
                multires=p.multires, multires_views=p.multires_views,
            )
        max_z = hm["max_z"].reshape(-1, 1)
        acc = hm["acc_map"].reshape(-1, 1)
        with profiling.phase("forward"):
            depth_z = depth(rays.rays_o, rays.rays_d)
            depth_pts = z_to_points(rays.rays_o, rays.rays_d, depth_z)
            depth_raw = _query_fine_or_coarse(p, frozen, depth_pts, rays)
            rgb = raw2outputs(depth_raw, depth_z, rays.rays_d, 0.0, p.white_bkgd).rgb_map
    else:
        generator = None if draws is not None else _generator(seed, rays.rays_o.device)
        with profiling.phase("forward"):
            out = render_rays_train(
                p, frozen._replace(depth=depth), rays, generator,
                t_rand=None if draws is None else draws.t_rand,
                u=None if draws is None else draws.u, rows=rows,
            )
        depth_z, rgb = out["depth_net_z_vals"], out["depth_net_rgb_map"]
        max_z, acc = out["max_z_vals"].detach(), out["acc_map"].detach()
    img_loss = img2mse(rgb, target)
    if p.bg_depth_loss_weight != 1.0:
        depth_loss = _weighted_depth_loss(depth_z, max_z, acc, p.bg_depth_loss_weight)
    else:  # reference objective (Trainer.py:537-543)
        depth_loss = img2mse(depth_z, max_z)
    with torch.no_grad():
        means, sums = _reduced({"loss": img_loss.detach(), "depth_net_loss": depth_loss.detach()},
                               _fg_bg_sums(depth_z.detach(), max_z, acc), reduce_metrics)
        metrics = {**means, "psnr": mse2psnr(means["loss"]), **_fg_bg_depth_diagnostics(sums)}
    return img_loss + depth_loss, metrics


def make_depth_net_train_step(pipeline: Pipeline, frozen: NeRFParams, *, reduce_grads: Callable | None = None,
                              reduce_metrics: Callable | None = None,
                              shard: tuple[int, int] = (0, 1)) -> Callable:
    """The depth-net-only train step against the frozen NeRF ``frozen``.

    Freezes the NeRF modules in place. The returned
    ``step(state, (rays_o, rays_d, target), seed, draws=None)`` updates
    ``state.model`` with ``state.optimizer`` and returns (state with the
    step count advanced, detached metrics). ``reduce_grads``,
    ``reduce_metrics`` and ``shard``: data parallelism (module docstring).
    """
    for model in (frozen.coarse, frozen.fine):
        if model is not None:
            model.requires_grad_(False)
    check_hier_oracle(pipeline)

    def step(state: TrainState, batch, seed: int | StepSeed, draws: StepDraws | None = None):
        rays_o, rays_d, target = batch
        rows = _rows(shard, rays_o.shape[0])
        rays = make_ray_batch(pipeline, rays_o, rays_d)
        loss, metrics = depth_net_loss(pipeline, frozen, state.model, rays, target, seed,
                                       _window(draws, rows, rays_o.shape[0]), rows=rows,
                                       reduce_metrics=reduce_metrics)
        state.optimizer.zero_grad(set_to_none=True)
        with profiling.phase("backward"):
            loss.backward()
        if reduce_grads is not None:
            with profiling.phase("all_reduce"):
                reduce_grads([state.model])
        with profiling.phase("adam"):
            apply_update(state)
        state.step += 1
        return state, metrics

    return _in_precision(pipeline, step)


def _step_generator(rays: RayBatch, seed: int | StepSeed, draws: StepDraws | None,
                    shard: tuple[int, int] = (0, 1)) -> dict:
    """The sampling arguments of a step: its seeded generator (with the
    rank's row window), or the draws (the rank's rows of them)."""
    n = rays.rays_o.shape[0]
    rows = _rows(shard, n)
    if draws is not None:
        draws = _window(draws, rows, n)
        return {"generator": None, "t_rand": draws.t_rand, "u": draws.u}
    return {"generator": _generator(seed, rays.rays_o.device), "rows": rows}


def nerf_pair(model: torch.nn.Module) -> NeRFParams:
    """The coarse and fine NeRFs of a ``state.nerf_modules``."""
    return NeRFParams(model["coarse"], model["fine"] if "fine" in model else None)


def make_nerf_train_step(pipeline: Pipeline, *, reduce_grads: Callable | None = None,
                         reduce_metrics: Callable | None = None, shard: tuple[int, int] = (0, 1)) -> Callable:
    """The vanilla hierarchical NeRF train step: coarse and fine optimized
    together on img2mse(fine rgb) + img2mse(coarse rgb).

    The returned ``step(state, (rays_o, rays_d, target), seed, draws=None)``
    updates ``state.model`` (``state.nerf_modules``) with its decayed Adam
    and returns (state with the step count advanced, detached metrics
    ``loss``, ``img_loss``, ``psnr``, ``psnr0``). ``reduce_grads``,
    ``reduce_metrics`` and ``shard``: data parallelism (module docstring).
    """
    p = pipeline
    if p.mlp_impl in KERNEL_IMPLS:
        check_kernel_queries(p)

    def step(state: TrainState, batch, seed: int | StepSeed, draws: StepDraws | None = None):
        rays_o, rays_d, target = batch
        rays = make_ray_batch(p, rays_o, rays_d)
        with profiling.phase("forward"):
            out = render_rays_vanilla(p, nerf_pair(state.model), rays, **_step_generator(rays, seed, draws, shard))
            img_loss = img2mse(out["rgb_map"], target)
            img_loss0 = img2mse(out["rgb0"], target)
            loss = img_loss + img_loss0
        state.optimizer.zero_grad(set_to_none=True)
        with profiling.phase("backward"):
            loss.backward()
        if reduce_grads is not None:
            with profiling.phase("all_reduce"):
                reduce_grads([state.model])
        with profiling.phase("adam"):
            apply_update(state)
        state.step += 1
        with torch.no_grad():
            m, _ = _reduced({"loss": loss.detach(), "img_loss": img_loss.detach(), "img_loss0": img_loss0.detach()},
                            {}, reduce_metrics)
            metrics = {"loss": m["loss"], "img_loss": m["img_loss"],
                       "psnr": mse2psnr(m["img_loss"]), "psnr0": mse2psnr(m["img_loss0"])}
        return state, metrics

    return _in_precision(p, step)


def make_joint_train_step(pipeline: Pipeline, *, reduce_grads: Callable | None = None,
                          reduce_metrics: Callable | None = None, shard: tuple[int, int] = (0, 1)) -> Callable:
    """The joint train step: NeRFs and DepthNet from one hierarchical pass.

    Losses (the JAX step's): the NeRFs take img2mse(fine) + img2mse(coarse)
    + img2mse(depth rgb) + depth MSE, the DepthNet the last two (max_z is
    detached). While ``nerf_state.step < joint_depth_warmup`` the depth
    terms leave the loss and the DepthNet is not stepped: its parameters
    and Adam state stay exactly as they were.

    The returned ``step(nerf_state, depth_state, (rays_o, rays_d, target),
    seed, draws=None)`` returns (nerf_state, depth_state, detached metrics:
    ``loss`` = img_loss + depth rgb loss, ``img_loss``, ``depth_net_loss``,
    ``psnr``, the fg/bg depth diagnostics and, with a warmup, ``depth_live``).
    ``reduce_grads``, ``reduce_metrics`` and ``shard``: data parallelism
    (module docstring); the warmup flag comes from the NeRF state's step,
    the same on every rank.
    """
    p = pipeline
    if p.mlp_impl in KERNEL_IMPLS:
        check_kernel_queries(p)

    def step(nerf_state: TrainState, depth_state: TrainState, batch, seed: int | StepSeed,
             draws: StepDraws | None = None):
        rays_o, rays_d, target = batch
        rays = make_ray_batch(p, rays_o, rays_d)
        live = nerf_state.step >= p.joint_depth_warmup
        with profiling.phase("forward"):
            params = nerf_pair(nerf_state.model)._replace(depth=depth_state.model)
            out = render_rays_joint(p, params, rays, **_step_generator(rays, seed, draws, shard))
            img_loss = img2mse(out["rgb_map"], target)
            img_loss0 = img2mse(out["rgb0"], target)
            depth_img_loss = img2mse(out["depth_net_rgb_map"], target)
            depth_z, max_z, acc = out["depth_net_z_vals"], out["max_z_vals"], out["acc_map"].detach()
            if p.bg_depth_loss_weight != 1.0:
                depth_loss = _weighted_depth_loss(depth_z, max_z, acc, p.bg_depth_loss_weight)
            else:  # reference objective
                depth_loss = img2mse(depth_z, max_z)
            total = img_loss + img_loss0
            if live:
                total = total + (depth_img_loss + depth_loss)
        nerf_state.optimizer.zero_grad(set_to_none=True)
        depth_state.optimizer.zero_grad(set_to_none=True)
        with profiling.phase("backward"):
            total.backward()
        if reduce_grads is not None:
            with profiling.phase("all_reduce"):
                reduce_grads([nerf_state.model, depth_state.model])
        with profiling.phase("adam"):
            apply_update(nerf_state)
            if live:
                apply_update(depth_state)
        nerf_state.step += 1
        depth_state.step += 1
        with torch.no_grad():
            means, sums = _reduced({"loss": (img_loss + depth_img_loss).detach(), "img_loss": img_loss.detach(),
                                    "depth_net_loss": depth_loss.detach()},
                                   _fg_bg_sums(depth_z.detach(), max_z, acc), reduce_metrics)
            metrics = {**means, "psnr": mse2psnr(means["img_loss"]), **_fg_bg_depth_diagnostics(sums)}
            if p.joint_depth_warmup:
                metrics["depth_live"] = torch.full((), float(live), device=rays_o.device)
        return nerf_state, depth_state, metrics

    return _in_precision(p, step)
