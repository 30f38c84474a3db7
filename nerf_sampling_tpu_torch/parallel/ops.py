"""Data-parallel train steps, the sharded eval, the process group and the rank launcher
(nerf_sampling_tpu/parallel/ops.py).

The JAX package annotates shardings and lets XLA insert the collectives;
here they are written out. Every rank runs the one-device step on its rows
of the global batch, with the draws of those rows (core/sampling.py's row
window; K6 and K3 key their Philox draws by the global ray index), and
between backward and the update one all-reduce of one flat fp32 buffer
averages the gradients. The steps' means are averaged and their sums added
the same way, so a rank's metrics are those of the whole batch. Under gloo
both go through a host copy; under nccl they stay on the card.

``spawn`` runs a function on N ranks joined through a ``file://``
rendezvous, each with a collective timeout; the parent waits with a
deadline, and stops every rank when one fails or the deadline passes.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Callable

import torch
import torch.distributed as dist

from nerf_sampling_tpu_torch.parallel.mesh import Mesh, host_side, ray_rows
from nerf_sampling_tpu_torch.render.engine import KERNEL_IMPLS, EvalMode, NeRFParams, Pipeline, render_flat_rays
from nerf_sampling_tpu_torch.train.steps import (
    make_depth_net_train_step,
    make_joint_train_step,
    make_nerf_train_step,
)

ENV_NAMES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
DEFAULT_TIMEOUT = 600.0  # seconds a collective (and the rendezvous) may wait for a peer


def maybe_initialize_distributed(cfg, backend: str | None = None, *, device: torch.device | str = "cuda") -> bool:
    """Join the process group a launcher describes; True when there is one.

    Idempotent: a group that exists already (formed by the caller, or by
    ``spawn``) is kept. Otherwise the launcher's ``env://`` variables
    (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK)
    are read: all of them set joins, none set is a single process (or an
    error under ``multihost``, which needs a launcher), and a partial set
    raises. ``backend`` defaults to nccl for a ``device`` on a card, gloo
    on the CPU. A collective waits DEFAULT_TIMEOUT seconds for a peer.
    """
    if dist.is_initialized():
        return True
    present = [n for n in ENV_NAMES if os.environ.get(n)]
    if present and len(present) != len(ENV_NAMES):
        missing = [n for n in ENV_NAMES if n not in present]
        raise ValueError(f"a partial launcher environment: {present} set but {missing} missing/empty — "
                         "set all five (torchrun does) or none")
    if not present:
        if getattr(cfg, "multihost", False):
            raise ValueError(f"multihost=True needs a launcher: start one process per card with torchrun "
                             f"(--nnodes, --nproc_per_node, --rdzv_endpoint), which sets {list(ENV_NAMES)}")
        return False
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT))
    return True


def _all_reduce_sum(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """``flat`` summed over the ranks. Under nccl the collective stays on
    the card: ``dist.all_reduce``'s wait makes the current stream wait on
    the NCCL stream's end event, with no host copy and no host read, so it
    is captured into a CUDA graph with the step around it. Under gloo it
    goes through a host copy, which no graph can hold."""
    buf = flat.cpu() if host_side(mesh, flat) else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(flat.device)


@torch.no_grad()
def all_reduce_grads(modules, mesh: Mesh) -> None:
    """Average the gradients of ``modules`` over the ranks: one flat fp32
    buffer summed by one all-reduce, then divided by the world size.
    Parameters without a gradient (a DepthNet in its warmup) take no part;
    every rank has the same ones. One rank runs the same collective (the
    sum is the identity and the division by 1 exact), so a one-rank mesh
    captures what a wider one does."""
    grads = [p.grad for m in modules for p in m.parameters() if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce_sum(mesh, torch.cat([g.reshape(-1).float() for g in grads])) / mesh.world
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def reduce_metrics(mesh: Mesh) -> Callable:
    """The steps' metric reduction: ``reduce(means, sums)`` averages the
    per-rank means (each over an equal number of rows) and adds the sums,
    in one all-reduce; ratios are formed after it (train/steps.py), never
    averaged."""

    @torch.no_grad()
    def reduce(means: dict, sums: dict) -> tuple[dict, dict]:
        keys = list(means) + list(sums)
        flat = torch.stack([t.reshape(()).float() for t in (*means.values(), *sums.values())])
        flat = _all_reduce_sum(mesh, flat)
        flat[:len(means)] /= mesh.world
        vals = dict(zip(keys, flat.unbind()))
        return {k: vals[k] for k in means}, {k: vals[k] for k in sums}

    return reduce


def _parallel(mesh: Mesh) -> dict:
    return {"reduce_grads": lambda modules: all_reduce_grads(modules, mesh),
            "reduce_metrics": reduce_metrics(mesh), "shard": (mesh.rank, mesh.world)}


def make_sharded_depth_train_step(pipeline: Pipeline, frozen: NeRFParams, mesh: Mesh) -> Callable:
    """The depth-net step of the rank's rows: ``step(state, (rays_o, rays_d,
    target), seed, draws=None)`` on the rank's rows, ``draws`` those of the
    global batch; the update and the metrics are the whole batch's."""
    return make_depth_net_train_step(pipeline, frozen, **_parallel(mesh))


def make_sharded_nerf_train_step(pipeline: Pipeline, mesh: Mesh) -> Callable:
    """The vanilla NeRF step of the rank's rows (as ``make_sharded_depth_train_step``)."""
    return make_nerf_train_step(pipeline, **_parallel(mesh))


def make_sharded_joint_train_step(pipeline: Pipeline, mesh: Mesh) -> Callable:
    """The joint step of the rank's rows (as ``make_sharded_depth_train_step``);
    its warmup flag is read from the NeRF state's step, the same on every rank."""
    return make_joint_train_step(pipeline, **_parallel(mesh))


@torch.no_grad()
def gather_rows(mesh: Mesh, maps: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every rank's row block of ``maps`` (flat [n, ...] tensors, n the same on
    every rank), joined in rank order on the host of every rank, in one
    all-gather."""
    host = {k: v.detach().cpu() for k, v in maps.items()}
    if mesh.world == 1:
        return host
    n = next(iter(host.values())).shape[0]
    cols = [v.reshape(n, -1) for v in host.values()]
    flat = torch.cat([c.float() for c in cols], 1).contiguous()
    dev = flat if mesh.backend == "gloo" else flat.to(next(iter(maps.values())).device)
    parts = [torch.empty_like(dev) for _ in range(mesh.world)]
    dist.all_gather(parts, dev, group=mesh.group)
    full = torch.cat([p.cpu() for p in parts], 0)
    out, off = {}, 0
    for (k, v), c in zip(host.items(), cols):
        out[k] = full[:, off:off + c.shape[1]].reshape(mesh.world * n, *v.shape[1:]).to(v.dtype)
        off += c.shape[1]
    return out


def make_sharded_eval(pipeline: Pipeline, mesh: Mesh, mode: EvalMode = EvalMode.DEPTH_NET) -> Callable:
    """``eval_fn(params, rays_o, rays_d, generator=None, chunk=...)`` renders
    the rank's rows of the global flat rays (their count divisible by the
    world size) and returns the maps of all of them on the host of every
    rank. The kernels' draws (K3) are keyed by the global ray index and
    their seed comes from the shared ``generator``, so the maps are those
    of one process; the plain path draws from a generator of its own per
    rank, as the JAX package folds the shard index into its key."""

    def eval_fn(params, rays_o, rays_d, generator=None, chunk: int = 1024 * 32, full_outputs: bool = False,
                **ndc):
        lo, hi = ray_rows(mesh, rays_o.shape[0])
        kernel_route = pipeline.mlp_impl in KERNEL_IMPLS and not pipeline.ndc and not full_outputs
        gen = generator
        if not kernel_route and generator is not None and mesh.world > 1:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))
            gen = torch.Generator(device=generator.device).manual_seed(seed + mesh.rank)
        local = render_flat_rays(pipeline, params, rays_o[lo:hi], rays_d[lo:hi], mode=mode, chunk=chunk,
                                 generator=gen, full_outputs=full_outputs, ray_base=lo, **ndc)
        return gather_rows(mesh, local)

    return eval_fn


def _rank_main(index: int, fn, world: int, first: int, rendezvous: str, backend: str, timeout: float,
               threads: int | None, args: tuple):
    rank = first + index
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method="file://" + rendezvous, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        return fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, rendezvous: str, backend: str = "gloo",
          timeout: float = DEFAULT_TIMEOUT, join_timeout: float | None = None, threads: int | None = None,
          rank0_here: bool = False):
    """Run ``fn(rank, world, *args)`` on ``world`` ranks in one process group.

    The ranks meet through ``file://rendezvous`` (a path that does not exist
    yet; it is removed at the end) under ``backend``, and every collective
    waits at most ``timeout`` seconds for a peer. The ranks are spawned
    processes (``fn`` must be importable from a module that imports no
    JAX), all of them, or all but rank 0 with ``rank0_here``: rank 0 then
    runs in this process and its return value is returned. The parent then
    waits at most ``join_timeout`` seconds (None: as long as they run) for
    the spawned ranks; when one fails, or the time is up, or rank 0 raises,
    it kills every rank still running and raises. ``threads`` sets each
    spawned rank's torch threads.
    """
    import torch.multiprocessing as mp

    if os.path.exists(rendezvous):
        raise FileExistsError(f"the rendezvous file {rendezvous} exists: give a fresh path")
    first = 1 if rank0_here else 0
    ctx = mp.start_processes(_rank_main, args=(fn, world, first, rendezvous, backend, timeout, threads, args),
                             nprocs=world - first, join=False, start_method="spawn")
    try:
        result = _rank_main(0, fn, world, 0, rendezvous, backend, timeout, None, args) if rank0_here else None
        deadline = None if join_timeout is None else time.monotonic() + join_timeout
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running {join_timeout:.0f} s into the wait")
        return result
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10.0)
        with contextlib.suppress(FileNotFoundError):
            os.remove(rendezvous)
