"""Data parallelism over torch.distributed on the CPU: gloo ranks against one process.

The ranks are spawned processes (``parallel/ops.py::spawn``, a ``file://``
rendezvous under the test's tmp_path, a collective timeout and a parent
deadline, one torch thread each); their functions live in this module,
which imports no JAX. Each spawn serves several checks:

- 2 ranks: the sharded depth, nerf and joint steps (the joint one with a
  warmup of 1 step), 2 steps each on the plain path and on the "cuda"
  route with CPU tensors (K6, K4 and K5 as their plain versions), against
  the one-process step on the whole batch: the metrics at 1e-5 relative,
  the parameters at rtol 1e-4 / atol 1e-6, and the two ranks' parameters
  equal bit for bit; the sharded render of a ragged image (DEPTH_NET,
  uniform and gaussian populations on the kernel route, uniform on the
  plain one) against ``render_image``;
- 2 ranks: the Trainer end to end in depth_net and nerf mode (a few steps
  and one eval through the sharded render) against one process: losses
  and eval PSNR at 1e-4 relative, parameter checksums equal across
  ranks, and only rank 0 wrote files;
- 4 ranks on the hybrid 2 x 2 mesh: its layout, one nerf step and one
  render against one process;
- ``run.py --n_devices 2 --device cpu`` (this process is rank 0).

tests/test_torch_dispatch.py's 2-rank checks (the chunked Trainer in three
modes and a chunk of the sharded depth step) run ``chunked_trainer_worker``.

tests/test_torch_parallel.py holds the same sharded steps and render to the
JAX package's, and the mesh helpers and K3/K6's ``ray_base`` on one process.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.parallel import mesh as pmesh
from nerf_sampling_tpu_torch.parallel import ops
from nerf_sampling_tpu_torch.render import engine as tengine

NERF_KW = dict(D=2, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True)
DEPTH_KW = dict(hidden_sizes=(32, 32, 32), cat_hidden_sizes=(32, 32, 32))
NC, NF, N_GLOBAL = 8, 16, 64
H_IMG, W_IMG = 5, 7  # 35 rays: padded to a multiple of the world size
TIMEOUT = 120.0  # seconds a collective may wait; the parent waits JOIN_TIMEOUT for the ranks
JOIN_TIMEOUT = 300.0
STEP_MODES = ("depth", "nerf", "joint")
RENDER_CASES = (("cuda", "uniform"), ("cuda", "gaussian"), ("plain", "uniform"))


def run_ranks(fn, world: int, tmp_path, *args):
    """``fn(rank, world, str(tmp_path), *args)`` on ``world`` gloo ranks; the
    ranks' results are each rank's ``rank{r}.pt``, returned in rank order."""
    ops.spawn(fn, world, (str(tmp_path), *args), rendezvous=str(tmp_path / "rendezvous"), timeout=TIMEOUT,
              join_timeout=JOIN_TIMEOUT, threads=1)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def tiny_params(seed: int = 0) -> tengine.NeRFParams:
    """2x32 NeRFs and a 3x32 DepthNet from ``seed``, the NeRFs' density
    raised so that the rays composite something."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        coarse, fine = NeRF(NeRFConfig(**NERF_KW)), NeRF(NeRFConfig(**NERF_KW))
        depth = DepthNet(DepthNetConfig(**DEPTH_KW))
    with torch.no_grad():
        for m in (coarse, fine):
            m.alpha_linear.bias += 1.0
    return tengine.NeRFParams(coarse, fine, depth)


def pipeline(mlp_impl: str = "plain", **kw) -> tengine.Pipeline:
    base = dict(N_samples=NC, N_importance=NF, n_depth_samples=16, distance=1.0, sampling_mode="uniform",
                bg_depth_loss_weight=0.5)
    base.update(kw)
    return tengine.Pipeline(nerf=NeRFConfig(**NERF_KW), fine=NeRFConfig(**NERF_KW),
                            depth=DepthNetConfig(**DEPTH_KW), mlp_impl=mlp_impl, **base)


def global_batch(seed: int, n: int = N_GLOBAL) -> tuple[torch.Tensor, ...]:
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    rd[:, 2] = -1.0
    return tuple(torch.from_numpy(x) for x in (ro, rd, rng.random((n, 3), dtype=np.float32)))


def camera() -> tuple[np.ndarray, np.ndarray]:
    focal = 6.0
    K = np.array([[focal, 0, W_IMG / 2], [0, focal, H_IMG / 2], [0, 0, 1.0]], np.float32)
    c2w = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
    return K, c2w


def flat_params(modules) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).clone() for m in modules for p in m.parameters()])


def flat_grads(modules) -> torch.Tensor:
    """The gradients the last update used (zeros where a module took none)."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).clone()
                      for m in modules for p in m.parameters()])


def run_steps(mode: str, impl: str, mesh, n_steps: int = 2, params=None, draws=None):
    """``n_steps`` steps of ``mode`` from the tiny models: the one-device
    step on the whole batch (``mesh`` None), or the sharded step on the
    rank's rows; (metrics per step, the trained parameters, the gradients
    of each step's update). ``draws``: a StepDraws per step for the whole
    batch (default: the steps' seeds)."""
    from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
    from nerf_sampling_tpu_torch.train import steps

    p = pipeline(impl, joint_depth_warmup=1 if mode == "joint" else 0)
    params = params if params is not None else tiny_params()
    if mesh is not None:
        for m in params[:3]:
            pmesh.replicate(mesh, m)
    if mode == "depth":
        frozen = params._replace(depth=None)
        if impl == "cuda":
            frozen = tengine.pack_kernel_weights(frozen, with_hier=True)
        maker = ops.make_sharded_depth_train_step if mesh is not None else steps.make_depth_net_train_step
        step = maker(p, frozen, mesh) if mesh is not None else maker(p, frozen)
        states = (init_state(params.depth, 1e-3),)
        trained = [params.depth]
    else:
        nerf = init_nerf_state(nerf_modules(params.coarse, params.fine), 1e-3, 1)
        states = (nerf,) if mode == "nerf" else (nerf, init_state(params.depth, 1e-3))
        trained = [nerf.model] + ([params.depth] if mode == "joint" else [])
        if mode == "nerf":
            step = ops.make_sharded_nerf_train_step(p, mesh) if mesh is not None else steps.make_nerf_train_step(p)
        else:
            step = ops.make_sharded_joint_train_step(p, mesh) if mesh is not None else steps.make_joint_train_step(p)
    metrics, grads = [], []
    for i in range(n_steps):
        batch = global_batch(10 + i)
        if mesh is not None:
            batch = pmesh.shard_ray_batch(mesh, batch)
        *states, m = step(*states, batch, 100 + i, None if draws is None else draws[i])
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(flat_grads(trained))
    return metrics, flat_params(trained), grads


def render_case(impl: str, population: str, mesh):
    """The DEPTH_NET render of the ragged image: sharded over ``mesh``, or
    one process's ``render_image`` (mesh None)."""
    from nerf_sampling_tpu_torch.parallel.render import render_image_sharded

    p = pipeline(impl, sampling_mode=population)
    params = tiny_params(1)
    if impl == "cuda":
        params = tengine.pack_kernel_weights(params, **tengine.eval_packs(p, tengine.EvalMode.DEPTH_NET, params))
    K, c2w = camera()
    kw = dict(device="cpu", mode=tengine.EvalMode.DEPTH_NET, chunk=16,
              generator=torch.Generator().manual_seed(7))
    if mesh is None:
        maps = tengine.render_image(p, params, H_IMG, W_IMG, K, c2w, **kw)
    else:
        maps = render_image_sharded(p, params, H_IMG, W_IMG, K, c2w, mesh=mesh, **kw)
    return {k: maps[k].numpy() for k in ("depth_net_rgb_map", "depth_net_disp_map")}


def steps_and_render_worker(rank: int, world: int, out: str) -> None:
    mesh = pmesh.make_mesh()
    rec = {"steps": {}, "render": {}}
    for impl in ("plain", "cuda"):
        for mode in STEP_MODES:
            got = run_steps(mode, impl, mesh)
            want = run_steps(mode, impl, None) if rank == 0 else None
            rec["steps"][impl, mode] = {"got": got, "want": want}
    for impl, population in RENDER_CASES:
        rec["render"][impl, population] = {"got": render_case(impl, population, mesh),
                                           "want": render_case(impl, population, None) if rank == 0 else None}
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(steps_and_render_worker, 2, tmp_path_factory.mktemp("steps"))


def assert_step_matches(got, want, k5: bool, lr: float = 1e-3) -> None:
    """A sharded run (metrics, params, grads) against the one-process run.

    Where the NeRFs' gradients come from K5 (the "cuda" nerf and joint
    steps), each rank's weight gradients are K5's bf16 sums over its own
    rows (as in the JAX package, whose Pallas backward returns bf16 grads),
    so their average is the whole batch's gradient to bf16 rounding, not
    to fp32: there the gradients are held at 2^-8 of their largest, the
    first step's metrics at 1e-5 (same weights) and the later ones at
    1e-3, and the parameters to one Adam step (2 lr) per step, since
    Adam's first steps move a parameter by about lr times the sign of its
    gradient, which a rounding flips where the gradient cancels. Elsewhere
    the metrics are held at 1e-5 and the parameters at rtol 1e-4 / atol
    1e-6."""
    (m, p, g), (want_m, want_p, want_g) = got, want
    for i, (a, b) in enumerate(zip(m, want_m)):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3 if k5 and i else 1e-5, atol=1e-7, err_msg=k)
    if not k5:
        np.testing.assert_allclose(p.numpy(), want_p.numpy(), rtol=1e-4, atol=1e-6)
        return
    for a, b in zip(g, want_g):
        assert float((a - b).abs().max()) <= 2.0**-8 * float(b.abs().max())
    assert float((p - want_p).abs().max()) <= 2 * lr * len(m)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("mode", STEP_MODES)
def test_sharded_step_equals_one_process(two_ranks, impl, mode):
    """2 steps on 2 ranks against 2 one-process steps on the whole batch
    (``assert_step_matches``): the whole batch's metrics on both ranks, and
    the ranks' parameters equal bit for bit (the joint step's first step
    is its warmup)."""
    r0, r1 = (r["steps"][impl, mode] for r in two_ranks)
    assert r0["got"][0] == r1["got"][0] and torch.equal(r0["got"][1], r1["got"][1])
    if mode == "joint":
        assert [m["depth_live"] for m in r0["got"][0]] == [0.0, 1.0]
    assert_step_matches(r0["got"], r0["want"], k5=impl == "cuda" and mode != "depth")


@pytest.mark.parametrize("impl,population", RENDER_CASES)
def test_sharded_render_equals_one_process(two_ranks, impl, population):
    """The ragged image rendered on 2 ranks, gathered on both, against
    ``render_image`` in one process: K3's draws are keyed by the global ray
    index, so the gaussian population is the one process's too."""
    r0, r1 = (r["render"][impl, population] for r in two_ranks)
    for k, want in r0["want"].items():
        assert r0["got"][k].shape == want.shape == (H_IMG, W_IMG, *want.shape[2:])
        np.testing.assert_array_equal(r0["got"][k], r1["got"][k])
        np.testing.assert_allclose(r0["got"][k], want, rtol=2e-5, atol=2e-5, err_msg=k)


def jax_parity_worker(rank: int, world: int, out: str, inputs: str) -> None:
    """tests/test_torch_parallel.py's ranks: one sharded step of each mode
    from its models, batch and injected draws of the whole batch (JAX's),
    and the sharded render of its camera; the grads and params by name."""
    from nerf_sampling_tpu_torch.parallel.render import render_image_sharded
    from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
    from nerf_sampling_tpu_torch.train.steps import StepDraws

    spec = torch.load(inputs, weights_only=False)
    mesh = pmesh.make_mesh()

    def models() -> tengine.NeRFParams:
        ms = tengine.NeRFParams(NeRF(NeRFConfig(**NERF_KW)), NeRF(NeRFConfig(**NERF_KW)),
                                DepthNet(DepthNetConfig(**DEPTH_KW)))
        for m, k in zip(ms, ("coarse", "fine", "depth")):
            m.load_state_dict(spec["models"][k])
        return ms

    def named(module, attr=None) -> dict:
        return {n: (q if attr is None else getattr(q, attr)).detach().clone() for n, q in module.named_parameters()}

    batch = pmesh.shard_ray_batch(mesh, spec["batch"])
    rec = {}
    for mode, kw in spec["pipes"].items():
        p, params = pipeline("plain", **kw), models()
        draws = StepDraws(*spec["draws"][mode])
        if mode == "depth":
            state = init_state(params.depth, spec["lr"])
            _, m = ops.make_sharded_depth_train_step(p, params._replace(depth=None), mesh)(state, batch, 0, draws)
            trained = {"depth": params.depth}
        else:
            nerf = init_nerf_state(nerf_modules(params.coarse, params.fine), spec["lr"], spec["decay"])
            if mode == "nerf":
                *_, m = ops.make_sharded_nerf_train_step(p, mesh)(nerf, batch, 0, draws)
            else:
                depth = init_state(params.depth, spec["lr"])
                *_, m = ops.make_sharded_joint_train_step(p, mesh)(nerf, depth, batch, 0, draws)
            trained = {"coarse": params.coarse, "fine": params.fine}
            if mode == "joint":
                trained["depth"] = params.depth
        rec[mode] = {"metrics": {k: float(v) for k, v in m.items()},
                     "grads": {k: named(v, "grad") for k, v in trained.items()},
                     "params": {k: named(v) for k, v in trained.items()}}
    H, W, K, c2w = spec["camera"]
    maps = render_image_sharded(pipeline("plain", **spec["render_pipe"]), models(), H, W, K, c2w, mesh=mesh,
                                device="cpu", mode=tengine.EvalMode.DEPTH_NET)
    rec["render"] = {k: maps[k].numpy() for k in ("depth_net_rgb_map", "depth_net_disp_map")}
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


# ---------------------------------------------------------------- the Trainer

def trainer_cfg(datadir: str, basedir: str, mode: str, n_devices: int, ft_path: str | None):
    from nerf_sampling_tpu_torch.utils.config import TrainerConfig

    return TrainerConfig(
        datadir=datadir, basedir=basedir, expname=f"dp_{mode}", train_mode=mode, n_devices=n_devices,
        netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, n_layers=3, layer_width=32,
        sphere_radius=2.0, N_samples=NC, N_importance=NF, N_rand=64, n_depth_samples=16,
        sampling_mode="gaussian", distance=1.0, mlp_impl="cuda" if mode == "depth_net" else "plain",
        i_testset=4, i_weights=4, i_print=1, keep_best=True, testskip=1, bg_depth_loss_weight=0.5,
        ft_path=ft_path, seed=3, precrop_iters=0,
    )


TRAIN_STEPS = 4


def trainer_worker(rank: int, world: int, out: str, datadir: str, ft_path: str) -> None:
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    rec = {}
    for mode in ("depth_net", "nerf"):
        tr = Trainer(trainer_cfg(datadir, os.path.join(out, f"rank{rank}"), mode, world,
                                 ft_path if mode == "depth_net" else None), device="cpu")
        final = tr.train(N_iters=TRAIN_STEPS + 1)
        trained = [tr.params.depth] if mode == "depth_net" else [tr.params.coarse, tr.params.fine]
        rec[mode] = {"final": final, "eval": tr._avg_eval_psnr, "primary": tr.primary,
                     "checksum": flat_params(trained)}
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def sharded_depth_chunk(rank: int, world: int, spec: dict) -> dict:
    """One chunk of the plain sharded depth step (``spec["pipeline"]``)
    through ``StepDispatcher``: the rank's rows of ``spec["stack"]`` ([K, N,
    9], global), each step with
    the draws of the whole batch for its seed (the step's index); the
    metrics [K, M], each step's all-reduced gradients and the final
    parameters, by name."""
    from nerf_sampling_tpu_torch.parallel.ops import make_sharded_depth_train_step
    from nerf_sampling_tpu_torch.train.dispatch import StepDispatcher
    from nerf_sampling_tpu_torch.train.state import init_state
    from nerf_sampling_tpu_torch.train.steps import StepDraws

    mesh = pmesh.make_mesh()
    params = tiny_params()
    for k in ("coarse", "fine", "depth"):
        getattr(params, k).load_state_dict(spec["models"][k])
    state = init_state(params.depth, spec["lr"])
    step = make_sharded_depth_train_step(spec["pipeline"], params._replace(depth=None), mesh)
    grads = []

    def run(batch, seed):
        metrics = step(state, batch, seed, StepDraws(*spec["draws"][seed]))[1]
        grads.append({n: q.grad.clone() for n, q in state.model.named_parameters()})
        return metrics

    lo, hi = pmesh.ray_rows(mesh, spec["stack"].shape[1])
    disp = StepDispatcher(run, [state], "cpu")
    got = disp.read(disp.run(spec["stack"][:, lo:hi], spec["seeds"]))
    return {"metrics": got, "grads": grads,
            "params": {n: q.detach().clone() for n, q in state.model.named_parameters()}}


def chunked_trainer_worker(rank: int, world: int, out: str, datadir: str, ft_path: str, chunk_spec: str) -> None:
    """tests/test_torch_dispatch.py's ranks: depth_net, nerf and joint mode
    (its warmup ending inside the first chunk) for 8 steps, per step and in
    chunks of 4 (train/dispatch.py); and ``sharded_depth_chunk`` of the
    inputs in ``chunk_spec``."""
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    rec = {}
    for mode in ("depth_net", "nerf", "joint"):
        rec[mode] = {}
        for k in (1, 4):
            cfg = trainer_cfg(datadir, os.path.join(out, f"rank{rank}_k{k}"), mode, world,
                              None if mode == "nerf" else ft_path)
            tr = Trainer(dataclasses.replace(cfg, i_print=4, i_weights=4, i_testset=8, steps_per_dispatch=k,
                                             joint_depth_warmup=3), device="cpu")
            tr.train(N_iters=9)
            trained = [tr.params.depth] if mode == "depth_net" else [tr.params.coarse, tr.params.fine]
            if mode == "joint":
                trained.append(tr.params.depth)
            rec[mode][k] = {"lines": psnr_lines(tr.expdir) if tr.primary else None,
                            "checksum": flat_params(trained)}
    rec["chunk"] = sharded_depth_chunk(rank, world, torch.load(chunk_spec, weights_only=False))
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def write_nerf_ckpt(path: str) -> str:
    """A NeRF-only checkpoint of the tiny NeRFs in the JAX layout (the port writes it)."""
    from nerf_sampling_tpu_torch.train import checkpoint as ckpt_lib

    params = tiny_params(2)
    sds = {"coarse": params.coarse.state_dict(), "fine": params.fine.state_dict()}
    ckpt_lib.save_checkpoint(path, {"params": ckpt_lib.JaxNeRFParams(**ckpt_lib.params_to_jax(sds))}, 0)
    return path


def psnr_lines(expdir: str) -> list[tuple[int, float, float]]:
    """(step, loss, psnr) of every Iter line of psnr.txt."""
    rows = []
    for line in open(os.path.join(expdir, "psnr.txt")):
        if line.startswith("Iter:"):
            parts = line.replace(",", "").split()
            rows.append((int(parts[1]), float(parts[3]), float(parts[-1])))
    return rows


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    tmp = tmp_path_factory.mktemp("trainer")
    datadir = str(tmp / "scene")
    generate_example_dataset(datadir, H=16, W=16, n_train=2, n_val=1, n_test=1)
    ft_path = write_nerf_ckpt(str(tmp / "nerf.npz"))
    ranks = run_ranks(trainer_worker, 2, tmp, datadir, ft_path)
    single = {}
    for mode in ("depth_net", "nerf"):
        tr = Trainer(trainer_cfg(datadir, str(tmp / "single"), mode, 1, ft_path if mode == "depth_net" else None),
                     device="cpu")
        single[mode] = {"final": tr.train(N_iters=TRAIN_STEPS + 1), "eval": tr._avg_eval_psnr}
    return tmp, ranks, single


@pytest.mark.parametrize("mode", ["depth_net", "nerf"])
def test_trainer_on_two_ranks_equals_one_process(trainer_runs, mode):
    """The 2-rank Trainer's losses, PSNRs and eval PSNR against one
    process's at 1e-4 relative, the same on both ranks; only rank 0 wrote
    files (rank 1's basedir was never made)."""
    tmp, (r0, r1), single = trainer_runs
    assert r0[mode]["primary"] and not r1[mode]["primary"]
    assert r0[mode]["final"] == r1[mode]["final"] and r0[mode]["eval"] == r1[mode]["eval"]
    assert torch.equal(r0[mode]["checksum"], r1[mode]["checksum"])
    np.testing.assert_allclose(r0[mode]["final"], single[mode]["final"], rtol=1e-4)
    np.testing.assert_allclose(r0[mode]["eval"], single[mode]["eval"], rtol=1e-4)
    assert r0[mode]["eval"] > 0
    got, want = (psnr_lines(str(tmp / d / f"dp_{mode}")) for d in ("rank0", "single"))
    assert [s for s, *_ in got] == [s for s, *_ in want] == list(range(1, TRAIN_STEPS + 1))
    np.testing.assert_allclose([r[1:] for r in got], [r[1:] for r in want], rtol=1e-4)
    exp = tmp / "rank0" / f"dp_{mode}"
    ckpt = ("depth_" if mode == "depth_net" else "") + f"{TRAIN_STEPS:06d}.npz"
    for name in ("args.txt", "metrics.jsonl", ckpt, f"testset_{TRAIN_STEPS:06d}/000.png", "best"):
        assert (exp / name).exists(), name
    assert not (tmp / "rank1").exists()


# ---------------------------------------------------------------- 4 ranks, hybrid mesh

def hybrid_worker(rank: int, world: int, out: str) -> None:
    mesh = pmesh.make_hybrid_mesh(groups=2)
    rec = {"shape": mesh.shape, "axes": mesh.axis_names, "rows": pmesh.ray_rows(mesh, N_GLOBAL),
           "step": run_steps("nerf", "plain", mesh, n_steps=1),
           "render": render_case("plain", "uniform", mesh)}
    if rank == 0:
        rec["want_step"] = run_steps("nerf", "plain", None, n_steps=1)
        rec["want_render"] = render_case("plain", "uniform", None)
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def test_hybrid_mesh_on_four_ranks(tmp_path):
    """4 ranks on the 2 x 2 [dcn, rays] mesh: rank r holds row block r
    (host-major), and one nerf step and one render equal one process's
    (the step at the tolerances of the 2-rank test, the render at 2e-5)."""
    ranks = run_ranks(hybrid_worker, 4, tmp_path)
    per = N_GLOBAL // 4
    for r, rec in enumerate(ranks):
        assert rec["shape"] == (2, 2) and rec["axes"] == ("dcn", "rays")
        assert rec["rows"] == (r * per, (r + 1) * per)
        assert torch.equal(rec["step"][1], ranks[0]["step"][1])
    assert_step_matches(ranks[0]["step"], ranks[0]["want_step"], k5=False)
    for k, want in ranks[0]["want_render"].items():
        np.testing.assert_allclose(ranks[3]["render"][k], want, rtol=2e-5, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------- the CLI

def test_cli_spawns_cpu_ranks(tmp_path):
    """``run.py --n_devices 2 --device cpu`` spawns one gloo rank beside this
    process (rank 0), trains the tiny scene and returns rank 0's Trainer."""
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset
    from nerf_sampling_tpu_torch.experiments import run

    datadir = str(tmp_path / "scene")
    generate_example_dataset(datadir, H=16, W=16, n_train=2, n_val=1, n_test=1)
    config = tmp_path / "small.yaml"
    config.write_text(
        "small:\n  kwargs:\n    N_rand: 64\n    half_res: False\n    netdepth: 2\n    netwidth: 32\n"
        "    netdepth_fine: 2\n    netwidth_fine: 32\n    N_samples: 8\n    N_importance: 16\n"
        "    i_weights: 100\n    precrop_iters: 0\n")
    tr = run.main(["-c", str(config), "-m", "small", "-dp", datadir, "--mode", "nerf", "--n_iters", "2",
                   "-ip", "1", "--basedir", str(tmp_path / "logs"), "--testskip", "1", "--i_testset", "2",
                   "--seed", "0", "--device", "cpu", "--n_devices", "2"])
    assert tr.primary and tr.mesh.world == 2 and tr.cfg.n_devices == 2
    assert tr.global_step == 2 and tr._avg_eval_psnr > 0
    assert len(psnr_lines(tr.expdir)) == 2
    assert not torch.distributed.is_initialized()  # the rank's group is gone with its run


# ---------------------------------------------------------------- the launcher environment

def test_maybe_initialize_distributed_checks_the_environment(monkeypatch):
    """A partial env:// set raises naming the set and the missing names;
    multihost with none raises naming torchrun; none is one process."""
    for name in ops.ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    cfg = dataclasses.make_dataclass("Cfg", [("multihost", bool, False)])
    assert ops.maybe_initialize_distributed(cfg()) is False
    with pytest.raises(ValueError, match="torchrun"):
        ops.maybe_initialize_distributed(cfg(multihost=True))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=r"\['MASTER_ADDR', 'WORLD_SIZE'\] set but \['MASTER_PORT', 'RANK', "
                                         r"'LOCAL_RANK'\] missing"):
        ops.maybe_initialize_distributed(cfg())
    assert not torch.distributed.is_initialized()
