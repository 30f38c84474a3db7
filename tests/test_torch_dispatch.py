"""K train steps per host sync (train/dispatch.py) on the CPU, against the per-step loop and JAX.

- ``resolve_steps_per_dispatch`` against the JAX Trainer's
  ``_resolve_scan_steps`` (called on a stub ``self`` with
  ``jax.default_backend`` set to "gpu" and to "cpu") over a grid of
  cadences, explicit K, ``profile_dir`` and run lengths, the printed
  rounding message included; the rules on the card (an NCCL mesh takes
  one rank's, a gloo mesh and ``debug_nans`` run per step), the mesh's
  backend stubbed.
- ``all_reduce_grads`` on a one-rank gloo group: one collective, the
  gradients bit for bit unchanged.
- A chunked Trainer (K=4) against the per-step one in depth_net, nerf and
  joint mode (the joint warmup ending inside the first chunk): psnr.txt,
  the logged metrics, every checkpoint array (the Adam moments included)
  bit for bit; a run resumed from the checkpoint at a chunk end, chunked
  and per step; the same chunked against per-step on 2 gloo ranks in the
  three modes.
- One chunk of the plain depth step with the draws of
  ``fold_in(base_key, i0 + j)`` against JAX's ``make_multi_step``, at
  tests/test_torch_train.py's depth-step tolerances; the same chunk on 2
  gloo ranks against ``make_multi_step(mesh=)`` on 2 virtual CPU devices
  (the ranks, which import no JAX, share one spawn with the Trainers).
- chip_smoke.py's numpy copy of optax.adam's rule against optax.adam.
- K6's seed as a 0-d tensor: the plain version gives the int seed's draws,
  and the launch hands the kernel its address (a mocked library).

The captured path runs only on the card: chip_smoke.py's [dispatch] holds
it to the per-step loop bit for bit, on one rank and on a one-rank NCCL
mesh.
"""

import dataclasses
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_multiproc import chunked_trainer_worker, run_ranks, write_nerf_ckpt
from test_torch_nerf_train import nerf_trainer_cfg
from test_torch_train import (
    N,
    assert_tree_close,
    committed_params,
    jax_step_draws,
    pipelines,
    production_pipe,
    rays_np,
    small_models,
    stash_grads,
    tiny_trainer_cfg,
)

from nerf_sampling_tpu.train import checkpoint as jckpt
from nerf_sampling_tpu.train import state as jstate
from nerf_sampling_tpu.train import trainer as jtrainer
from nerf_sampling_tpu.train.steps import make_depth_net_train_step as jax_depth_step
from nerf_sampling_tpu.train.steps import make_multi_step
from nerf_sampling_tpu.parallel import make_mesh as jax_make_mesh
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_hier as k6
from nerf_sampling_tpu_torch.models import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.parallel import mesh as pmesh
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.train import checkpoint as tckpt
from nerf_sampling_tpu_torch.train.dispatch import StepDispatcher
from nerf_sampling_tpu_torch.train.state import init_state
from nerf_sampling_tpu_torch.train.steps import StepSeed, make_depth_net_train_step
from nerf_sampling_tpu_torch.train.trainer import Trainer, resolve_steps_per_dispatch
from nerf_sampling_tpu_torch.utils.config import TrainerConfig

CADENCES = {"default": (100, 10000, 20000, 100000), "gcd_6": (12, 30, 60, 90), "gcd_1": (7, 10, 20, 30),
            "gcd_250": (250, 500, 1000, 2000)}


def resolve_jax(cfg, n_iters, start, backend, monkeypatch):
    """The JAX Trainer's rule, on a stub self holding cfg and start."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    return jtrainer.Trainer._resolve_scan_steps(types.SimpleNamespace(cfg=cfg, start=start), n_iters)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("k", [0, 1, 4, 7, 64, 150])
@pytest.mark.parametrize("cadence", list(CADENCES))
def test_resolve_matches_jax(monkeypatch, capsys, cadence, k, device):
    i_print, i_weights, i_testset, i_video = CADENCES[cadence]
    cfg = TrainerConfig(i_print=i_print, i_weights=i_weights, i_testset=i_testset, i_video=i_video,
                        steps_per_dispatch=k)
    backend = {"cuda": "gpu", "cpu": "cpu"}[device]
    for n_iters, start in ((5000, 0), (3000, 1000), (3, 0), (1002, 1000)):
        want = resolve_jax(cfg, n_iters, start, backend, monkeypatch)
        want_out = capsys.readouterr().out
        assert resolve_steps_per_dispatch(cfg, n_iters, start, device) == want, (n_iters, start)
        assert capsys.readouterr().out == want_out
        traced = dataclasses.replace(cfg, profile_dir="trace")
        assert resolve_steps_per_dispatch(traced, n_iters, start, device) == \
            resolve_jax(traced, n_iters, start, backend, monkeypatch) == 1


@pytest.mark.parametrize("rule", ["nccl_mesh", "gloo_mesh", "debug_nans"])
def test_cuda_rules(monkeypatch, capsys, rule):
    """On the card an NCCL mesh takes one rank's rule (auto the largest
    divisor of the cadences up to 100, an explicit K honoured), while a gloo
    mesh (its collectives copy through the host) or debug_nans makes auto 1
    (with the reason printed) and an explicit K > 1 an error naming it; an
    explicit K that rounds down to 1 runs, and on the CPU none of the rules
    applies. The mesh's backend is stubbed: no process group is formed."""
    monkeypatch.setattr(pmesh.Mesh, "backend", property(lambda self: rule.split("_")[0]))
    mesh = None if rule == "debug_nans" else pmesh.Mesh(2, 0, 0, (2,), ("rays",))
    cfg = TrainerConfig(debug_nans=rule == "debug_nans")
    explicit = dataclasses.replace(cfg, steps_per_dispatch=4)
    if rule == "nccl_mesh":
        assert resolve_steps_per_dispatch(cfg, 1000, 0, "cuda", mesh) == 100
        assert resolve_steps_per_dispatch(explicit, 1000, 0, "cuda", mesh) == 4
        assert capsys.readouterr().out == ""
    else:
        assert resolve_steps_per_dispatch(cfg, 1000, 0, "cuda", mesh) == 1
        assert ("gloo" if rule == "gloo_mesh" else "debug_nans") in capsys.readouterr().out
        with pytest.raises(ValueError, match="gloo's collectives go through host copies.*NCCL" if rule == "gloo_mesh"
                           else "debug_nans"):
            resolve_steps_per_dispatch(explicit, 1000, 0, "cuda", mesh)
    assert resolve_steps_per_dispatch(dataclasses.replace(cfg, steps_per_dispatch=3, i_print=7), 1000, 0,
                                      "cuda", mesh) == 1
    assert resolve_steps_per_dispatch(explicit, 1000, 0, "cpu", mesh) == 4
    assert resolve_steps_per_dispatch(cfg, 1000, 0, "cpu", mesh) == 1


def test_all_reduce_grads_on_one_rank(tmp_path, monkeypatch):
    """A one-rank mesh (gloo, this process) runs the gradient all-reduce: one
    dist.all_reduce, the gradients bit for bit those before it (the sum of
    one rank is the identity, the division by 1 exact); the metric
    reduction likewise."""
    import torch.distributed as dist

    from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig
    from nerf_sampling_tpu_torch.parallel import ops

    calls = []
    all_reduce = dist.all_reduce
    monkeypatch.setattr(ops.dist, "all_reduce", lambda *a, **k: (calls.append(a[0].shape), all_reduce(*a, **k))[1])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh(1)
        torch.manual_seed(0)
        net = DepthNet(DepthNetConfig(hidden_sizes=(32, 32, 32), cat_hidden_sizes=(32, 32, 32)))
        for q in net.parameters():
            q.grad = torch.randn_like(q) * 10.0 ** torch.randint(-8, 2, q.shape)
        before = [q.grad.clone() for q in net.parameters()]
        ops.all_reduce_grads([net], mesh)
        assert calls == [(sum(q.numel() for q in net.parameters()),)]
        assert all(torch.equal(q.grad, b) for q, b in zip(net.parameters(), before))
        means, sums = {"loss": torch.tensor(0.1234567)}, {"n": torch.tensor(7.0)}
        got_means, got_sums = ops.reduce_metrics(mesh)(means, sums)
        assert len(calls) == 2
        assert torch.equal(got_means["loss"], means["loss"]) and torch.equal(got_sums["n"], sums["n"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the chunked Trainer

CHUNK = 4
N_ITERS = 9  # steps 1..8: two chunks, checkpoints at 4 and 8, the eval at 8
CADENCE = dict(i_print=4, i_weights=4, i_testset=8)


def mode_cfg(tmp_path, mode):
    if mode == "depth_net":
        return tiny_trainer_cfg(tmp_path, **CADENCE)
    if mode == "nerf":
        return nerf_trainer_cfg(tmp_path, "nerf", **CADENCE)
    ft = str(tmp_path / "nerf.npz")
    jparams, _ = small_models()
    jckpt.save_checkpoint(ft, {"params": jparams._replace(depth=None)}, 0)
    return nerf_trainer_cfg(tmp_path, "joint", ft_path=ft, joint_depth_warmup=3, bg_depth_loss_weight=0.5,
                            **CADENCE)


def train(cfg, name: str, k: int, n_iters: int = N_ITERS) -> Trainer:
    tr = Trainer(dataclasses.replace(cfg, basedir=os.path.join(cfg.basedir, name), steps_per_dispatch=k),
                 device="cpu")
    tr.train(N_iters=n_iters)
    return tr


def logged(expdir: str) -> list[dict]:
    """metrics.jsonl without the wall clock and the rates read from it."""
    rows = [json.loads(ln) for ln in open(os.path.join(expdir, "metrics.jsonl"))]
    return [{k: v for k, v in r.items() if k not in ("time", "steps_per_sec", "rays_per_sec")} for r in rows]


def checkpoints(expdir: str) -> dict[str, dict[str, np.ndarray]]:
    out = {}
    for root, _, files in os.walk(expdir):
        for f in sorted(files):
            if f.endswith(".npz"):
                with np.load(os.path.join(root, f)) as z:
                    out[os.path.relpath(os.path.join(root, f), expdir)] = {k: z[k] for k in z.files}
    return out


def assert_same_run(a: str, b: str) -> None:
    assert open(os.path.join(a, "psnr.txt")).read() == open(os.path.join(b, "psnr.txt")).read()
    assert logged(a) == logged(b)
    ca, cb = checkpoints(a), checkpoints(b)
    assert sorted(ca) == sorted(cb) and len(ca) >= 2
    for name in ca:
        assert sorted(ca[name]) == sorted(cb[name]), name
        for key in ca[name]:
            np.testing.assert_array_equal(ca[name][key], cb[name][key], err_msg=f"{name} {key}")


@pytest.mark.parametrize("mode", ["depth_net", "nerf", "joint"])
def test_chunked_trainer_equals_per_step(tmp_path, mode):
    """K=4 chunks against the per-step loop, bit for bit: psnr.txt (the
    Iter lines at 4 and 8), the logged metrics (depth_live in joint mode,
    0 through step 3 and 1 from step 4, inside the first chunk), and every
    checkpoint array, Adam moments included."""
    cfg = mode_cfg(tmp_path, mode)
    per_step, chunked = train(cfg, "per_step", 1), train(cfg, "chunked", CHUNK)
    assert resolve_steps_per_dispatch(chunked.cfg, N_ITERS, 0, "cpu") == CHUNK
    assert (per_step.steps_per_dispatch, chunked.steps_per_dispatch) == (1, CHUNK)
    assert per_step.captured_graphs == chunked.captured_graphs == 0  # the CPU runs the steps eagerly
    assert per_step.global_step == chunked.global_step == N_ITERS - 1
    assert_same_run(per_step.expdir, chunked.expdir)
    if mode == "joint":
        live = [r["depth_live"] for r in logged(chunked.expdir) if "depth_live" in r]
        assert live == [1.0, 1.0]
        tree, _ = tckpt.load_checkpoint(os.path.join(chunked.expdir, "000004.npz"))
        assert int(tree["depth_opt_state"][0]["count"]) == 1  # step 4 alone updated the DepthNet


def test_resume_at_a_chunk_end(tmp_path):
    """nerf mode: 4 steps in chunks, then a new Trainer resuming from
    000004.npz (the step, the Adam moments, the schedule's count) for 4
    more, once in chunks and once per step: the step-8 checkpoints and the
    Iter lines bit for bit. (A resumed run draws a new sampler stream, as
    the JAX Trainer's does, so it is held to the resumed per-step run.)"""
    cfg = mode_cfg(tmp_path, "nerf")
    first = train(cfg, "first", CHUNK, n_iters=5)
    runs = {}
    for k in (1, CHUNK):
        shutil.copytree(os.path.dirname(first.expdir), os.path.join(cfg.basedir, f"resumed_{k}"))
        runs[k] = train(cfg, f"resumed_{k}", k)
        assert runs[k].start == 4 and runs[k].global_step == 8
    assert_same_run(runs[1].expdir, runs[CHUNK].expdir)


LR, K_CHUNK, I0 = 1e-3, 3, 5  # the chunks held to make_multi_step: K_CHUNK depth steps from step I0


def chunk_inputs(seed: int = 1):
    """The [K, N, 9] stack (rays_o, rays_d, target) of one chunk and the
    JAX base key of its steps."""
    rng = np.random.default_rng(seed)
    stack = np.stack([np.concatenate([*rays_np(N, rng), rng.random((N, 3), dtype=np.float32)], -1)
                      for _ in range(K_CHUNK)]).astype(np.float32)
    return stack, jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """One spawn of 2 gloo ranks (tests/test_torch_multiproc.py's
    chunked_trainer_worker): the Trainer per step and in chunks in three
    modes, and one chunk of the sharded plain depth step from the models,
    stack and JAX draws of ``chunk_inputs``."""
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset

    tmp = tmp_path_factory.mktemp("two_ranks")
    datadir = str(tmp / "scene")
    generate_example_dataset(datadir, H=16, W=16, n_train=2, n_val=1, n_test=1)
    ft_path = write_nerf_ckpt(str(tmp / "nerf.npz"))
    _, tparams = small_models()
    stack, base_key = chunk_inputs()
    draws = {i: tuple(jax_step_draws(jax.random.fold_in(base_key, i), N)) for i in range(I0, I0 + K_CHUNK)}
    spec = {"models": {k: getattr(tparams, k).state_dict() for k in ("coarse", "fine", "depth")},
            "pipeline": pipelines(1.0)[1], "stack": stack, "seeds": list(range(I0, I0 + K_CHUNK)), "draws": draws,
            "lr": LR}
    torch.save(spec, tmp / "chunk.pt")
    return run_ranks(chunked_trainer_worker, 2, tmp, datadir, ft_path, str(tmp / "chunk.pt"))


def test_chunked_trainer_on_two_ranks(two_rank_runs):
    """2 gloo ranks, depth_net, nerf and joint mode (its warmup of 3 steps
    ending inside the first chunk), K=4 chunks against the per-step loop:
    the Iter lines and the ranks' parameter checksums bit for bit (data
    parallelism composes with the chunked loop on the CPU)."""
    r0, r1 = two_rank_runs
    for mode in ("depth_net", "nerf", "joint"):
        assert r0[mode][1]["lines"] == r0[mode][CHUNK]["lines"] and len(r0[mode][1]["lines"]) == 2, mode
        for k in (1, CHUNK):
            assert torch.equal(r0[mode][k]["checksum"], r1[mode][k]["checksum"]), mode
        assert torch.equal(r0[mode][1]["checksum"], r0[mode][CHUNK]["checksum"]), mode


# ---------------------------------------------------------------- against JAX's make_multi_step

def assert_chunk_matches(got: dict, step_grads: list, got_params: dict, js, jms) -> None:
    """A chunk's metrics at 1e-5 relative, the last gradients at 1e-5, and
    the parameters as test_torch_train.test_depth_step_matches_jax holds
    them: 1e-5 relative where every step's gradient is well above its own
    tolerance (Adam normalizes a near-zero gradient to a step of up to lr
    whatever its last digits), within one step a step elsewhere."""
    assert set(got) == set(jms)
    for name in got:
        np.testing.assert_allclose(got[name], np.asarray(jms[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    assert_tree_close(step_grads[-1], js.opt_state[0], 1e-5, 1e-5)
    got_p = jax.tree.leaves(got_params)
    per_step = [jax.tree.leaves(g) for g in step_grads]
    gmax = [max(float(np.abs(np.asarray(x)).max()) for x in leaves) for leaves in per_step]
    for i, (g, w) in enumerate(zip(got_p, jax.tree.leaves(js.params))):
        g, w = np.asarray(g), np.asarray(w)
        sharp = np.all([np.abs(np.asarray(leaves[i])) > 1e-3 * m for leaves, m in zip(per_step, gmax)], 0)
        np.testing.assert_allclose(g[sharp], w[sharp], rtol=1e-5, atol=1e-7)
        assert np.abs(g - w).max() <= 2 * LR * K_CHUNK


def jax_chunk(mesh=None):
    """JAX's make_multi_step over ``chunk_inputs``' chunk of depth steps
    (on ``mesh``: the stack sharded on its rays)."""
    jparams, _ = small_models()
    jp, _ = pipelines(1.0)
    opt = optax.chain(stash_grads(), jstate.make_depth_optimizer(LR))
    stack, base_key = chunk_inputs()
    return make_multi_step(jax_depth_step(jp, opt), with_const=True, mesh=mesh)(
        jparams, jstate.init_state(jparams.depth, opt), jnp.asarray(stack), base_key, I0)


def test_plain_depth_chunk_matches_jax_multi_step():
    """One chunk of K=3 plain depth steps from step i0=5, each with the
    draws of fold_in(base_key, i0 + j) as the JAX step derives them, through
    ``StepDispatcher`` (the draws looked up by the step's seed, here its
    index) against ``make_multi_step`` (``assert_chunk_matches``)."""
    _, tparams = small_models()
    _, tp = pipelines(1.0)
    stack, base_key = chunk_inputs()
    js, jms = jax_chunk()
    draws = {i: jax_step_draws(jax.random.fold_in(base_key, i), N) for i in range(I0, I0 + K_CHUNK)}
    tstate = init_state(tparams.depth, LR)
    tstep = make_depth_net_train_step(tp, tparams._replace(depth=None))
    step_grads = []

    def step(batch, seed):
        m = tstep(tstate, batch, seed, draws=draws[seed])[1]
        step_grads.append(tckpt.depth_net_params_to_jax({n: p.grad.clone() for n, p in
                                                         tstate.model.named_parameters()}))
        return m

    disp = StepDispatcher(step, [tstate], "cpu")
    got = disp.read(disp.run(stack, list(range(I0, I0 + K_CHUNK))))
    assert tstate.step == K_CHUNK
    assert_chunk_matches(got, step_grads, tckpt.depth_net_params_to_jax(tstate.model.state_dict()), js, jms)


def test_sharded_depth_chunk_matches_jax_multi_step(two_rank_runs):
    """The same chunk on 2 gloo ranks (each its rows of the stack and the
    draws of the whole batch, the gradients all-reduced) against
    ``make_multi_step(mesh=)`` on 2 of the 8 virtual CPU devices, the stack
    sharded on its rays, at the one-process chunk's tolerances; the two
    ranks' metrics and parameters bit for bit alike."""
    js, jms = jax_chunk(jax_make_mesh(jax.devices()[:2]))
    r0, r1 = (r["chunk"] for r in two_rank_runs)
    for r in (r0, r1):
        assert_chunk_matches(r["metrics"], [tckpt.depth_net_params_to_jax(g) for g in r["grads"]],
                             tckpt.depth_net_params_to_jax(r["params"]), js, jms)
    assert all(np.array_equal(r0["metrics"][k], r1["metrics"][k]) for k in r0["metrics"])
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])


def test_chip_smoke_adam_rule_is_optax():
    """chip_smoke.py's numpy fp32 optax.adam (``optax_adam_np``, the rule
    [dispatch] (e) holds both torch Adams to on the card, without JAX)
    against optax.adam itself: the parameters and both moments bit for bit
    over 8 updates of gradients spread over eight decades."""
    import chip_smoke

    rng = np.random.default_rng(5)
    p = (rng.standard_normal(50_000) * 0.1).astype(np.float32)
    opt = optax.adam(1e-4, b1=0.9, b2=0.999, eps=1e-8)
    jp, jst = jnp.asarray(p), opt.init(jnp.asarray(p))
    mu, nu = np.zeros_like(p), np.zeros_like(p)
    for count in range(1, 9):
        g = (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-8, 0, p.shape)).astype(np.float32)
        u, jst = opt.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, u)
        p, mu, nu = chip_smoke.optax_adam_np(p, g, mu, nu, count, 1e-4)
        np.testing.assert_array_equal(p, np.asarray(jp))
        np.testing.assert_array_equal(mu, np.asarray(jst[0].mu))
        np.testing.assert_array_equal(nu, np.asarray(jst[0].nu))


# ---------------------------------------------------------------- K6's device seed

def hier_case():
    kw = dict(D=2, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True)
    torch.manual_seed(0)
    coarse, fine = NeRF(NeRFConfig(**kw)), NeRF(NeRFConfig(**kw))
    rng = np.random.default_rng(2)
    ro, rd = (torch.from_numpy(a) for a in rays_np(24, rng))
    return coarse, fine, ro, rd


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_k6_plain_takes_a_device_seed(dtype):
    """The plain version (the wrapper on CPU tensors) given a 0-d integer
    tensor draws what the same int seed draws; a seed tensor of another
    shape or type is refused."""
    coarse, fine, ro, rd = hier_case()
    packed = k6.pack_hier(coarse, fine)
    kw = dict(n_coarse=8, n_importance=16, ray_base=3)
    want = k6.fused_render_hier(packed, coarse.cfg, fine.cfg, ro, rd, seed=123456789, **kw)
    got = k6.fused_render_hier(packed, coarse.cfg, fine.cfg, ro, rd, seed=torch.tensor(123456789, dtype=dtype), **kw)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    other = k6.fused_render_hier(packed, coarse.cfg, fine.cfg, ro, rd, seed=torch.tensor(7, dtype=dtype), **kw)
    assert not torch.equal(other["max_z"], want["max_z"])
    for bad in (torch.tensor([7], dtype=dtype), torch.tensor(7.0)):
        with pytest.raises(ValueError, match="device seed"):
            k6.fused_render_hier(packed, coarse.cfg, fine.cfg, ro, rd, seed=bad, **kw)


@pytest.mark.parametrize("by_pointer", [True, False])
def test_k6_launch_hands_the_seed_word(monkeypatch, by_pointer):
    """Against a mocked library: a device seed goes to nst_render_hier as
    its address (seed_ptr, before the seed) with 0 by value; an int goes
    by value with a null address."""
    from test_torch_wgmma_tf32 import mocked_library

    seen = mocked_library(monkeypatch, k6, "nst_render_hier")
    coarse, fine, _, _ = hier_case()
    ro, rd = torch.zeros(8, 3, device="meta"), torch.zeros(8, 3, device="meta")
    seed = torch.zeros((), dtype=torch.int32, device="meta") if by_pointer else 99
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: 4096 if t.dim() == 0 else 0)
    before = build.launches["K6", "bf16"]
    k6.render_hier_kernel(k6.pack_hier(coarse, fine), coarse.cfg, fine.cfg, ro, rd, n_coarse=8, n_importance=16,
                          seed=seed)
    # (..., seed_ptr, seed, ray_base, det, fp32, plan_c, plan_f, stream)
    assert seen["args"][-8:-4] == ((4096, 0, 0, 0) if by_pointer else (None, 99, 0, 0))
    assert build.launches["K6", "bf16"] == before + 1
    with pytest.raises(ValueError, match="device seed"):
        k6.render_hier_kernel(k6.pack_hier(coarse, fine), coarse.cfg, fine.cfg, ro, rd, n_coarse=8,
                              n_importance=16, seed=torch.zeros((), dtype=torch.int32))


def test_depth_step_takes_a_step_seed():
    """The depth step's K6 branch (plain on CPU tensors), on the committed
    checkpoint, with a StepSeed equals the step with the same int seed,
    bit for bit: metrics and the DepthNet after Adam."""
    pipe = production_pipe("cuda")
    rng = np.random.default_rng(3)
    batch = tuple(torch.from_numpy(x) for x in (*rays_np(16, rng), rng.random((16, 3), dtype=np.float32)))
    outs = []
    for seed in (1234, StepSeed(torch.tensor(1234, dtype=torch.int32), torch.Generator().manual_seed(1234))):
        params = tengine.pack_kernel_weights(committed_params(pipe), with_hier=True)
        state = init_state(params.depth, 1e-4)
        state, m = make_depth_net_train_step(pipe, params._replace(depth=None))(state, batch, seed)
        outs.append((m, [p.detach().clone() for p in state.model.parameters()]))
    (m0, p0), (m1, p1) = outs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
