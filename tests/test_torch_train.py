"""The port's depth-net training against the JAX package on CPU.

- The depth step (plain branch) against JAX ``make_depth_net_train_step``
  (XLA path) for 2 steps, the draws built from the JAX step's key as it
  derives them: losses, fg/bg diagnostics, DepthNet gradients and the
  params after Adam at 1e-5 relative (gradients against their largest
  element), with ``bg_depth_loss_weight`` 1.0 and 0.0.
- The K6 branch (its plain bf16 version on CPU) against the plain branch
  on the committed checkpoint: equal img_loss, depth loss within 5%.
- ``RaySampler`` batches bit-identical to the JAX sampler's.
- Checkpoints both ways, and an exact resume.
- The Trainer and the CLI end to end on a tiny scene, the DepthNet repack
  before each eval, the options that raise (data parallelism without its
  ranks), steps_per_dispatch > 1 on the CPU (chunks of eager steps, equal
  to the per-step run; tests/test_torch_dispatch.py holds the rest) and
  the wandb fallback (nerf and joint training:
  tests/test_torch_nerf_train.py).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_sampling_tpu.data.example import make_example_scene
from nerf_sampling_tpu.models import DepthNetConfig as JDepthNetConfig
from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig
from nerf_sampling_tpu.models import depth_net_apply, depth_net_init, nerf_init_active
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu.train import checkpoint as jckpt
from nerf_sampling_tpu.train import sampler as jsampler
from nerf_sampling_tpu.train import state as jstate
from nerf_sampling_tpu.train.steps import make_depth_net_train_step as jax_depth_step
from nerf_sampling_tpu_torch.data.example import generate_example_dataset
from nerf_sampling_tpu_torch.data.types import SceneData
from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
from nerf_sampling_tpu_torch.experiments import run
from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.train import checkpoint as tckpt
from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
from nerf_sampling_tpu_torch.train.state import init_state
from nerf_sampling_tpu_torch.train.steps import StepDraws, check_hier_oracle, depth_net_loss, make_depth_net_train_step
from nerf_sampling_tpu_torch.train.trainer import Trainer
from nerf_sampling_tpu_torch.utils.config import TrainerConfig, load_trainer_config
from nerf_sampling_tpu_torch.utils.logging import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "evidence", "ckpt", "example_depth.npz")
N, NC, NF = 130, 8, 16
NERF_KW = dict(D=2, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True)
DEPTH_KW = dict(hidden_sizes=(32, 32, 32), cat_hidden_sizes=(32, 32, 32))


def rays_np(n, rng):
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    rd[:, 2] = -1.0
    return ro, rd


def small_models():
    """The same active 2x32 NeRFs and 3x32 DepthNet in both packages."""
    jc = nerf_init_active(jax.random.PRNGKey(3), JNeRFConfig(**NERF_KW))
    jf = nerf_init_active(jax.random.PRNGKey(4), JNeRFConfig(**NERF_KW))
    jd = depth_net_init(jax.random.PRNGKey(5), JDepthNetConfig(**DEPTH_KW))
    sds = tckpt.params_from_jax(jax.tree.map(np.asarray, {"coarse": jc, "fine": jf, "depth": jd}))
    coarse, fine, depth = NeRF(NeRFConfig(**NERF_KW)), NeRF(NeRFConfig(**NERF_KW)), DepthNet(DepthNetConfig(**DEPTH_KW))
    for m, k in ((coarse, "coarse"), (fine, "fine"), (depth, "depth")):
        m.load_state_dict(sds[k], strict=True)
    return jengine.NeRFParams(jc, jf, jd), tengine.NeRFParams(coarse, fine, depth)


def pipelines(bg_weight):
    kw = dict(N_samples=NC, N_importance=NF, bg_depth_loss_weight=bg_weight)
    jp = jengine.Pipeline(nerf=JNeRFConfig(**NERF_KW), fine=JNeRFConfig(**NERF_KW),
                          depth=JDepthNetConfig(**DEPTH_KW), mlp_impl="xla", **kw)
    tp = tengine.Pipeline(nerf=NeRFConfig(**NERF_KW), fine=NeRFConfig(**NERF_KW),
                          depth=DepthNetConfig(**DEPTH_KW), mlp_impl="plain", **kw)
    return jp, tp


def jax_step_draws(key, n):
    """The draws the JAX step's XLA path takes from its key: split ->
    split(., 4) -> uniform (render_rays_train, sample_as_in_nerf)."""
    k_nerf, _ = jax.random.split(key)
    k_strat, _, k_pdf, _ = jax.random.split(k_nerf, 4)
    t_rand = np.asarray(jax.random.uniform(k_strat, (n, NC)))
    u = np.asarray(jax.random.uniform(k_pdf, (n, NF)))
    return StepDraws(torch.from_numpy(t_rand), torch.from_numpy(u))


def stash_grads():
    """An optax transform that keeps the step's gradients in its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def assert_tree_close(got: dict, want, rtol, scale_atol=0.0):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    atol = scale_atol * max(float(np.abs(np.asarray(w)).max()) for w in want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("bg_weight", [1.0, 0.0])
def test_depth_step_matches_jax(rng, bg_weight):
    jparams, tparams = small_models()
    jp, tp = pipelines(bg_weight)
    lr = 1e-3
    opt = optax.chain(stash_grads(), jstate.make_depth_optimizer(lr))
    jstate_ = jstate.init_state(jparams.depth, opt)
    jstep = jax_depth_step(jp, opt)
    tstate = init_state(tparams.depth, lr)
    tstep = make_depth_net_train_step(tp, tparams._replace(depth=None))
    for it in range(2):
        ro, rd = rays_np(N, rng)
        target = rng.random((N, 3), dtype=np.float32)
        key = jax.random.PRNGKey(10 + it)
        rays = jengine.make_ray_batch(jp, jnp.asarray(ro), jnp.asarray(rd))
        jstate_, jm = jstep(jparams, jstate_, (rays, jnp.asarray(target)), key)
        batch = tuple(torch.from_numpy(x) for x in (ro, rd, target))
        tstate, tm = tstep(tstate, batch, seed=0, draws=jax_step_draws(key, N))
        assert set(tm) == set(jm)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        if bg_weight == 0.0:  # only foreground rays in the depth objective
            np.testing.assert_allclose(float(tm["depth_net_loss"]),
                                       float(tm["depth_loss_fg"] * tm["fg_frac"]), rtol=1e-5)
        grads = {n: p.grad for n, p in tstate.model.named_parameters()}
        jgrads = jstate_.opt_state[0]
        assert_tree_close(tckpt.depth_net_params_to_jax(grads), jgrads, 1e-5, 1e-5)
        # after Adam: 1e-5 relative where the gradient is well above its own
        # tolerance; Adam normalizes a near-zero gradient to a step of up to
        # lr whatever its last digits, so there the bound is one step
        gmax = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(jgrads))
        got_p = jax.tree.leaves(tckpt.depth_net_params_to_jax(tstate.model.state_dict()))
        for g, w, jg in zip(got_p, jax.tree.leaves(jstate_.params), jax.tree.leaves(jgrads)):
            g, w, jg = np.asarray(g), np.asarray(w), np.abs(np.asarray(jg))
            sharp = jg > 1e-3 * gmax
            np.testing.assert_allclose(g[sharp], w[sharp], rtol=1e-5, atol=1e-7)
            assert np.abs(g - w).max() <= 2 * lr * (it + 1)
    assert tstate.step == 2
    for m in (tparams.coarse, tparams.fine):  # the NeRF is frozen
        assert all(not p.requires_grad and p.grad is None for p in m.parameters())


def committed_params(pipe):
    return tckpt.load_render_params(CKPT, pipe, "cpu")


def production_pipe(mlp_impl):
    cfg = load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    return dataclasses.replace(cfg.pipeline(), mlp_impl=mlp_impl)


def test_k6_branch_agrees_with_plain_branch_on_cpu(rng):
    """The K6 branch (its plain bf16 version on CPU tensors) and the plain
    fp32 branch, from one state, batch and draws, on the committed NeRF."""
    cuda_pipe, plain_pipe = production_pipe("cuda"), production_pipe("plain")
    params = tengine.pack_kernel_weights(committed_params(cuda_pipe), with_hier=True)
    n = 64
    H = W = 400
    focal = 0.5 * 800 / np.tan(0.5 * 0.6911112070083618) / 2.0
    from nerf_sampling_tpu_torch.core.rays import get_rays_np
    from nerf_sampling_tpu_torch.data.example import _orbit_poses

    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    ro, rd = get_rays_np(H, W, K, _orbit_poses(4, 2)[0][:3, :4])
    idx = rng.choice(H * W, n, replace=False)
    ro, rd = (torch.from_numpy(np.ascontiguousarray(a.reshape(-1, 3)[idx], np.float32)) for a in (ro, rd))
    target = torch.from_numpy(rng.random((n, 3), dtype=np.float32))
    draws = StepDraws(torch.rand(n, 64, generator=torch.Generator().manual_seed(1)),
                      torch.rand(n, 128, generator=torch.Generator().manual_seed(2)))
    out = {}
    for name, pipe in (("cuda", cuda_pipe), ("plain", plain_pipe)):
        params.depth.zero_grad(set_to_none=True)
        rays = tengine.make_ray_batch(pipe, ro, rd)
        loss, m = depth_net_loss(pipe, params, params.depth, rays, target, 0, draws)
        loss.backward()
        g = torch.cat([p.grad.flatten() for p in params.depth.parameters()])
        out[name] = (m, g)
    (mk, gk), (mp, gp) = out["cuda"], out["plain"]
    assert float(mk["loss"]) == float(mp["loss"])  # the depth-point query is the same fp32 code
    np.testing.assert_allclose(float(mk["depth_net_loss"]), float(mp["depth_net_loss"]), rtol=0.05)
    assert float(torch.nn.functional.cosine_similarity(gk, gp, dim=0)) >= 0.99


def test_k6_branch_raises_outside_its_envelope():
    _, tparams = small_models()
    _, tp = pipelines(1.0)
    cp = dataclasses.replace(tp, mlp_impl="cuda")
    for bad, match in ((dict(raw_noise_std=1.0), "raw_noise_std"), (dict(N_samples=3), "N_samples"),
                       (dict(N_importance=0), "N_importance"), (dict(use_viewdirs=False), "use_viewdirs")):
        with pytest.raises(ValueError, match=match):
            make_depth_net_train_step(dataclasses.replace(cp, **bad), tparams._replace(depth=None))
    # NDC is no envelope miss: the target pass is the composable one with K4 queries, as in JAX
    ndc = dataclasses.replace(cp, ndc=True, near=0.0, far=1.0, H=8, W=8, focal=9.0)
    assert not check_hier_oracle(ndc)
    make_depth_net_train_step(ndc, tparams._replace(depth=None))


def port_scene(jscene):
    return SceneData(**{f.name: getattr(jscene, f.name) for f in dataclasses.fields(SceneData)})


@pytest.mark.parametrize("batching,n_rand", [(False, 64), (True, 300)])
def test_ray_sampler_matches_jax(batching, n_rand):
    jscene = make_example_scene(H=20, W=20, n_train=3, n_val=1, n_test=1)
    js = jsampler.RaySampler(jscene, jsampler.SamplerConfig(N_rand=n_rand, use_batching=batching,
                                                            precrop_iters=2), seed=7)
    ts = RaySampler(port_scene(jscene), SamplerConfig(N_rand=n_rand, use_batching=batching,
                                                      precrop_iters=2), seed=7)
    for i in range(5):  # batching crosses an epoch (1200 rays) at the 4th batch
        for a, b in zip(ts.sample(i), js.sample(i)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def train_steps(tp, tparams, depth, n_steps, rng_seed=0, state=None, lr=1e-3):
    rng = np.random.default_rng(rng_seed)
    step = make_depth_net_train_step(tp, tparams._replace(depth=None))
    state = state or init_state(depth, lr)
    batches = [(*rays_np(N, rng), rng.random((N, 3), dtype=np.float32)) for _ in range(4)]
    for i in range(state.step, state.step + n_steps):
        state, _ = step(state, tuple(torch.from_numpy(x) for x in batches[i]), seed=100 + i)
    return state


def save_port_ckpt(path, tparams, state):
    sds = {"coarse": tparams.coarse.state_dict(), "fine": tparams.fine.state_dict(),
           "depth": state.model.state_dict()}
    tckpt.save_checkpoint(path, {"params": tckpt.JaxNeRFParams(**tckpt.params_to_jax(sds)),
                                 "opt_state": tckpt.adam_state_to_jax(state.model, state.optimizer)},
                          state.step)


def test_port_checkpoint_loads_in_jax(tmp_path, rng):
    jparams, tparams = small_models()
    _, tp = pipelines(1.0)
    state = train_steps(tp, tparams, tparams.depth, 2)
    path = str(tmp_path / "depth_000002.npz")
    save_port_ckpt(path, tparams, state)
    opt = jstate.make_depth_optimizer(1e-3)
    template = {"params": jparams, "opt_state": opt.init(jparams.depth)}
    restored, step = jckpt.load_checkpoint(path, template)
    assert step == 2 and int(restored["opt_state"][0].count) == 2
    ro, rd = rays_np(N, rng)
    want = depth_net_apply(restored["params"].depth, JDepthNetConfig(**DEPTH_KW), jnp.asarray(ro), jnp.asarray(rd))
    with torch.no_grad():
        got = state.model(torch.from_numpy(ro), torch.from_numpy(rd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    mu = {n: state.optimizer.state[p]["exp_avg"] for n, p in state.model.named_parameters()}
    assert_tree_close(tckpt.depth_net_params_to_jax(mu), restored["opt_state"][0].mu, 0.0)
    assert_tree_close(tckpt.nerf_params_to_jax(tparams.fine.state_dict()), restored["params"].fine, 0.0)


def test_jax_checkpoint_loads_in_port(tmp_path, rng):
    jparams, _ = small_models()
    jp, tp = pipelines(1.0)
    opt = jstate.make_depth_optimizer(1e-3)
    js = jstate.init_state(jparams.depth, opt)
    ro, rd = rays_np(N, rng)
    rays = jengine.make_ray_batch(jp, jnp.asarray(ro), jnp.asarray(rd))
    js, _ = jax_depth_step(jp, opt)(jparams, js, (rays, jnp.full((N, 3), 0.5)), jax.random.PRNGKey(0))
    path = str(tmp_path / "depth_000001.npz")
    jckpt.save_checkpoint(path, {"params": jparams._replace(depth=js.params), "opt_state": js.opt_state}, 1)
    tree, step = tckpt.load_checkpoint(path)
    depth = DepthNet(DepthNetConfig(**DEPTH_KW))
    depth.load_state_dict(tckpt.params_from_jax(tree["params"])["depth"], strict=True)
    state = init_state(depth, 1e-3, step)
    assert tckpt.adam_state_from_jax(tree["opt_state"], depth, state.optimizer) == 1
    want = depth_net_apply(js.params, JDepthNetConfig(**DEPTH_KW), jnp.asarray(ro), jnp.asarray(rd))
    with torch.no_grad():
        got = depth(torch.from_numpy(ro), torch.from_numpy(rd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    nu = {n: state.optimizer.state[p]["exp_avg_sq"] for n, p in depth.named_parameters()}
    assert_tree_close(tckpt.depth_net_params_to_jax(nu), js.opt_state[0].nu, 0.0)


def test_resume_is_exact(tmp_path):
    """2 steps, save, load into a new DepthNet and Adam, 2 more steps ==
    4 steps straight, bit for bit."""
    _, tparams = small_models()
    _, tp = pipelines(1.0)
    d0 = {k: v.clone() for k, v in tparams.depth.state_dict().items()}

    def fresh():
        m = DepthNet(DepthNetConfig(**DEPTH_KW))
        m.load_state_dict(d0)
        return m

    straight = train_steps(tp, tparams, fresh(), 4)
    half = train_steps(tp, tparams, fresh(), 2)
    path = str(tmp_path / "depth_000002.npz")
    save_port_ckpt(path, tparams, half)
    tree, step = tckpt.load_checkpoint(path)
    resumed_model = DepthNet(DepthNetConfig(**DEPTH_KW))
    resumed_model.load_state_dict(tckpt.params_from_jax(tree["params"])["depth"])
    resumed = init_state(resumed_model, 1e-3, step)
    tckpt.adam_state_from_jax(tree["opt_state"], resumed_model, resumed.optimizer)
    resumed = train_steps(tp, tparams, resumed_model, 2, state=resumed)
    assert resumed.step == straight.step == 4
    for k, v in straight.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0, atol=0)


def tiny_scene(tmp_path):
    datadir = str(tmp_path / "scene")
    generate_example_dataset(datadir, H=32, W=32, n_train=3, n_val=1, n_test=2)
    return datadir


def nerf_only_npz(path):
    """A JAX-written, NeRF-only checkpoint of active 2x32 NeRFs."""
    jparams, _ = small_models()
    jckpt.save_checkpoint(path, {"params": jparams._replace(depth=None)}, 0)
    return path


def tiny_trainer_cfg(tmp_path, **kw):
    base = dict(
        datadir=tiny_scene(tmp_path), basedir=str(tmp_path / "logs"), expname="e2e",
        netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, n_layers=3, layer_width=32,
        sphere_radius=2.0, N_samples=NC, N_importance=NF, N_rand=64, n_depth_samples=16,
        sampling_mode="gaussian", distance=1.0, mlp_impl="cuda", i_testset=2, i_weights=2,
        i_print=1, keep_best=True, testskip=1, bg_depth_loss_weight=0.0,
        ft_path=nerf_only_npz(str(tmp_path / "nerf.npz")),
    )
    base.update(kw)
    return TrainerConfig(**base)


def test_trainer_end_to_end_and_repack(tmp_path):
    cfg = tiny_trainer_cfg(tmp_path)
    tr = Trainer(cfg, device="cpu")
    tr.train(N_iters=3)
    exp = tr.expdir
    for f in ("args.txt", "psnr.txt", "metrics.jsonl", "depth_000002.npz",
              os.path.join("best", "depth_000002.npz"), os.path.join("testset_000002", "000.png"),
              os.path.join("testset_000002", "psnr.txt")):
        assert os.path.exists(os.path.join(exp, f)), f
    lines = open(os.path.join(exp, "psnr.txt")).read().splitlines()
    assert [ln.split()[1] for ln in lines] == ["1", "2"]
    assert "Depth Net Loss" in lines[0]
    # the eval rendered a fresh pack of the trained DepthNet, not the load-time one
    assert tr.eval_params.kernels.nerf is tr.params.kernels.nerf
    stale = tr.params  # packed at setup, before the steps
    K, c2w = tr.scene.intrinsics(), tr.scene.poses[tr.scene.i_test[0]][:3, :4]
    H, W, _ = tr.scene.hwf

    def view(params):
        return tengine.render_image(tr.pipeline, params, H, W, K, c2w, device="cpu",
                                    generator=torch.Generator().manual_seed(0))["depth_net_rgb_map"].numpy()

    fresh, old = view(tr.eval_params), view(stale)
    assert np.abs(fresh - old).max() > 1e-4
    gt = tr.scene.images[tr.scene.i_test[0]]
    logged = open(os.path.join(exp, "testset_000002", "psnr.txt")).readline()
    np.testing.assert_allclose(float(logged.split("PSNR: ")[1]),
                               -10 * np.log10(np.mean((fresh - gt) ** 2)), rtol=1e-5)
    # resume from depth_000002.npz: the step count and Adam moments come back
    tr2 = Trainer(cfg, device="cpu")
    tr2.train(N_iters=4)
    assert tr2.start == 2 and tr2.global_step == 3


@pytest.mark.parametrize("field,value,exc,match", [
    ("n_devices", 2, ValueError, r"run --n_devices 2 .*torchrun --nproc_per_node 2"),
    ("multihost", True, ValueError, r"\['RANK'\] set but \['MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'LOCAL_RANK'\] "
                                    "missing"),
])
def test_trainer_unported_options_raise(monkeypatch, field, value, exc, match):
    """Data parallelism without its ranks raises before any work: n_devices=2
    with no process group names the ways to start them, multihost with a
    partial launcher environment names what is missing."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    if field == "multihost":
        monkeypatch.setenv("RANK", "0")
    with pytest.raises(exc, match=match):
        Trainer(dataclasses.replace(TrainerConfig(), **{field: value}), device="cpu")


def test_trainer_steps_per_dispatch_trains_on_cpu(tmp_path):
    """steps_per_dispatch=4 on the CPU runs one chunk of 4 eager steps
    (train/dispatch.py) whose log and checkpoint equal the per-step run's."""
    cfg = tiny_trainer_cfg(tmp_path, i_print=4, i_weights=4, i_testset=8)
    runs = []
    for k in (4, 1):
        tr = Trainer(dataclasses.replace(cfg, basedir=str(tmp_path / f"k{k}"), steps_per_dispatch=k), device="cpu")
        tr.train(N_iters=5)
        assert tr.global_step == 4
        with np.load(os.path.join(tr.expdir, "depth_000004.npz")) as z:
            runs.append((open(os.path.join(tr.expdir, "psnr.txt")).read(), {k: z[k] for k in z.files}))
    (log4, ck4), (log1, ck1) = runs
    assert log4 == log1 and log4.startswith("Iter: 4")
    assert sorted(ck4) == sorted(ck1) and all(np.array_equal(ck4[k], ck1[k]) for k in ck1)


@pytest.mark.parametrize("dataset_type", ["blender", "llff", "LINEMOD", "deepvoxels", "bogus"])
def test_trainer_takes_every_dataset_type(tmp_path, dataset_type):
    """The four formats construct a Trainer whose load_data reaches its
    loader (here on a directory that does not exist); an unknown type
    raises ValueError there, as in JAX. tests/test_torch_ndc.py trains on
    each."""
    tr = Trainer(dataclasses.replace(TrainerConfig(), dataset_type=dataset_type, datadir=str(tmp_path / "none")),
                 device="cpu")
    with pytest.raises(ValueError if dataset_type == "bogus" else FileNotFoundError):
        tr.load_data()


def test_wandb_and_missing_ft_path_raise(tmp_path, capsys, monkeypatch):
    """wandb_mode="online" without wandb falls back to metrics.jsonl with
    the JAX logger's message; a missing ft_path raises."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # not importable, whatever is installed
    logger = MetricsLogger(str(tmp_path / "log"), "online")
    logger.log({"loss": 0.5}, 3)
    logger.close()
    assert "wandb not installed; falling back to jsonl" in capsys.readouterr().out
    assert json.loads((tmp_path / "log" / "metrics.jsonl").read_text())["loss"] == 0.5
    tr = Trainer(tiny_trainer_cfg(tmp_path, wandb_mode="online", i_testset=10), device="cpu")
    tr.train(N_iters=2)
    assert tr.global_step == 1 and os.path.exists(os.path.join(tr.expdir, "metrics.jsonl"))
    cfg = tiny_trainer_cfg(tmp_path, ft_path=str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, device="cpu").train(N_iters=2)


def test_cli_trains_the_recipe(tmp_path):
    """run.py's flags and overrides: the production recipe, 1024 rays a step
    (64x64 scene, 32x32 after half_res), kernel path on CPU tensors."""
    datadir = str(tmp_path / "scene")
    generate_example_dataset(datadir, H=64, W=64, n_train=2, n_val=1, n_test=1)
    tr = run.main(["-dp", datadir, "-m", "recommended_depth_net_module", "--mlp_impl", "cuda",
                   "--n_iters", "2", "-ip", "1", "--basedir", str(tmp_path / "logs"), "--testskip", "1",
                   "--seed", "3", "--device", "cpu"])
    cfg = tr.cfg
    assert (cfg.n_layers, cfg.layer_width, cfg.depth_net_lr, cfg.sphere_radius) == (10, 256, 1e-4, 2)
    assert (cfg.sampling_mode, cfg.n_depth_samples, cfg.i_testset, cfg.seed) == ("gaussian", 64, 2500, 3)
    assert cfg.expname == "custom_depth_net" and tr.global_step == 2
    assert len(open(os.path.join(tr.expdir, "psnr.txt")).read().splitlines()) == 2
    # --steps_per_dispatch 4 on the CPU: chunks of 4 eager steps, equal to --steps_per_dispatch 1
    config = tmp_path / "small.yaml"
    config.write_text("small:\n  kwargs:\n    N_rand: 64\n    netdepth: 2\n    netwidth: 32\n    netdepth_fine: 2\n"
                      "    netwidth_fine: 32\n    N_samples: 8\n    N_importance: 16\n    i_weights: 100\n")
    logs = {}
    for k in ("4", "1"):
        tr = run.main(["-c", str(config), "-m", "small", "-dp", datadir, "--mode", "nerf", "--steps_per_dispatch", k,
                       "--n_iters", "8", "-ip", "4", "--basedir", str(tmp_path / f"spd{k}"), "--testskip", "1",
                       "--device", "cpu"])
        assert tr.cfg.steps_per_dispatch == int(k) and tr.global_step == 8
        logs[k] = (open(os.path.join(tr.expdir, "psnr.txt")).read(),
                   torch.cat([p.detach().flatten() for p in tr.params.fine.parameters()]))
    assert logs["4"][0] == logs["1"][0] and len(logs["4"][0].splitlines()) == 2
    assert torch.equal(logs["4"][1], logs["1"][1])


def test_cli_default_recipe_on_kernels_raises_before_step_1(tmp_path):
    """The default -m leaves sampling_mode unset, so run.py evaluates the
    depth_only population, which the kernels do not render: the Trainer
    raises at construction, naming the ways out, and writes no checkpoint
    (before, the run trained i_testset steps and died at its first eval)."""
    datadir = str(tmp_path / "scene")
    generate_example_dataset(datadir, H=32, W=32, n_train=2, n_val=1, n_test=1)
    basedir = tmp_path / "logs"
    with pytest.raises(ValueError, match="recommended_depth_net_module.*sampling_mode.*--mlp_impl plain"):
        run.main(["-dp", datadir, "--mlp_impl", "cuda", "--n_iters", "2", "--basedir", str(basedir),
                  "--testskip", "1", "--device", "cpu"])
    written = [f for _, _, files in os.walk(basedir) for f in files] if basedir.exists() else []
    assert not [f for f in written if f.endswith(".npz")]


@pytest.mark.parametrize("sampling_mode,ok", [("depth_only", False), ("uniform", True), ("gaussian", True)])
def test_trainer_checks_the_kernel_eval_envelope_at_setup(sampling_mode, ok):
    cfg = load_trainer_config(REFERENCE_CONFIG, "lego_depth_net_module")
    cfg = dataclasses.replace(cfg, mlp_impl="cuda", sampling_mode=sampling_mode)
    if ok:
        Trainer(cfg, device="cpu")
        Trainer(dataclasses.replace(cfg, mlp_impl="plain", sampling_mode="depth_only"), device="cpu")
    else:
        with pytest.raises(ValueError, match="depth_only"):
            Trainer(cfg, device="cpu")
