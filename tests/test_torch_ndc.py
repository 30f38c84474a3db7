"""The port's NDC route (forward-facing scenes) against the JAX package on CPU.

- ``ndc_rays`` at 1e-6 relative; ``make_ray_batch`` under NDC: the
  viewdirs from the directions before the reprojection, the pipeline's
  H/W/focal or the arguments', ValueError without them.
- One nerf step and one depth step (the composable target pass: K6 does
  not serve NDC) against JAX's XLA steps, the draws from the JAX key:
  metrics at 1e-5 relative, grads as tests/test_torch_nerf_train.py and
  tests/test_torch_train.py hold them.
- DEPTH_NET (gaussian, the JAX draws injected) and FULL_NERF evals against
  JAX's XLA render of an 8x8 forward-facing view: DEPTH_NET at 1e-4
  absolute (disp 2e-4 relative); FULL_NERF at test_torch_nerf_train.py's per-ray inverse-CDF
  tail bounds.
- The Trainer on each dataset type (a tiny generated LLFF scene: NDC,
  near/far 0 and 1, H/W/focal from the scene, ``i_test`` from
  ``llffhold``; LINEMOD; DeepVoxels), and run.py and render.py with
  ``-d example_llff``.
- The routing of ``mlp_impl="cuda"`` under NDC, each kernel wrapper
  replaced by a recorder that calls it (on CPU tensors: its plain
  version): DEPTH_NET reaches K1 and K4, FULL_NERF and NERF_MAX K4, the
  depth step K4, the nerf and joint steps K4 and K5; K2, K3, K6 and the
  other render kernels never. COMPARE_NERF and "cuda_int8" raise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_study_optuna import TINY_YAML
from test_torch_nerf_train import assert_one_adam_step, draws_from_key, net_tree, tree_rel
from test_torch_train import DEPTH_KW, NC, NERF_KW, NF, assert_tree_close, jax_step_draws, stash_grads

from nerf_sampling_tpu.core.rays import ndc_rays as jax_ndc_rays
from nerf_sampling_tpu.models import DepthNetConfig as JDepthNetConfig
from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig
from nerf_sampling_tpu.models import depth_net_init, nerf_init_active
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu.train import state as jstate
from nerf_sampling_tpu.train.steps import make_depth_net_train_step as jax_depth_step
from nerf_sampling_tpu.train.steps import make_nerf_train_step as jax_nerf_step
from nerf_sampling_tpu_torch.core.rays import get_rays_np, ndc_rays
from nerf_sampling_tpu_torch.data.example import (
    generate_example_deepvoxels_dataset,
    generate_example_linemod_dataset,
    generate_example_llff_dataset,
)
from nerf_sampling_tpu_torch.experiments import render as rcli
from nerf_sampling_tpu_torch.experiments import run
from nerf_sampling_tpu_torch.kernels import fused_depth_net, fused_hier, fused_nerf_vjp, fused_render
from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.train import checkpoint as tckpt
from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
from nerf_sampling_tpu_torch.train.steps import (
    check_hier_oracle,
    make_depth_net_train_step,
    make_joint_train_step,
    make_nerf_train_step,
)
from nerf_sampling_tpu_torch.train.trainer import Trainer
from nerf_sampling_tpu_torch.utils.config import TrainerConfig

H = W = 8
FOCAL = 9.0
N_RAYS = H * W
LR = 1e-3
# the DepthNet of an NDC scene spans NDC depth [0, 1], as the Trainer builds it from the llff loader's near/far
DEPTH_NDC = dict(DEPTH_KW, near=0.0, far=1.0)
GEOM = dict(ndc=True, near=0.0, far=1.0, H=H, W=W, focal=FOCAL)


def forward_rays():
    """An 8x8 view of a forward-facing camera (LLFF-like: near z=0, looking
    down -z, slightly turned), as [64, 3] rays_o and rays_d."""
    c2w = np.eye(4, dtype=np.float32)[:3]
    th = 0.1
    c2w[:, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    c2w[:, 3] = [0.05, -0.02, 0.1]
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1.0]], np.float32)
    ro, rd = get_rays_np(H, W, K, c2w)
    return K, c2w, np.ascontiguousarray(ro.reshape(-1, 3), np.float32), rd.reshape(-1, 3).astype(np.float32)


def ndc_models():
    """The same active 2x32 NeRFs and 3x32 DepthNet (NDC depth range) in both packages."""
    jc = nerf_init_active(jax.random.PRNGKey(3), JNeRFConfig(**NERF_KW))
    jf = nerf_init_active(jax.random.PRNGKey(4), JNeRFConfig(**NERF_KW))
    jd = depth_net_init(jax.random.PRNGKey(5), JDepthNetConfig(**DEPTH_NDC))
    sds = tckpt.params_from_jax(jax.tree.map(np.asarray, {"coarse": jc, "fine": jf, "depth": jd}))
    coarse, fine, depth = NeRF(NeRFConfig(**NERF_KW)), NeRF(NeRFConfig(**NERF_KW)), DepthNet(DepthNetConfig(**DEPTH_NDC))
    for m, k in ((coarse, "coarse"), (fine, "fine"), (depth, "depth")):
        m.load_state_dict(sds[k], strict=True)
    return jengine.NeRFParams(jc, jf, jd), tengine.NeRFParams(coarse, fine, depth)


def ndc_pipelines(**kw):
    kw = dict(N_samples=NC, N_importance=NF, **GEOM, **kw)
    jp = jengine.Pipeline(nerf=JNeRFConfig(**NERF_KW), fine=JNeRFConfig(**NERF_KW),
                          depth=JDepthNetConfig(**DEPTH_NDC), mlp_impl="xla", **kw)
    tp = tengine.Pipeline(nerf=NeRFConfig(**NERF_KW), fine=NeRFConfig(**NERF_KW),
                          depth=DepthNetConfig(**DEPTH_NDC), mlp_impl="plain", **kw)
    return jp, tp


def test_ndc_rays_matches_jax(rng):
    ro = rng.uniform(-0.3, 0.3, (256, 3)).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.6, 0.6, (256, 2)), -rng.uniform(0.5, 1.5, (256, 1))], -1).astype(np.float32)
    got = ndc_rays(40, 52, 47.5, 1.0, torch.from_numpy(ro), torch.from_numpy(rd))
    want = jax_ndc_rays(40, 52, 47.5, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_make_ray_batch_ndc_matches_jax():
    jp, tp = ndc_pipelines()
    _, _, ro, rd = forward_rays()
    for args in ({}, dict(H=2 * H, W=W, focal=7.0)):  # the pipeline's geometry, then the arguments'
        got = tengine.make_ray_batch(tp, torch.from_numpy(ro), torch.from_numpy(rd), **args)
        want = jengine.make_ray_batch(jp, jnp.asarray(ro), jnp.asarray(rd), **args)
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=name)
    unit = rd / np.linalg.norm(rd, axis=-1, keepdims=True)  # the viewdirs come before the reprojection
    np.testing.assert_allclose(got.viewdirs.numpy(), unit, rtol=1e-6)
    with pytest.raises(ValueError, match="H/W/focal"):
        tengine.make_ray_batch(dataclasses.replace(tp, focal=None), torch.from_numpy(ro), torch.from_numpy(rd))


def test_nerf_step_ndc_matches_jax(rng):
    """One NDC nerf step against JAX's: metrics at 1e-5 relative, coarse
    and fine grads at 1e-3 of each net's largest, params as
    ``assert_one_adam_step`` (test_nerf_step_matches_jax's bounds)."""
    jparams, tparams = ndc_models()
    jp, tp = ndc_pipelines()
    opt = optax.chain(stash_grads(), jstate.make_nerf_optimizer(LR, 1))
    js = jstate.init_state(jparams._replace(depth=None), opt)
    ts = init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), LR, 1)
    _, _, ro, rd = forward_rays()
    target = rng.random((N_RAYS, 3), dtype=np.float32)
    key = jax.random.PRNGKey(100)
    rays = jengine.make_ray_batch(jp, jnp.asarray(ro), jnp.asarray(rd))
    js, jm = jax_nerf_step(jp, opt)(js, (rays, jnp.asarray(target)), key)
    ts, tm = make_nerf_train_step(tp)(ts, tuple(torch.from_numpy(x) for x in (ro, rd, target)), seed=0,
                                      draws=draws_from_key(key, N_RAYS))
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for net in ("coarse", "fine"):
        assert tree_rel(net_tree(ts.model, net, "grad"), getattr(js.opt_state[0], net)) <= 1e-3
        assert_one_adam_step(net_tree(ts.model, net), getattr(js.params, net), LR)


def test_depth_step_ndc_matches_jax(rng):
    """One NDC depth step (the composable target pass) against JAX's XLA
    step: metrics at 1e-5 relative, the DepthNet's grads at 1e-5 of the
    largest (test_depth_step_matches_jax's bounds)."""
    jparams, tparams = ndc_models()
    jp, tp = ndc_pipelines()
    opt = optax.chain(stash_grads(), jstate.make_depth_optimizer(LR))
    js = jstate.init_state(jparams.depth, opt)
    ts = init_state(tparams.depth, LR)
    _, _, ro, rd = forward_rays()
    target = rng.random((N_RAYS, 3), dtype=np.float32)
    key = jax.random.PRNGKey(11)
    rays = jengine.make_ray_batch(jp, jnp.asarray(ro), jnp.asarray(rd))
    js, jm = jax_depth_step(jp, opt)(jparams, js, (rays, jnp.asarray(target)), key)
    ts, tm = make_depth_net_train_step(tp, tparams._replace(depth=None))(
        ts, tuple(torch.from_numpy(x) for x in (ro, rd, target)), seed=0, draws=jax_step_draws(key, N_RAYS))
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    grads = {n: p.grad for n, p in ts.model.named_parameters()}
    assert_tree_close(tckpt.depth_net_params_to_jax(grads), js.opt_state[0], 1e-5, 1e-5)


def jax_eval_noise(key, n_samples: int) -> torch.Tensor:
    """The gaussian population's draws of JAX's render_image of one tile:
    split(key, 1)[0] -> split -> normal."""
    k_pop, _ = jax.random.split(jax.random.split(key, 1)[0])
    return torch.from_numpy(np.asarray(jax.random.normal(k_pop, (N_RAYS, n_samples - 1))))


@pytest.mark.parametrize("mode", ["depth_net", "full_nerf"])
def test_eval_ndc_matches_jax(monkeypatch, mode):
    """DEPTH_NET (gaussian, 16 samples, std 0.25, JAX's draws injected) at
    1e-4 absolute on every map but disp, 2e-4 relative there (measured: 3.2e-5
    on the weights, 9.3e-5 relative on disp, from the fp32 DepthNet's sums in
    another order); FULL_NERF: max_z at 1e-4 on every ray, rgb
    at 1e-4 on at least 60 of the 64 rays and disp on 56, both 2e-3 on all,
    fine z at 1e-4 on 56 rays and 1e-2 on all (test_full_nerf_plain_matches_jax's
    bounds: the det u in the coarse CDF's near-empty tail bins)."""
    jparams, tparams = ndc_models()
    pop = dict(n_depth_samples=16, sampling_mode="gaussian", distance=0.25)
    jp, tp = ndc_pipelines(**pop)
    K, c2w, _, _ = forward_rays()
    key = jax.random.PRNGKey(0)
    emode = mode.upper()
    want = jengine.render_image(jp, jparams, H, W, jnp.asarray(K), jnp.asarray(c2w), key,
                                mode=jengine.EvalMode[emode])
    noise = jax_eval_noise(key, pop["n_depth_samples"])
    inner = tengine.sample_points_around_mean
    monkeypatch.setattr(tengine, "sample_points_around_mean", lambda *a, **kw: inner(*a, **{**kw, "noise": noise}))
    got = tengine.render_image(tp, tparams, H, W, K, c2w, device="cpu", mode=tengine.EvalMode[emode],
                               generator=torch.Generator().manual_seed(0))
    assert set(got) == set(want)

    def per_ray(name):
        return np.abs(got[name].numpy() - np.asarray(want[name])).reshape(N_RAYS, -1).max(-1)

    if mode == "depth_net":
        for name in got:
            if name == "depth_net_disp_map":  # 1 / (depth / acc): up to 1e10 where acc is near 0
                np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=2e-4)
            else:
                assert per_ray(name).max() <= 1e-4, name
        return
    assert per_ray("max_z_vals").max() <= 1e-4
    for name, n_ok, tol_all in (("depth_net_rgb_map", 60, 2e-3), ("depth_net_disp_map", 56, 2e-3),
                                ("depth_net_z_vals", 56, 1e-2)):
        d = per_ray(name)
        assert (d <= 1e-4).sum() >= n_ok and d.max() <= tol_all, name


TINY_NETS = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, n_layers=3, layer_width=32,
                 sphere_radius=2.0, N_samples=NC, N_importance=NF, N_rand=32, n_depth_samples=8,
                 sampling_mode="gaussian", i_print=1, i_weights=100)


def test_trainer_llff_ndc(tmp_path):
    """tests/test_train.py::test_llff_ndc_e2e on a generated scene: the NDC
    pipeline with near/far 0 and 1 (written into the config by the
    loader), the scene's H/W/focal on it, i_test every llffhold-th view,
    two steps and their eval on the kernels' CPU path."""
    datadir = generate_example_llff_dataset(str(tmp_path / "llff"), H=24, W=32, n_images=9)
    cfg = TrainerConfig(dataset_type="llff", datadir=datadir, basedir=str(tmp_path / "logs"), expname="llff",
                        factor=1, llffhold=4, white_bkgd=False, train_mode="nerf", mlp_impl="cuda",
                        i_testset=2, distance=0.25, **TINY_NETS)
    tr = Trainer(cfg, device="cpu")
    assert np.isfinite(tr.train(N_iters=3)) and tr.global_step == 2
    p = tr.pipeline
    assert p.ndc and (p.near, p.far, cfg.near, cfg.far) == (0.0, 1.0, 0.0, 1.0)
    assert (p.H, p.W, p.focal) == tr.scene.hwf and tr.scene.hwf[:2] == (24, 32)
    np.testing.assert_array_equal(tr.scene.i_test, [0, 4, 8])
    assert os.path.exists(os.path.join(tr.expdir, "testset_000002", "002.png"))


@pytest.mark.parametrize("dataset_type", ["LINEMOD", "deepvoxels"])
def test_trainer_linemod_and_deepvoxels(tmp_path, dataset_type):
    """Two depth-net steps on the kernels' CPU path; near/far from the
    loader (LINEMOD's metadata floored and ceiled, DeepVoxels' camera
    radius +-1), LINEMOD's K from its frames."""
    if dataset_type == "LINEMOD":
        datadir = generate_example_linemod_dataset(str(tmp_path / "lm"), H=16, W=16, n_train=2, n_val=1, n_test=1)
        kw = dict(half_res=False, white_bkgd=True)
    else:
        datadir = generate_example_deepvoxels_dataset(str(tmp_path / "dv"), n_train=2, n_val=1, n_test=1)
        kw = dict(shape="cube", white_bkgd=False)
    cfg = TrainerConfig(dataset_type=dataset_type, datadir=datadir, basedir=str(tmp_path / "logs"), expname="e",
                        testskip=1, mlp_impl="cuda", i_testset=1000, distance=1.0, **kw, **TINY_NETS)
    tr = Trainer(cfg, device="cpu")
    assert np.isfinite(tr.train(N_iters=3)) and tr.global_step == 2 and not tr.pipeline.ndc
    if dataset_type == "LINEMOD":
        assert (cfg.near, cfg.far) == (2.0, 6.0) and tr.scene.K is not None
    else:
        np.testing.assert_allclose((cfg.near, cfg.far), (3.0, 5.0), atol=1e-6)
    assert (tr.pipeline.near, tr.pipeline.far) == (cfg.near, cfg.far)


LLFF_YAML = TINY_YAML.replace("nerf_sampling_tpu.", "nerf_sampling_tpu_torch.").replace(
    'dataset_type: "blender"', 'dataset_type: "llff"\n    factor: 1\n    llffhold: 4\n    n_depth_samples: 8\n'
    '    sampling_mode: "gaussian"\n    distance: 0.25').replace("white_bkgd: True", "white_bkgd: False").replace(
    "i_weights: 1000000", "i_weights: 2")


def test_cli_example_llff(tmp_path, monkeypatch):
    """run.py -d example_llff --mode nerf, then render.py -d example_llff -rt
    from its checkpoint, on the kernels' CPU path (DATASET_DIR holds a
    small copy of the scene)."""
    dataset_dir = tmp_path / "dataset"
    generate_example_llff_dataset(str(dataset_dir / "example_llff"), H=16, W=16, n_images=8)
    for mod in (run, rcli):
        monkeypatch.setattr(mod, "DATASET_DIR", str(dataset_dir))
    cfg_path = tmp_path / "llff.yaml"
    cfg_path.write_text(LLFF_YAML)
    common = ["-c", str(cfg_path), "-m", "tiny_module", "-d", "example_llff", "--mlp_impl", "cuda",
              "--device", "cpu"]
    tr = run.main(common + ["--mode", "nerf", "--n_iters", "2", "-ip", "1", "--basedir", str(tmp_path / "logs")])
    assert tr.pipeline.ndc and tr.global_step == 2 and tr.cfg.expname == "example_llff_nerf"
    rt = rcli.main(common + ["-rt", "--ft_path", os.path.join(tr.expdir, "000002.npz"), "--n_samples", "8",
                             "--distance", "0.25", "--sampling_mode", "gaussian", "--basedir", str(tmp_path / "r")])
    assert rt.pipeline.ndc and len(rt.scene.i_test) == 2
    psnr_txt = open(os.path.join(rt.expdir, "renderonly_test_000000", "psnr.txt")).read()
    assert psnr_txt.count("PSNR") == 3  # two views and their average


class Recorder:
    """Wrappers replaced by recorders that count their calls and call them."""

    TARGETS = {
        "K1": (fused_depth_net, "depth_net_kernel"),
        "K4": (fused_nerf_vjp, "nerf_points_kernel"),
        "K5": (fused_nerf_vjp, "nerf_points_bwd_kernel"),
        "K6/K7": (fused_hier, "render_hier_kernel"),
        "K2": (fused_render, "render_around_depth_kernel"),
        "K3": (fused_render, "render_gaussian_kernel"),
        "K8/K9": (fused_render, "_launch"),
    }

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.TARGETS, 0)
        for name, (mod, attr) in self.TARGETS.items():
            monkeypatch.setattr(mod, attr, self._wrap(name, getattr(mod, attr)))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)

        return call

    def reached(self) -> set:
        return {k for k, v in self.calls.items() if v}


ROUTES = {
    "depth_net_eval": {"K1", "K4"},
    "full_nerf_eval": {"K4"},
    "nerf_max_eval": {"K4"},
    "depth_step": {"K4"},
    "nerf_step": {"K4", "K5"},
    "joint_step": {"K4", "K5"},
}


@pytest.mark.parametrize("route", ROUTES)
def test_cuda_ndc_routing(monkeypatch, rng, route):
    """Under mlp_impl="cuda" and NDC each path reaches its kernels and no
    other (K2, K3, K6/K7, K8/K9 never), and nothing renders on the plain
    path: the plain modules are never called."""
    _, tparams = ndc_models()
    _, tp = ndc_pipelines(n_depth_samples=8, sampling_mode="gaussian", distance=0.25)
    cp = dataclasses.replace(tp, mlp_impl="cuda")
    _, _, ro, rd = forward_rays()
    batch = tuple(torch.from_numpy(x) for x in (ro, rd, rng.random((N_RAYS, 3), dtype=np.float32)))
    rec = Recorder(monkeypatch)
    plain_nerf_calls = []
    for m in (tparams.coarse, tparams.fine):
        m.register_forward_hook(lambda *_: plain_nerf_calls.append(1))
    if route.endswith("_eval"):
        mode = tengine.EvalMode[route[:-5].upper()]
        K, c2w, _, _ = forward_rays()
        tengine.render_image(cp, tparams, H, W, K, c2w, device="cpu", mode=mode,
                             generator=torch.Generator().manual_seed(0))
        assert not plain_nerf_calls
    elif route == "depth_step":
        assert not check_hier_oracle(cp)
        step = make_depth_net_train_step(cp, tparams._replace(depth=None))
        step(init_state(tparams.depth, LR), batch, seed=1)
        assert len(plain_nerf_calls) == 1  # only the depth-point query, in fp32 autograd (it trains the DepthNet)
    elif route == "nerf_step":
        make_nerf_train_step(cp)(init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), LR), batch, seed=1)
        assert not plain_nerf_calls
    else:
        make_joint_train_step(cp)(init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), LR),
                                  init_state(tparams.depth, LR), batch, seed=1)
        assert len(plain_nerf_calls) == 1
    assert rec.reached() == ROUTES[route], rec.calls


@pytest.mark.parametrize("case", ["compare_nerf", "cuda_int8_eval", "cuda_int8_step", "cuda_int8_trainer"])
def test_cuda_ndc_raises_outside_its_route(tmp_path, case):
    """COMPARE_NERF under NDC on the kernels raises naming the envelope
    (the JAX package swaps in its fp32 XLA path); cuda_int8 under NDC
    raises in the eval, the depth step and the Trainer (JAX renders bf16
    under the int8 flag there)."""
    _, tparams = ndc_models()
    _, tp = ndc_pipelines(n_depth_samples=8, sampling_mode="gaussian", distance=0.25)
    K, c2w, _, _ = forward_rays()
    if case == "compare_nerf":
        with pytest.raises(ValueError, match="COMPARE_NERF.*NDC"):
            tengine.render_image(dataclasses.replace(tp, mlp_impl="cuda"), tparams, H, W, K, c2w, device="cpu",
                                 mode=tengine.EvalMode.COMPARE_NERF, generator=torch.Generator().manual_seed(0))
    elif case == "cuda_int8_eval":
        with pytest.raises(ValueError, match="cuda_int8.*NDC"):
            tengine.render_image(dataclasses.replace(tp, mlp_impl="cuda_int8"), tparams, H, W, K, c2w,
                                 device="cpu", generator=torch.Generator().manual_seed(0))
    elif case == "cuda_int8_step":
        with pytest.raises(ValueError, match="cuda_int8.*NDC"):
            make_depth_net_train_step(dataclasses.replace(tp, mlp_impl="cuda_int8"), tparams._replace(depth=None))
    else:
        cfg = TrainerConfig(dataset_type="llff", mlp_impl="cuda_int8", sampling_mode="gaussian")
        with pytest.raises(ValueError, match="cuda_int8.*NDC"):
            Trainer(cfg, device="cpu")
        with pytest.raises(ValueError, match="COMPARE_NERF"):
            Trainer(dataclasses.replace(cfg, mlp_impl="cuda", compare_nerf=True), device="cpu")
