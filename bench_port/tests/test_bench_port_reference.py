"""The plain reference against the program's plain (fp32) path, at small widths on the CPU.

The reference is written from the published models and imports nothing of
the program; these tests hold it to the program's plain path on random
weights and on the committed checkpoint, part by part and for whole train
steps.
"""

import copy
import os

import numpy as np
import pytest
import torch

from bench_port.drivers import port
from bench_port.reference import model as M
from bench_port.reference import philox
from bench_port.reference import train as R
from bench_port.reference.weights import read_params
from nerf_sampling_tpu_torch.core.compositing import raw2outputs
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.core.sampling import sample_points_around_mean
from nerf_sampling_tpu_torch.kernels import fused_hier
from nerf_sampling_tpu_torch.kernels import philox as port_philox
from nerf_sampling_tpu_torch.render.engine import NeRFParams, make_ray_batch, render_rays_eval, EvalMode
from nerf_sampling_tpu_torch.train.checkpoint import read_npz_tree
from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
from nerf_sampling_tpu_torch.train.steps import StepDraws, make_depth_net_train_step, make_nerf_train_step

from bench_port.harness import ROOT, load_json

CKPT = os.path.join(ROOT, load_json("configs", "lego_nerf")["checkpoint"])
SMALL = {
    "nerf": {"D": 8, "W": 32, "skips": [4], "multires": 10, "multires_views": 4},
    "nerf_fine": {"D": 8, "W": 32, "skips": [4], "multires": 10, "multires_views": 4},
    "depth_net": {"n_layers": 3, "layer_width": 16, "multires": 10, "sphere_radius": 2.0},
    "near": 2.0, "far": 6.0, "white_bkgd": True, "N_samples": 8, "N_importance": 12, "perturb": 1.0,
    "N_rand": 16, "depth_net_lr": 1e-4, "bg_depth_loss_weight": 0.0, "lrate": 5e-4, "lrate_decay": 500,
    "matmul_precision": "highest",
}


def linear(g, n_in, n_out, scale=None):
    s = scale if scale is not None else 1.0 / np.sqrt(n_in)
    return {"weight": (g.standard_normal((n_in, n_out)) * s).astype(np.float32),
            "bias": (g.standard_normal(n_out) * 0.1).astype(np.float32)}


def random_nerf(g, net):
    W, pts, views = net["W"], 3 * (1 + 2 * net["multires"]), 3 * (1 + 2 * net["multires_views"])
    layers = [linear(g, pts, W)] + [linear(g, W + (pts if i - 1 in net["skips"] else 0), W) for i in range(1, net["D"])]
    out = {"pts_linears": layers, "feature_linear": linear(g, W, W), "alpha_linear": linear(g, W, 1),
           "views_linears": [linear(g, W + views, W // 2)], "rgb_linear": linear(g, W // 2, 3)}
    out["alpha_linear"]["bias"] += 1.0  # density on most points
    return out


def random_depth_net(g, dn):
    L, w, f = dn["n_layers"], dn["layer_width"], 1 + 2 * dn["multires"]
    eo, ei = 3 * f, 6 * f

    def tower(emb, skip):
        return [linear(g, 2 * emb, w)] + [linear(g, w + skip, w) for _ in range(L - 1)]

    return {"origin_layers": tower(eo, eo), "direction_layers": tower(eo, eo), "intersection_layers": tower(ei, ei),
            "cat_layers": [linear(g, 3 * w + 2 * eo + ei, w)] + [linear(g, w, w) for _ in range(L - 1)],
            "to_depth": linear(g, w, 1)}


def raw_small(seed=0):
    g = np.random.default_rng(seed)
    return {"coarse": random_nerf(g, SMALL["nerf"]), "fine": random_nerf(g, SMALL["nerf_fine"]),
            "depth": random_depth_net(g, SMALL["depth_net"])}


def camera_rays(n, seed=0):
    """Rays from orbit cameras at radius 4 toward the unit ball (all inside the r=2 sphere's view)."""
    g = np.random.default_rng(seed)
    o = g.standard_normal((n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + g.uniform(-0.6, 0.6, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)


def test_weights_reader_matches_the_programs():
    mine = read_params(CKPT)
    theirs, _ = read_npz_tree(CKPT)
    for net in ("coarse", "fine", "depth"):
        a, b = M.leaves(mine[net]), M.leaves(theirs["params"][net])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k], np.float32))


def test_encoding():
    x = torch.randn(7, 3, dtype=torch.float32)
    torch.testing.assert_close(M.encode(x, 10), positional_encoding(x, 10), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_nerf_and_depth_net_against_the_program_modules(seed):
    raw = raw_small(seed)
    pipe = port.pipeline(SMALL, "plain")
    mods = port.modules(pipe, raw, "cpu", with_depth=True)
    o, d = camera_rays(64, seed)
    net = M.to_torch(raw, "cpu")
    with M.strict_fp32(), torch.no_grad():
        emb = torch.cat([M.encode(o, 10), M.encode(d, 4)], -1)
        torch.testing.assert_close(M.nerf(net["fine"], M.encode(o, 10), M.encode(d, 4)), mods.fine(emb),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(M.depth_net(net["depth"], o, d, multires=10, radius=2.0, near=2.0, far=6.0),
                                   mods.depth(o, d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_samples", [16, 1])
def test_composite_and_uniform_population(n_samples):
    g = torch.Generator().manual_seed(3)
    raw = torch.randn(32, n_samples, 4, generator=g)
    z = torch.sort(2.0 + 4.0 * torch.rand(32, n_samples, generator=g), -1).values
    o, d = camera_rays(32)
    want = raw2outputs(raw, z, d, 0.0, True)
    got = M.composite(raw, z, d)
    for k, w in (("rgb", want.rgb_map), ("depth", want.depth_map), ("acc", want.acc_map), ("weights", want.weights)):
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6)
    mean = 2.5 + 3.0 * torch.rand(32, 1, generator=g)
    _, z_port = sample_points_around_mean(o, d, mean, n_samples=64, mode="uniform", std=1.0)
    torch.testing.assert_close(M.uniform_population(mean, 64, 1.0, 2.0, 6.0), z_port, rtol=0, atol=1e-6)


def test_philox_copy_is_the_kernels_stream():
    for seed, ray0 in ((0, 0), (2**31 - 5, 1000), (3_000_000_123, 7)):
        np.testing.assert_array_equal(philox.hier_draws(seed, 16, 192, ray0),
                                      port_philox.hier_draws(seed, 16, 192, ray0).numpy())


@pytest.mark.parametrize("det", [True, False])
def test_hierarchical_against_the_programs_plain_path(det):
    raw = raw_small(4)
    pipe = port.pipeline(SMALL, "plain")
    mods = port.modules(pipe, raw, "cpu", with_depth=False)
    o, d = camera_rays(48, 4)
    draws = None if det else torch.from_numpy(philox.hier_draws(99, 48, 20))
    net = M.to_torch(raw, "cpu")
    with M.strict_fp32(), torch.no_grad():
        got = M.hierarchical(net["coarse"], net["fine"], o, d, n_coarse=8, n_fine=12, near=2.0, far=6.0,
                             multires=10, multires_views=4, t_rand=None if det else draws[:, :8],
                             u=None if det else draws[:, 8:])
        packed = fused_hier.pack_hier(mods.coarse, mods.fine, torch.float32)
        want = fused_hier.render_hier_plain(packed, mods.coarse.cfg, mods.fine.cfg, o, d, n_coarse=8, n_importance=12,
                                            t_rand=None if det else draws[:, :8], u=None if det else draws[:, 8:],
                                            dtype=torch.float32)
    torch.testing.assert_close(got["rgb"], want["rgb_map"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["acc"], want["acc_map"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["max_z"], want["max_z"], rtol=1e-4, atol=1e-4)


def test_depth_net_render_against_the_programs_plain_path():
    raw = raw_small(5)
    pipe = port.pipeline(SMALL, "plain", n_depth_samples=16, sampling_mode="uniform", distance=1.0)
    mods = port.modules(pipe, raw, "cpu", with_depth=True)
    o, d = camera_rays(40, 5)
    net = M.to_torch(raw, "cpu")
    with M.strict_fp32(), torch.no_grad():
        want = render_rays_eval(pipe, mods, make_ray_batch(pipe, o, d), EvalMode.DEPTH_NET)
        z = M.uniform_population(M.depth_net(net["depth"], o, d, multires=10, radius=2.0, near=2.0, far=6.0),
                                 16, 1.0, 2.0, 6.0)
        got = M.composite(M.query(net["fine"], o[:, None] + d[:, None] * z[..., None], d, 10, 4), z, d)
    torch.testing.assert_close(got["rgb"], want["depth_net_rgb_map"], rtol=1e-4, atol=1e-5)


def batches(n_steps, n, seed):
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        o, d = camera_rays(n, int(g.integers(1 << 30)))
        out.append((o, d, torch.tensor(g.random((n, 3)), dtype=torch.float32)))
    return out


def test_depth_step_against_the_programs_plain_step():
    raw = raw_small(6)
    cfg_r = {**SMALL, "multires": 10, "multires_views": 4, "depth_multires": 10, "sphere_radius": 2.0}
    pipe = port.pipeline(SMALL, "plain")
    mods = port.modules(pipe, raw, "cpu", with_depth=True)
    state = init_state(mods.depth, 1e-4)
    step = make_depth_net_train_step(pipe, NeRFParams(mods.coarse, mods.fine))
    frozen = M.to_torch({"coarse": raw["coarse"], "fine": raw["fine"]}, "cpu")
    trained = M.to_torch(raw["depth"], "cpu", requires_grad=True)
    adam = R.Adam(M.leaves(trained), 1e-4)
    names = port.param_names("depth")
    for i, batch in enumerate(batches(3, 16, 6)):
        draws = torch.from_numpy(philox.hier_draws(i, 16, 20))
        _, m = step(state, batch, 0, StepDraws(draws[:, :8], draws[:, 8:]))
        with M.strict_fp32():
            parts, grads = R.depth_step(frozen, trained, batch, draws, cfg_r)
        assert parts["img_loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
        assert parts["depth_loss"] == pytest.approx(float(m["depth_net_loss"]), rel=1e-4, abs=1e-7)
        for k, p in state.model.named_parameters():
            g_port = state.optimizer.state[p]["exp_avg"] / 0.1 if i == 0 else None
            if g_port is not None:
                torch.testing.assert_close(grads[names[k]].reshape(-1), g_port.T.reshape(-1) if p.dim() == 2
                                           else g_port.reshape(-1), rtol=1e-3, atol=1e-6)
        adam.update(grads)
    for k, p in state.model.named_parameters():
        ref = adam.params[names[k]]
        torch.testing.assert_close(ref.T if p.dim() == 2 else ref, p.detach(), rtol=1e-4, atol=1e-6)


def test_nerf_step_against_the_programs_plain_step():
    raw = raw_small(7)
    cfg_r = {**SMALL, "multires": 10, "multires_views": 4}
    pipe = port.pipeline(SMALL, "plain")
    mods = port.modules(pipe, raw, "cpu", with_depth=False)
    state = init_nerf_state(nerf_modules(mods.coarse, mods.fine), 5e-4, 500)
    step = make_nerf_train_step(pipe)
    trained = M.to_torch({"coarse": raw["coarse"], "fine": raw["fine"]}, "cpu", requires_grad=True)
    adam = R.Adam(M.leaves(trained), R.nerf_lr(5e-4, 500))
    names = port.param_names("nerf")
    start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    ref_start = {k: p.detach().clone() for k, p in adam.params.items()}
    for i, batch in enumerate(batches(3, 16, 7)):
        g = torch.Generator().manual_seed(i)
        t_rand, u = torch.rand(16, 8, generator=g), torch.rand(16, 12, generator=g)
        _, m = step(state, batch, 0, StepDraws(t_rand, u))
        with M.strict_fp32():
            parts, grads = R.nerf_step(trained, batch, t_rand, u, cfg_r)
        assert parts["img_loss"] + parts["img_loss0"] == pytest.approx(float(m["loss"]), rel=1e-4)
        if i == 0:  # a fine sample may fall in the next bin on a last-bit difference of the CDF: compare norms
            for k, p in state.model.named_parameters():
                g_port = state.optimizer.state[p]["exp_avg"] / 0.1
                assert float(g_port.norm()) == pytest.approx(float(grads[names[k]].norm()), rel=1e-2, abs=1e-8)
        adam.update(grads)
    # Adam moves a leaf by about lr times the sign of each gradient, so elements whose
    # gradient is near zero may move either way: their norms agree, not their bits
    for k, p in state.model.named_parameters():
        change = float((adam.params[names[k]].detach() - ref_start[names[k]]).norm())
        assert float((p.detach() - start[k]).norm()) == pytest.approx(change, rel=2e-2, abs=1e-7)


def test_adam_against_torch():
    g = torch.Generator().manual_seed(8)
    p0 = torch.randn(20, generator=g)
    p_ref, p_torch = p0.clone(), p0.clone().requires_grad_(True)
    adam = R.Adam({"p": p_ref}, R.nerf_lr(5e-4, 1))
    opt = torch.optim.Adam([p_torch], lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
    for t in range(5):
        grad = torch.randn(20, generator=g)
        for group in opt.param_groups:
            group["lr"] = 5e-4 * 0.1 ** (t / 1000)
        p_torch.grad = grad.clone()
        opt.step()
        adam.update({"p": grad})
    torch.testing.assert_close(p_ref, p_torch.detach(), rtol=1e-6, atol=1e-7)


def test_reference_steps_follow_the_program_on_the_checkpoint_nerfs():
    """The NeRF step on the committed checkpoint's full-width NeRFs: one step, a few rays."""
    raw = read_params(CKPT)
    cfg = {**SMALL, "nerf": {"D": 8, "W": 256, "skips": [4], "multires": 10, "multires_views": 4}}
    cfg["nerf_fine"] = copy.deepcopy(cfg["nerf"])
    pipe = port.pipeline(cfg, "plain")
    mods = port.modules(pipe, raw, "cpu", with_depth=False)
    state = init_nerf_state(nerf_modules(mods.coarse, mods.fine), 5e-4, 500)
    batch = batches(1, 8, 9)[0]
    g = torch.Generator().manual_seed(0)
    t_rand, u = torch.rand(8, 8, generator=g), torch.rand(8, 12, generator=g)
    _, m = make_nerf_train_step(pipe)(state, batch, 0, StepDraws(t_rand, u))
    with M.strict_fp32():
        parts, _ = R.nerf_step(M.to_torch({"coarse": raw["coarse"], "fine": raw["fine"]}, "cpu", requires_grad=True),
                               batch, t_rand, u, {**cfg, "multires": 10, "multires_views": 4})
    assert parts["img_loss"] + parts["img_loss0"] == pytest.approx(float(m["loss"]), rel=1e-4)
