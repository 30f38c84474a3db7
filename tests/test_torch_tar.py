"""The reference-format .tar in the port against the JAX package on CPU.

- The port's export read by JAX's ``import_torch_checkpoint``, and JAX's
  ``export_torch_checkpoint`` read by the port: the same parameters, exactly.
- Reference-named modules (tests/test_torch_interop.py) load the port's
  .tar with strict=True and give the port's forward.
- Adam moments after real steps, bit for bit in both directions: the port's
  live torch Adam through its export into a torch Adam over the reference
  modules, and JAX's optax moments through its export into the port's Adam.
- ``nerf_params_from_keras`` against JAX's.
- The Trainer restores from a .tar in depth_net, nerf and joint mode (and a
  .tar ``depth_net_path``) to the JAX Trainer's start and parameters, and a
  resume after an export (``export_torch_ckpt`` on by default) picks what
  the JAX Trainer picks.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_interop import RefDepthNet, RefNeRF
from test_torch_train import DEPTH_KW, NERF_KW, rays_np, small_models, tiny_scene

from nerf_sampling_tpu.models import DepthNetConfig as JDepthNetConfig
from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig
from nerf_sampling_tpu.models import depth_net_apply, nerf_apply
from nerf_sampling_tpu.train import checkpoint as jckpt
from nerf_sampling_tpu.train import state as jstate
from nerf_sampling_tpu.train.trainer import Trainer as JTrainer
from nerf_sampling_tpu.utils.config import TrainerConfig as JTrainerConfig
from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.train import checkpoint as tckpt
from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
from nerf_sampling_tpu_torch.train.trainer import Trainer
from nerf_sampling_tpu_torch.utils.config import TrainerConfig

LR, DECAY = 1e-3, 2


def port_sds(tparams) -> dict:
    return {"coarse": tparams.coarse.state_dict(), "fine": tparams.fine.state_dict(),
            "depth": tparams.depth.state_dict()}


def assert_trees_equal(got, want):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l) and len(got_l) > 0
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_port_tar_reads_in_jax(tmp_path):
    _, tparams = small_models()
    sds = port_sds(tparams)
    path = str(tmp_path / "000005.tar")
    tckpt.export_torch_checkpoint(path, 5, sds["coarse"], sds["fine"], sds["depth"])
    data = jckpt.import_torch_checkpoint(path)
    assert data["global_step"] == 5
    want = tckpt.params_to_jax(sds)
    for got, name in ((data["nerf_coarse"], "coarse"), (data["nerf_fine"], "fine"), (data["depth"], "depth")):
        assert_trees_equal(got, want[name])


def test_jax_tar_reads_in_port(tmp_path):
    jparams, _ = small_models()
    path = str(tmp_path / "000009.tar")
    jckpt.export_torch_checkpoint(path, 9, jparams.coarse, jparams.fine, jparams.depth)
    data = tckpt.import_torch_checkpoint(path)
    assert data["global_step"] == 9
    want = tckpt.params_from_jax(jax.tree.map(np.asarray, {"coarse": jparams.coarse, "fine": jparams.fine,
                                                            "depth": jparams.depth}))
    for name in ("coarse", "fine", "depth"):
        assert data[name].keys() == want[name].keys()
        for k, v in want[name].items():
            assert data[name][k].dtype == torch.float32 and data[name][k].is_contiguous()
            torch.testing.assert_close(data[name][k], v, rtol=0, atol=0)
    # a NeRF-only .tar: no DepthNet, no fine network
    jckpt.export_torch_checkpoint(path, 9, jparams.coarse)
    data = tckpt.import_torch_checkpoint(path)
    assert data["fine"] is None and data["depth"] is None and data["coarse"] is not None


def test_reference_modules_load_the_port_tar(tmp_path, rng):
    _, tparams = small_models()
    sds = port_sds(tparams)
    path = str(tmp_path / "000001.tar")
    tckpt.export_torch_checkpoint(path, 1, sds["coarse"], sds["fine"], sds["depth"])
    data = torch.load(path, weights_only=True)
    x = torch.from_numpy(rng.standard_normal((23, 90)).astype(np.float32))
    for key, model in (("network_fn_state_dict", tparams.coarse), ("network_fine_state_dict", tparams.fine)):
        ref = RefNeRF(NERF_KW["D"], NERF_KW["W"], 63, 27, skips=[4])
        ref.load_state_dict(data[key], strict=True)
        with torch.no_grad():
            torch.testing.assert_close(ref(x), model(x), rtol=1e-6, atol=1e-6)
    ref = RefDepthNet(DEPTH_KW["hidden_sizes"], DEPTH_KW["cat_hidden_sizes"])
    ref.load_state_dict(data["depth_network"], strict=True)
    ro, rd = (torch.from_numpy(a) for a in rays_np(17, rng))
    with torch.no_grad():
        torch.testing.assert_close(ref(ro, rd), tparams.depth(ro, rd), rtol=1e-6, atol=1e-6)


def _port_steps(tparams, rng, n: int = 3):
    """n Adam steps of the NeRF pair and of the DepthNet on an MSE of their
    outputs: (nerf TrainState, depth TrainState)."""
    nerf = init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), LR, DECAY)
    depth = init_state(tparams.depth, LR)
    x = torch.from_numpy(rng.standard_normal((32, 90)).astype(np.float32))
    ro, rd = (torch.from_numpy(a) for a in rays_np(32, rng))
    for _ in range(n):
        for st, loss in ((nerf, lambda: sum((m(x) ** 2).mean() for m in nerf.model.values())),
                         (depth, lambda: ((depth.model(ro, rd) - 3.0) ** 2).mean())):
            st.optimizer.zero_grad()
            loss().backward()
            st.optimizer.step()
    return nerf, depth


def test_port_adam_moments_load_into_reference_adam(tmp_path, rng):
    """The port's live moments, exported in the reference's parameter order,
    load with torch.optim.Adam.load_state_dict into Adams over reference
    modules (the NeRFs' grad_vars: coarse then fine) bit for bit."""
    _, tparams = small_models()
    nerf, depth = _port_steps(tparams, rng)
    sds = port_sds(tparams)
    path = str(tmp_path / "000003.tar")
    tckpt.export_torch_checkpoint(path, 3, sds["coarse"], sds["fine"], sds["depth"], lrate=LR,
                                  depth_net_lr=LR, lrate_decay=DECAY, nerf_opt=(nerf.model, nerf.optimizer),
                                  depth_opt=(depth.model, depth.optimizer))
    data = torch.load(path, weights_only=False)
    assert data["optimizer_state_dict"]["param_groups"][0]["lr"] == LR * 0.1 ** (3 / (DECAY * 1000))
    refs = [RefNeRF(NERF_KW["D"], NERF_KW["W"], 63, 27, skips=[4]) for _ in range(2)]
    ref_opt = torch.optim.Adam(list(refs[0].parameters()) + list(refs[1].parameters()), lr=LR)
    ref_opt.load_state_dict(data["optimizer_state_dict"])
    ref_names = [f"{net}.{n}" for net, m in zip(("coarse", "fine"), refs) for n, _ in m.named_parameters()]
    ref_params = [p for m in refs for p in m.parameters()]
    port = dict(nerf.model.named_parameters())
    dref = RefDepthNet(DEPTH_KW["hidden_sizes"], DEPTH_KW["cat_hidden_sizes"])
    dref_opt = torch.optim.Adam(dref.parameters(), lr=LR)
    dref_opt.load_state_dict(data["sampling_optimizer_state_dict"])
    dport = dict(depth.model.named_parameters())
    pairs = [(ref_opt, p, nerf.optimizer.state[port[n]]) for n, p in zip(ref_names, ref_params)]
    pairs += [(dref_opt, p, depth.optimizer.state[dport[n]]) for n, p in dref.named_parameters()]
    assert len(pairs) == len(port) + len(dport)
    for opt, p, want in pairs:
        got = opt.state[p]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        assert float(got["step"]) == 3


def test_jax_adam_moments_load_into_the_port(tmp_path, rng):
    """JAX's optax moments after real updates, through its export, into the
    port's torch Adams (``adam_state_from_torch``) bit for bit."""
    jparams, _ = small_models()
    nerf_opt, depth_opt = jstate.make_nerf_optimizer(LR, DECAY), jstate.make_depth_optimizer(LR)
    nerf_p, depth_p = jparams._replace(depth=None), jparams.depth
    nerf_s, depth_s = nerf_opt.init(nerf_p), depth_opt.init(depth_p)
    x = jnp.asarray(rng.standard_normal((32, 90)).astype(np.float32))
    ro, rd = (jnp.asarray(a) for a in rays_np(32, rng))
    ncfg, dcfg = JNeRFConfig(**NERF_KW), JDepthNetConfig(**DEPTH_KW)

    def nerf_loss(p):
        return jnp.mean(nerf_apply(p.coarse, ncfg, x) ** 2) + jnp.mean(nerf_apply(p.fine, ncfg, x) ** 2)

    def depth_loss(p):
        return jnp.mean((depth_net_apply(p, dcfg, ro, rd) - 3.0) ** 2)

    for _ in range(3):
        upd, nerf_s = nerf_opt.update(jax.grad(nerf_loss)(nerf_p), nerf_s, nerf_p)
        nerf_p = optax.apply_updates(nerf_p, upd)
        upd, depth_s = depth_opt.update(jax.grad(depth_loss)(depth_p), depth_s, depth_p)
        depth_p = optax.apply_updates(depth_p, upd)
    path = str(tmp_path / "000003.tar")
    jckpt.export_torch_checkpoint(path, 3, nerf_p.coarse, nerf_p.fine, depth_p, lrate=LR, depth_net_lr=LR,
                                  nerf_opt_state=nerf_s, depth_opt_state=depth_s, lrate_decay=DECAY)
    data = tckpt.import_torch_checkpoint(path)
    raw = torch.load(path, weights_only=False)
    coarse, fine, depth = NeRF(NeRFConfig(**NERF_KW)), NeRF(NeRFConfig(**NERF_KW)), DepthNet(DepthNetConfig(**DEPTH_KW))
    for m, k in ((coarse, "coarse"), (fine, "fine"), (depth, "depth")):
        m.load_state_dict(data[k], strict=True)
    nerf = init_nerf_state(nerf_modules(coarse, fine), LR, DECAY)
    dstate = init_state(depth, LR)
    tckpt.adam_state_from_torch(raw["optimizer_state_dict"], nerf.model, nerf.optimizer,
                                tckpt.nerf_state_order(data["coarse"], data["fine"]))
    tckpt.adam_state_from_torch(raw["sampling_optimizer_state_dict"], depth, dstate.optimizer,
                                tckpt.depth_param_order(data["depth"]))
    _, mu, nu = jckpt._find_adam_moments(nerf_s)
    _, dmu, dnu = jckpt._find_adam_moments(depth_s)
    for k, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        got = {n: nerf.optimizer.state[p][k] for n, p in nerf.model.named_parameters()}
        for net in ("coarse", "fine"):
            sub = {n.split(".", 1)[1]: v for n, v in got.items() if n.startswith(net + ".")}
            assert_trees_equal(tckpt.nerf_params_to_jax(sub), getattr(tree, net))
    for k, tree in (("exp_avg", dmu), ("exp_avg_sq", dnu)):
        got = {n: dstate.optimizer.state[p][k] for n, p in depth.named_parameters()}
        assert_trees_equal(tckpt.depth_net_params_to_jax(got), tree)
    assert {float(st["step"]) for st in nerf.optimizer.state.values()} == {3.0}


def test_nerf_params_from_keras_matches_jax(rng):
    D, W = 3, 16
    shapes = [(63, W), (W,), (W, W), (W,), (W, W), (W,)]  # pts_linears (no skip below layer 4)
    shapes += [(W, W), (W,), (W + 27, W // 2), (W // 2,), (W // 2, 3), (3,), (W, 1), (1,)]
    weights = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sd = tckpt.nerf_params_from_keras(weights, D=D)
    want = tckpt.nerf_state_dict(jckpt.nerf_params_from_keras(weights, D=D))
    assert sd.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    NeRF(NeRFConfig(D=D, W=W, input_ch=63, input_ch_views=27, use_viewdirs=True)).load_state_dict(sd, strict=True)


def trainer_cfgs(tmp_path, mode, **kw):
    """The same tiny config in both packages (plain path)."""
    base = dict(datadir=tiny_scene(tmp_path), basedir=str(tmp_path / "logs"), expname=mode, train_mode=mode,
                netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, n_layers=3, layer_width=32,
                sphere_radius=2.0, N_samples=8, N_importance=16, N_rand=64, i_testset=100, i_weights=2,
                i_print=1, testskip=1, lrate=LR, lrate_decay=DECAY, seed=3)
    base.update(kw)
    return TrainerConfig(**base, mlp_impl="plain"), JTrainerConfig(**base, mlp_impl="xla")


def setup_both(tcfg, jcfg):
    tr, jtr = Trainer(tcfg, device="cpu"), JTrainer(jcfg)
    for t in (tr, jtr):
        t.scene = t.load_data()
        t.setup_models()
    return tr, jtr


def assert_same_models(tr, jtr):
    p = tr.params
    got = tckpt.params_to_jax({k: getattr(p, k).state_dict() for k in ("coarse", "fine", "depth")
                               if getattr(p, k) is not None})
    assert set(got) == {k for k in ("coarse", "fine", "depth") if getattr(jtr.params, k) is not None}
    for k, v in got.items():
        assert_trees_equal(v, getattr(jtr.params, k))


@pytest.mark.parametrize("mode,depth_tar", [("depth_net", False), ("depth_net", True), ("nerf", False),
                                            ("joint", False)])
def test_trainer_restores_a_tar_as_jax_does(tmp_path, mode, depth_tar):
    """ft_path a .tar of both NeRFs and a DepthNet at step 7 (and, with
    depth_tar, depth_net_path a .tar of another DepthNet at step 11)."""
    jparams, _ = small_models()
    ft = str(tmp_path / "200000.tar")
    jckpt.export_torch_checkpoint(ft, 7, jparams.coarse, jparams.fine, jparams.depth)
    kw = {"ft_path": ft}
    if depth_tar:
        kw["depth_net_path"] = str(tmp_path / "depth.tar")
        other = jax.tree.map(lambda w: w * 0.5, jparams.depth)
        jckpt.export_torch_checkpoint(kw["depth_net_path"], 11, jparams.coarse, None, other)
    tr, jtr = setup_both(*trainer_cfgs(tmp_path, mode, **kw))
    assert tr.start == jtr.start == {"depth_net": 11 if depth_tar else 0, "nerf": 7, "joint": 7}[mode]
    assert_same_models(tr, jtr)
    assert tr._resume_tree is None  # a .tar restores no optimizer state


@pytest.mark.parametrize("mode", ["nerf", "depth_net"])
def test_resume_after_an_export(tmp_path, mode):
    """With the default export, step 2 writes {2:06d}.npz (or depth_...)
    and 000002.tar; the .tar reads in JAX to the checkpoint's parameters,
    and a resume (no ft_path: the scan also sees the .tar) restores what
    the JAX Trainer restores from the same directory, the Adam moments
    from the .npz."""
    tcfg, jcfg = trainer_cfgs(tmp_path, mode)
    assert tcfg.export_torch_ckpt and jcfg.export_torch_ckpt
    first = Trainer(tcfg, device="cpu")
    first.train(N_iters=3)
    exp = first.expdir
    tar = jckpt.import_torch_checkpoint(os.path.join(exp, "000002.tar"))
    npz, _ = tckpt.load_checkpoint(os.path.join(exp, ("depth_" if mode == "depth_net" else "") + "000002.npz"))
    assert tar["global_step"] == 2
    for name, key in (("coarse", "nerf_coarse"), ("fine", "nerf_fine"), ("depth", "depth")):
        if name in npz["params"]:
            assert_trees_equal(tar[key], npz["params"][name])
    raw = torch.load(os.path.join(exp, "000002.tar"), weights_only=False)
    live = {"nerf": raw["optimizer_state_dict"], "depth_net": raw["sampling_optimizer_state_dict"]}[mode]
    fresh = {"nerf": raw["sampling_optimizer_state_dict"], "depth_net": raw["optimizer_state_dict"]}[mode]
    assert len(live["state"]) == len(live["param_groups"][0]["params"]) > 0 and fresh["state"] == {}
    tr, jtr = setup_both(dataclasses.replace(tcfg), dataclasses.replace(jcfg))
    assert tr.start == jtr.start == 2
    assert_same_models(tr, jtr)
    assert tr._resume_tree is not None  # the moments come from the .npz
    tr.train(N_iters=4)
    assert tr.global_step == 3
