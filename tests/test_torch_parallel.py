"""The port's data parallelism (nerf_sampling_tpu_torch/parallel/) against the JAX package's on CPU.

- The mesh helpers on one process (the world size and rank stood in for):
  the hybrid mesh's shape, and rank r's rows being the rows JAX's
  ``ray_sharding`` puts on the hybrid mesh's device r (DCN-major);
  ``groups`` must divide the world; one process gets one row;
  ``ray_rows`` refuses a batch that does not split (JAX
  tests/test_parallel.py:352-370).
- K6 and K3 keyed by the global ray index (``ray_base``): through their
  wrappers on CPU tensors (the plain versions with the host Philox twin) a
  windowed run equals the slice of the whole run; against a mocked library
  the launches hand ``ray_base`` to ``nst_render_hier`` and
  ``nst_render_gaussian``.
- One sharded depth, nerf and joint step on 2 gloo ranks (the worker in
  tests/test_torch_multiproc.py, which imports no JAX) against JAX's
  ``make_sharded_*_train_step`` on the 8-device CPU mesh (tests/conftest.py),
  the draws made from JAX's key for the whole batch and sliced by each rank,
  at the tolerances of the one-device parity tests of those steps
  (tests/test_torch_train.py, tests/test_torch_nerf_train.py); and the
  2-rank render of a ragged image against JAX's ``render_image_sharded``
  (DEPTH_NET, uniform) at 2e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_multiproc import jax_parity_worker, run_ranks
from test_torch_nerf_train import assert_one_adam_step, draws_from_key, tree_rel
from test_torch_train import assert_tree_close, jax_step_draws, small_models, stash_grads
from test_torch_wgmma_tf32 import mocked_library
from test_torch_wgmma_pack import small_nerf

from nerf_sampling_tpu.parallel import (
    make_hybrid_mesh as jax_hybrid_mesh,
    make_mesh as jax_make_mesh,
    make_sharded_depth_train_step as jax_sharded_depth,
    make_sharded_joint_train_step as jax_sharded_joint,
    make_sharded_nerf_train_step as jax_sharded_nerf,
    ray_sharding,
    shard_ray_batch as jax_shard,
)
from nerf_sampling_tpu.parallel.render import render_image_sharded as jax_render_sharded
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu.train import state as jstate
from nerf_sampling_tpu_torch.kernels import fused_hier as k6
from nerf_sampling_tpu_torch.kernels import fused_render as k3
from nerf_sampling_tpu_torch.kernels import philox
from nerf_sampling_tpu_torch.parallel import mesh as pmesh
from nerf_sampling_tpu_torch.train import checkpoint as tckpt

N = 64  # the global batch: 8 JAX devices, 2 ranks
LR, DECAY = 1e-3, 1


def as_world(monkeypatch, world: int, rank: int) -> None:
    monkeypatch.setattr(pmesh, "_world", lambda: (world, rank, rank))


def test_hybrid_mesh_rows_are_jaxs_dcn_major_shards(monkeypatch):
    """8 ranks as 2 groups of 4: shape (2, 4) over ("dcn", "rays"), and rank
    r holds the rows JAX's ray sharding puts on device r of its
    make_hybrid_mesh(groups=2) (row-major over [dcn, rays])."""
    jmesh = jax_hybrid_mesh(jax.devices()[:8], groups=2)
    placed = jax.device_put(np.arange(N), ray_sharding(jmesh))
    rows_of = {s.device: s.index[0] for s in placed.addressable_shards}
    for r, dev in enumerate(jmesh.devices.flat):
        as_world(monkeypatch, 8, r)
        mesh = pmesh.make_hybrid_mesh(groups=2)
        assert mesh.shape == (2, 4) and mesh.axis_names == ("dcn", "rays")
        assert mesh.shape == tuple(jmesh.shape.values())
        lo, hi = pmesh.ray_rows(mesh, N)
        assert (lo, hi) == (rows_of[dev].start, rows_of[dev].stop)
        assert np.array_equal(pmesh.shard_ray_batch(mesh, np.arange(N)), np.arange(N)[lo:hi])


def test_mesh_layout_errors(monkeypatch):
    """groups must divide the world; hosts of unequal size need groups=; a
    batch must split into the world's shards; a 1-D mesh spans the world."""
    as_world(monkeypatch, 8, 0)
    with pytest.raises(ValueError, match="divisible"):
        pmesh.make_hybrid_mesh(groups=3)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="groups="):
        pmesh.make_hybrid_mesh()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert pmesh.make_hybrid_mesh().shape == (2, 4)
    with pytest.raises(ValueError, match="not divisible into 8 shards"):
        pmesh.ray_rows(pmesh.make_mesh(), 60)
    with pytest.raises(ValueError, match="a mesh of 4 ranks in a world of 8"):
        pmesh.make_mesh(4)


def test_single_process_gets_one_row(monkeypatch):
    """Without a process group: one rank, one row, the whole batch."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_hybrid_mesh()
    assert mesh.shape == (1, 1) and dict(jax_hybrid_mesh(jax.devices()[:1]).shape) == {"dcn": 1, "rays": 1}
    assert pmesh.make_mesh().shape == (1,) and pmesh.ray_rows(mesh, 7) == (0, 7)


# ---------------------------------------------------------------- ray_base

def rays(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    rd[:, 2] = -1.0
    return torch.from_numpy(ro), torch.from_numpy(rd)


def test_philox_twins_window_by_ray0():
    """The host twins keyed by the global ray index: rows lo.. of a launch
    at ray0=lo are rows lo.. of the launch at ray0=0."""
    assert torch.equal(philox.hier_draws(9, 20, 24, ray0=44), philox.hier_draws(9, 64, 24)[44:])
    assert torch.equal(philox.gaussian_noise(9, 20, 15, ray0=44), philox.gaussian_noise(9, 64, 15)[44:])


def test_k6_window_equals_slice_of_full_launch():
    """K6 (its plain version on CPU tensors) on rows 16:40 of 40 with
    ray_base=16 equals rows 16:40 of K6 on all 40 rows, bit for bit."""
    coarse, fine = small_nerf(D=2, skips=(4,), seed=3), small_nerf(D=2, skips=(4,), seed=4)
    packed = k6.pack_hier(coarse, fine)
    ro, rd = rays(40)
    kw = dict(n_coarse=8, n_importance=16, seed=11)
    full = k6.fused_render_hier(packed, coarse.cfg, fine.cfg, ro, rd, **kw)
    part = k6.fused_render_hier(packed, coarse.cfg, fine.cfg, ro[16:], rd[16:], ray_base=16, **kw)
    unkeyed = k6.fused_render_hier(packed, coarse.cfg, fine.cfg, ro[16:], rd[16:], **kw)
    for k in full:
        assert torch.equal(part[k], full[k][16:]), k
    assert not torch.equal(unkeyed["max_z"], full["max_z"][16:])


def test_k3_window_equals_slice_of_full_launch():
    """K3 (its plain version on CPU tensors) likewise, at ray_base=16."""
    model = small_nerf(D=2, skips=(4,), seed=3)
    packed = k3.pack_nerf(model)
    ro, rd = rays(40)
    depth = torch.full((40,), 3.5)
    kw = dict(n_samples=16, std=0.5, seed=5)
    full = k3.fused_render_gaussian(packed, model.cfg, ro, rd, depth, **kw)
    part = k3.fused_render_gaussian(packed, model.cfg, ro[16:], rd[16:], depth[16:], ray_base=16, **kw)
    unkeyed = k3.fused_render_gaussian(packed, model.cfg, ro[16:], rd[16:], depth[16:], **kw)
    for k in full:
        assert torch.equal(part[k], full[k][16:]), k
    assert not torch.equal(unkeyed["depth_map"], full["depth_map"][16:])


@pytest.mark.parametrize("ray_base", [0, 80_000])
def test_launches_hand_ray_base_to_the_kernels(monkeypatch, ray_base):
    """Against a mocked library: K6's launch hands ray_base to
    nst_render_hier after the seed, K3's to nst_render_gaussian after its
    seed (0 when it is not given)."""
    coarse, fine = small_nerf(D=2, skips=(4,), seed=3), small_nerf(D=2, skips=(4,), seed=4)
    ro, rd = torch.zeros(8, 3, device="meta"), torch.zeros(8, 3, device="meta")
    extra = {"ray_base": ray_base} if ray_base else {}
    seen = mocked_library(monkeypatch, k6, "nst_render_hier")
    k6.render_hier_kernel(k6.pack_hier(coarse, fine), coarse.cfg, fine.cfg, ro, rd, n_coarse=8, n_importance=16,
                          seed=7, **extra)
    # (..., seed, ray_base, det, fp32, plan_c, plan_f, stream)
    assert seen["args"][-7:-4] == (7, ray_base, 0)
    seen = mocked_library(monkeypatch, k3, "nst_render_gaussian")
    k3.render_gaussian_kernel(k3.pack_nerf(fine), fine.cfg, ro, rd, torch.zeros(8, device="meta"), n_samples=16,
                              std=0.5, seed=7, **extra)
    # (..., std, seed, ray_base, white_bkgd, plan, stream)
    assert seen["args"][-5:-3] == (7, ray_base)


# ---------------------------------------------------------------- against JAX's sharded steps and render

H_IMG, W_IMG, FOCAL = 5, 7, 10.0  # 35 rays over 8 devices and over 2 ranks
# keys whose u fall in no near-empty bin of the coarse CDF on this batch
# (test_torch_nerf_train.draws_from_key says why that matters)
STEP_KEYS = {"depth": 10, "nerf": 103, "joint": 30}
PIPES = {"depth": dict(bg_depth_loss_weight=1.0), "nerf": {}, "joint": dict(bg_depth_loss_weight=0.5)}
RENDER_PIPE = dict(sampling_mode="uniform", n_depth_samples=16, distance=1.0)


def jax_pipe(**kw):
    from test_torch_multiproc import DEPTH_KW, NC, NERF_KW, NF

    from nerf_sampling_tpu.models import DepthNetConfig, NeRFConfig

    return jengine.Pipeline(nerf=NeRFConfig(**NERF_KW), fine=NeRFConfig(**NERF_KW),
                            depth=DepthNetConfig(**DEPTH_KW), mlp_impl="xla", N_samples=NC, N_importance=NF, **kw)


def camera():
    K = np.array([[FOCAL, 0, W_IMG / 2], [0, FOCAL, H_IMG / 2], [0, 0, 1.0]], np.float32)
    c2w = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
    return K, c2w


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """One step of each mode and the render, on JAX's 8-device mesh and on
    2 gloo ranks of the port, from the same models, batch and draws."""
    jparams, tparams = small_models()
    fresh = lambda: jax.tree.map(lambda x: jnp.array(x, copy=True), jparams)  # the steps donate their states
    rng = np.random.default_rng(0)
    ro, rd = (x.numpy() for x in rays(N, 1))
    target = rng.random((N, 3), dtype=np.float32)
    mesh = jax_make_mesh(jax.devices()[:8])
    want, draws = {}, {}
    for mode, kw in PIPES.items():
        jp = jax_pipe(**kw)
        key = jax.random.PRNGKey(STEP_KEYS[mode])
        batch = jax_shard(mesh, (jengine.make_ray_batch(jp, jnp.asarray(ro), jnp.asarray(rd)), jnp.asarray(target)))
        if mode == "depth":
            opt = optax.chain(stash_grads(), jstate.make_depth_optimizer(LR))
            state, m = jax_sharded_depth(jp, opt, mesh)(fresh()._replace(depth=None),
                                                        jstate.init_state(fresh().depth, opt), batch, key)
            d = jax_step_draws(key, N)
            want[mode] = (m, state.opt_state[0], state.params)
        elif mode == "nerf":
            opt = optax.chain(stash_grads(), jstate.make_nerf_optimizer(LR, DECAY))
            state, m = jax_sharded_nerf(jp, opt, mesh)(jstate.init_state(fresh()._replace(depth=None), opt), batch, key)
            d = draws_from_key(key, N)
            want[mode] = (m, state.opt_state[0], state.params)
        else:
            nopt = optax.chain(stash_grads(), jstate.make_nerf_optimizer(LR, DECAY))
            dopt = optax.chain(stash_grads(), jstate.make_depth_optimizer(LR))
            ns, ds, m = jax_sharded_joint(jp, nopt, dopt, mesh)(
                jstate.init_state(fresh()._replace(depth=None), nopt), jstate.init_state(fresh().depth, dopt),
                batch, key)
            d = draws_from_key(jax.random.split(key)[0], N)
            want[mode] = (m, ns.opt_state[0]._replace(depth=ds.opt_state[0]), ns.params._replace(depth=ds.params))
        draws[mode] = (d.t_rand, d.u)
    K, c2w = camera()
    want["render"] = jax_render_sharded(jax_pipe(**RENDER_PIPE), fresh(), H_IMG, W_IMG, K, c2w,
                                        jax.random.PRNGKey(0), mesh, mode=jengine.EvalMode.DEPTH_NET)
    tmp = tmp_path_factory.mktemp("parity")
    spec = {"models": {k: getattr(tparams, k).state_dict() for k in ("coarse", "fine", "depth")},
            "batch": tuple(torch.from_numpy(x) for x in (ro, rd, target)), "draws": draws, "pipes": PIPES,
            "lr": LR, "decay": DECAY, "camera": (H_IMG, W_IMG, K, c2w), "render_pipe": RENDER_PIPE}
    torch.save(spec, tmp / "inputs.pt")
    return run_ranks(jax_parity_worker, 2, tmp, str(tmp / "inputs.pt")), want


def as_jax(tree: dict, net: str):
    if net == "depth":
        return tckpt.depth_net_params_to_jax(tree)
    return tckpt.nerf_params_to_jax(tree)


@pytest.mark.parametrize("mode", list(PIPES))
def test_sharded_step_matches_jax(parity, mode):
    """The port's 2-rank step against JAX's sharded step: the metrics at
    1e-5 on both ranks; the grads of the depth step at 1e-5 of their
    largest and its params at 1e-5 where the grad is well above its
    tolerance (one Adam step elsewhere); the nerf and joint steps' grads at
    1e-3 of each net's largest and their params to one Adam step (the
    one-device parity tests' tolerances and reasons)."""
    ranks, want = parity
    jm, jgrads, jparams = want[mode]
    for rec in ranks:
        got = rec[mode]
        assert set(got["metrics"]) == set(jm)
        for k, v in got["metrics"].items():
            np.testing.assert_allclose(v, float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    got = ranks[0][mode]
    for net, grads in got["grads"].items():
        jg, jp = getattr(jgrads, net) if mode != "depth" else jgrads, \
            getattr(jparams, net) if mode != "depth" else jparams
        if mode == "depth":
            assert_tree_close(as_jax(grads, net), jg, 1e-5, 1e-5)
        else:
            assert tree_rel(as_jax(grads, net), jg) <= 1e-3, net
        assert_one_adam_step(as_jax(got["params"][net], net), jp, LR)
    for net in got["params"]:
        for a, b in zip(got["params"][net].values(), ranks[1][mode]["params"][net].values()):
            assert torch.equal(a, b)


def test_sharded_render_matches_jax(parity):
    """The ragged 5x7 image (35 rays, padded to 36 over 2 ranks) against
    JAX's render_image_sharded over 8 devices, DEPTH_NET uniform, 2e-5."""
    ranks, want = parity
    for rec in ranks:
        for k, got in rec["render"].items():
            assert got.shape == want["render"][k].shape == (H_IMG, W_IMG, *got.shape[2:])
            np.testing.assert_allclose(got, np.asarray(want["render"][k]), rtol=2e-5, atol=2e-5, err_msg=k)
