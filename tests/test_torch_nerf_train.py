"""The port's NeRF pretraining and joint training against the JAX package on CPU.

- K4's plain version (``nerf_points_plain``) against the JAX Pallas kernel
  ``fused_nerf_apply`` in interpret mode, fp32 and bf16, on the nets of
  tests/test_nerf_vjp.py (8x32 with skips (4,), 2x32 without).
- K5's plain version (``nerf_points_bwd_plain``): param and input grads
  against ``jax.grad`` of the Pallas ``fused_nerf_train_apply`` (interpret),
  fp32 and bf16; want_dx off keeps the param grads to the bit.
- ``fused_nerf_train_apply`` on CPU tensors (the plain bf16 versions)
  against fp32 autograd of the ``NeRF`` module.
- Two nerf steps and two joint steps (with and without a warmup that ends
  between them) against JAX ``make_nerf_train_step`` and
  ``make_joint_train_step`` (XLA path), the draws derived from the JAX key:
  losses, gradients and one Adam step; the decayed-lr Adam against optax
  on the same gradients; the "cuda" steps on CPU tensors against the plain
  ones on the committed checkpoint.
- FULL_NERF on the plain path against the JAX XLA render, and K7's CPU
  wrapper against the JAX det kernel.
- Nerf and joint ``.npz`` checkpoints both ways, exact resume, the Trainer
  and the CLI end to end in both modes, and the raise paths.

Each test states its tolerance. The CUDA kernels run only on the card:
``chip_smoke.py`` holds them to these plain versions there.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import (
    DEPTH_KW,
    N,
    NC,
    NERF_KW,
    NF,
    rays_np,
    small_models,
    stash_grads,
    tiny_scene,
)

from nerf_sampling_tpu.core.rays import get_rays as jget_rays
from nerf_sampling_tpu.kernels.fused_hier import fused_render_hier as jax_fused_hier
from nerf_sampling_tpu.kernels.fused_nerf import fused_nerf_apply as jax_fused_nerf
from nerf_sampling_tpu.kernels.fused_nerf_vjp import fused_nerf_train_apply as jax_train_apply
from nerf_sampling_tpu.models import DepthNetConfig as JDepthNetConfig
from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig
from nerf_sampling_tpu.models import nerf_init
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu.train import checkpoint as jckpt
from nerf_sampling_tpu.train import state as jstate
from nerf_sampling_tpu.train.steps import make_joint_train_step as jax_joint_step
from nerf_sampling_tpu.train.steps import make_nerf_train_step as jax_nerf_step
from nerf_sampling_tpu_torch.experiments import run
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_hier as k67
from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
from nerf_sampling_tpu_torch.kernels import fused_nerf_vjp as k5
from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf
from nerf_sampling_tpu_torch.models import DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.train import checkpoint as tckpt
from nerf_sampling_tpu_torch.train.state import (
    adam_count,
    apply_update,
    init_nerf_state,
    init_state,
    nerf_lr_schedule,
    nerf_modules,
)
from nerf_sampling_tpu_torch.train.steps import StepDraws, make_joint_train_step, make_nerf_train_step
from nerf_sampling_tpu_torch.train.trainer import Trainer
from nerf_sampling_tpu_torch.utils.config import TrainerConfig

VJP_CFGS = {
    "noskip": dict(D=2, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(), use_viewdirs=True),
    "skip4": dict(D=8, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True),
}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LR, DECAY = 1e-3, 1  # lrate_decay 1: the lr falls 0.23% a step, so a wrong count shows


def nerf_pair(name, seed=0):
    """The same NeRF in both packages (nerf_init, as tests/test_nerf_vjp.py)."""
    params = nerf_init(jax.random.PRNGKey(seed), JNeRFConfig(**VJP_CFGS[name]))
    model = NeRF(NeRFConfig(**VJP_CFGS[name]))
    model.load_state_dict(tckpt.params_from_jax({"coarse": jax.tree.map(np.asarray, params)})["coarse"])
    return params, model


def point_inputs(rng, n=96, s=2):
    pts = rng.uniform(-1.5, 1.5, (n, s, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return pts, vd


def grads_as_jax(model, grads) -> dict:
    """Grads in ``model.parameters()`` order -> the JAX NeRF pytree layout."""
    return tckpt.nerf_params_to_jax({name: g for (name, _), g in zip(model.named_parameters(), grads)})


def max_rel(got, want) -> float:
    """Largest |got - want| over the tree, relative to each leaf's largest |want|."""
    worst = 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        worst = max(worst, float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-3))
    return worst


def tree_rel(got, want) -> float:
    """Largest |got - want| over the tree, relative to the tree's largest
    |want| (tests/test_torch_train.py's gradient tolerance)."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    scale = max(float(np.abs(np.asarray(b)).max()) for b in wl)
    return max(float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max()) for a, b in zip(gl, wl)) / scale


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", VJP_CFGS)
def test_nerf_points_plain_matches_pallas(rng, name, dt):
    """Raw outputs at 1e-5 (fp32) and 2e-3 (bf16: a flipped rounding of a
    bf16 activation; measured 5.5e-4) absolute, outputs of order 0.5."""
    jdt, tdt = DTYPES[dt]
    params, model = nerf_pair(name)
    pts, vd = point_inputs(rng)
    want = jax_fused_nerf(params, JNeRFConfig(**VJP_CFGS[name]), jnp.asarray(pts), jnp.asarray(vd)[:, None, :],
                          dtype=jdt, interpret=True)
    got = k4.nerf_points_plain(pack_nerf(model, tdt), model.cfg, torch.from_numpy(pts.reshape(-1, 3)),
                               torch.from_numpy(vd), dtype=tdt)
    np.testing.assert_allclose(got.numpy().reshape(pts.shape[:2] + (4,)), np.asarray(want), rtol=0,
                               atol=1e-5 if dt == "fp32" else 2e-3)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", VJP_CFGS)
def test_nerf_points_bwd_plain_matches_pallas_grads(rng, name, dt):
    """Param and input grads of sum(raw * w) against jax.grad of the Pallas
    custom VJP: 1e-4 (fp32) and 2e-2 (bf16: flipped d_z16 roundings;
    measured 4.2e-3) of each leaf's largest grad; input grads 1e-4 / 1e-3."""
    jdt, tdt = DTYPES[dt]
    params, model = nerf_pair(name)
    pts, vd = point_inputs(rng)
    wmat = rng.standard_normal(pts.shape[:2] + (4,)).astype(np.float32)
    jcfg = JNeRFConfig(**VJP_CFGS[name])

    def loss(p, x):
        return jnp.sum(jax_train_apply(p, jcfg, x, jnp.asarray(vd)[:, None, :], dtype=jdt, interpret=True) * wmat)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(pts))
    d, dpts, ddirs = k5.nerf_points_bwd_plain(
        pack_nerf(model, tdt), model.cfg, torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(vd),
        torch.from_numpy(wmat.reshape(-1, 4)), want_dx=True, dtype=tdt)
    assert max_rel(grads_as_jax(model, k5.grads_to_params(model, d)), gp) <= (1e-4 if dt == "fp32" else 2e-2)
    gx = np.asarray(gx)
    np.testing.assert_allclose(dpts.numpy().reshape(gx.shape), gx, rtol=0,
                               atol=(1e-4 if dt == "fp32" else 1e-3) * np.abs(gx).max())
    assert ddirs.shape == (vd.shape[0], 3) and bool(torch.isfinite(ddirs).all())


def test_want_dx_keeps_param_grads_and_input_grads_false_gives_zero(rng):
    """want_dx off gives the same param grads, bit for bit (the JAX
    property, tests/test_nerf_vjp.py:92-113), and fused_nerf_train_apply
    with input_grads=False zero input grads."""
    _, model = nerf_pair("skip4")
    pts, vd = point_inputs(rng)
    packed = pack_nerf(model, torch.bfloat16)
    args = (packed, model.cfg, torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(vd),
            torch.from_numpy(rng.standard_normal((pts.shape[0] * pts.shape[1], 4)).astype(np.float32)))
    on, dpts, _ = k5.nerf_points_bwd_plain(*args, want_dx=True)
    off, none, _ = k5.nerf_points_bwd_plain(*args, want_dx=False)
    assert none is None and float(dpts.abs().max()) > 0
    for a, b in zip(k5.grads_to_params(model, on), k5.grads_to_params(model, off)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = torch.from_numpy(pts).requires_grad_(True)
    k5.fused_nerf_train_apply(model, model.cfg, x, torch.from_numpy(vd)[:, None, :],
                              input_grads=False).sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) == 0.0


def test_fused_nerf_train_apply_matches_module_autograd(rng):
    """K4/K5 on CPU tensors (their plain bf16 versions, no launch) against
    fp32 autograd of the NeRF module: raw at 2e-2 absolute; gradient cosine
    of at least 0.999 over the whole net and for the points, 0.99 per
    parameter (the bf16 first layer is the noisiest)."""
    _, model = nerf_pair("skip4", seed=2)
    ref = NeRF(model.cfg)
    ref.load_state_dict(model.state_dict())
    pts, vd = point_inputs(rng)
    w = torch.from_numpy(rng.standard_normal(pts.shape[:2] + (4,)).astype(np.float32))
    x1 = torch.from_numpy(pts).requires_grad_(True)
    before = build.launches.copy()
    raw = k5.fused_nerf_train_apply(model, model.cfg, x1, torch.from_numpy(vd)[:, None, :])
    (raw * w).sum().backward()
    assert build.launches == before
    x2 = torch.from_numpy(pts).requires_grad_(True)
    pipe = tengine.Pipeline(nerf=model.cfg)
    want = tengine.query_nerf(pipe, ref, x2, torch.from_numpy(vd))
    (want * w).sum().backward()
    np.testing.assert_allclose(raw.detach().numpy(), want.detach().numpy(), rtol=0, atol=2e-2)
    cos = torch.nn.functional.cosine_similarity
    for (name, a), b in zip(model.named_parameters(), ref.parameters()):
        assert float(cos(a.grad.flatten(), b.grad.flatten(), dim=0)) >= 0.99, name
    flat = [torch.cat([q.grad.flatten() for q in m.parameters()]) for m in (model, ref)]
    assert float(cos(*flat, dim=0)) >= 0.999
    assert float(cos(x1.grad.flatten(), x2.grad.flatten(), dim=0)) >= 0.999


def pipelines(**kw):
    kw = dict(N_samples=NC, N_importance=NF, **kw)
    jp = jengine.Pipeline(nerf=JNeRFConfig(**NERF_KW), fine=JNeRFConfig(**NERF_KW),
                          depth=JDepthNetConfig(**DEPTH_KW), mlp_impl="xla", **kw)
    tp = tengine.Pipeline(nerf=NeRFConfig(**NERF_KW), fine=NeRFConfig(**NERF_KW),
                          depth=DepthNetConfig(**DEPTH_KW), mlp_impl="plain", **kw)
    return jp, tp


def draws_from_key(key, n) -> StepDraws:
    """The draws sample_as_in_nerf takes from its key: split(., 4) -> uniform.

    The step tests' keys are ones whose u fall in no bin of the coarse CDF
    with a mass near 1e-5: there the inverse CDF multiplies the packages'
    last-bit differences in the CDF (their sums round in another order) by
    bin width / bin mass, and one ray's fine sample moves by up to 1e-3."""
    k_strat, _, k_pdf, _ = jax.random.split(key, 4)
    return StepDraws(torch.from_numpy(np.array(jax.random.uniform(k_strat, (n, NC)))),
                     torch.from_numpy(np.array(jax.random.uniform(k_pdf, (n, NF)))))


def batch_pair(jp, rng):
    ro, rd = rays_np(N, rng)
    target = rng.random((N, 3), dtype=np.float32)
    rays = jengine.make_ray_batch(jp, jnp.asarray(ro), jnp.asarray(rd))
    return (rays, jnp.asarray(target)), tuple(torch.from_numpy(x) for x in (ro, rd, target))


def net_tree(modules, net, attr=None) -> dict:
    """One net of ``nerf_modules`` (its params, or their .grad) in the JAX layout."""
    return tckpt.nerf_params_to_jax({n[len(net) + 1:]: (p if attr is None else getattr(p, attr))
                                     for n, p in modules.named_parameters() if n.startswith(net + ".")})


def sync_from_jax(jparams, coarse_fine=None, depth=None) -> None:
    """Copy JAX params into the port's modules in place (the optimizers keep
    their state): each step is then compared from one set of weights. An
    element whose gradient is near zero can take an Adam step of +lr in one
    package and -lr in the other, which would otherwise carry into the
    next step's loss."""
    sds = tckpt.params_from_jax(jax.tree.map(np.asarray, jparams._asdict()))
    with torch.no_grad():
        if coarse_fine is not None:
            for net in ("coarse", "fine"):
                coarse_fine[net].load_state_dict(sds[net])
        if depth is not None:
            depth.load_state_dict(sds["depth"])


def assert_one_adam_step(got, want, lr):
    """Params after one Adam step from the same weights: within 2 lr of
    each other, element for element (an element whose gradient is near zero
    can step +lr in one package and -lr in the other). The update rule
    itself is held exactly by test_nerf_adam_matches_optax."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= 2 * lr


def test_nerf_lr_schedule_matches_optax():
    """The schedule of the optimizer's count, bit for bit optax's fp32."""
    want = jstate.nerf_lr_schedule(5e-4, 250)
    got = nerf_lr_schedule(5e-4, 250)
    for count in (0, 1, 7, 1000, 123456, 250000):
        assert np.float32(got(count)) == np.float32(want(count)), count


def test_nerf_adam_matches_optax(rng):
    """The NeRF's Adam with the decayed lr against optax.adam with
    nerf_lr_schedule, fed the same gradients for 3 updates: params at 1e-6
    relative and 1e-7 absolute (1e-4 of the lr: the fp32 rounding of the
    update), and the same count."""
    jparams, tparams = small_models()
    mods = nerf_modules(tparams.coarse, tparams.fine)
    state = init_nerf_state(mods, LR, DECAY)
    opt = jstate.make_nerf_optimizer(LR, DECAY)
    jp = jparams._replace(depth=None)
    js = opt.init(jp)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), jp)
        updates, js = opt.update(grads, js, jp)
        jp = optax.apply_updates(jp, updates)
        sds = tckpt.params_from_jax(jax.tree.map(np.asarray, {"coarse": grads.coarse, "fine": grads.fine}))
        for net in ("coarse", "fine"):
            for name, q in mods[net].named_parameters():
                q.grad = sds[net][name].clone()
        apply_update(state)
    for net in ("coarse", "fine"):
        for g, w in zip(jax.tree.leaves(net_tree(mods, net)), jax.tree.leaves(getattr(jp, net))):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert adam_count(state.optimizer) == int(js[1].count) == 3


def test_nerf_step_matches_jax(rng):
    """2 steps, each from the JAX step's weights: metrics at 1e-5, coarse
    and fine grads at 1e-3 of each net's largest (XLA rounds the CDF sums of
    the jitted step in its own order, and where a u falls in a near-empty
    bin the fine sample still moves, see ``draws_from_key``; measured up
    to 3.2e-4), params as ``assert_one_adam_step``."""
    jparams, tparams = small_models()
    jp, tp = pipelines()
    opt = optax.chain(stash_grads(), jstate.make_nerf_optimizer(LR, DECAY))
    js = jstate.init_state(jparams._replace(depth=None), opt)
    jstep = jax_nerf_step(jp, opt)
    ts = init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), LR, DECAY)
    tstep = make_nerf_train_step(tp)
    for it in range(2):
        jbatch, tbatch = batch_pair(jp, rng)
        key = jax.random.PRNGKey(100 + it)
        js, jm = jstep(js, jbatch, key)
        ts, tm = tstep(ts, tbatch, seed=0, draws=draws_from_key(key, N))
        assert set(tm) == set(jm) == {"loss", "img_loss", "psnr", "psnr0"}
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        for net in ("coarse", "fine"):
            jg = getattr(js.opt_state[0], net)
            assert tree_rel(net_tree(ts.model, net, "grad"), jg) <= 1e-3
            assert_one_adam_step(net_tree(ts.model, net), getattr(js.params, net), LR)
        sync_from_jax(js.params, ts.model)
    assert ts.step == 2 and adam_count(ts.optimizer) == int(js.opt_state[1][1].count) == 2


@pytest.mark.parametrize("warmup", [0, 1])
def test_joint_step_matches_jax(rng, warmup):
    """2 joint steps, each from the JAX step's weights; with warmup 1 the
    first leaves the DepthNet (params and Adam state) exactly as it was and
    the second trains it. Metrics at 1e-5, grads at 1e-3 of each net's
    largest (as ``test_nerf_step_matches_jax``), params as
    ``assert_one_adam_step``."""
    jparams, tparams = small_models()
    jp, tp = pipelines(joint_depth_warmup=warmup, bg_depth_loss_weight=0.5)
    nopt = optax.chain(stash_grads(), jstate.make_nerf_optimizer(LR, DECAY))
    dopt = optax.chain(stash_grads(), jstate.make_depth_optimizer(LR))
    jn = jstate.init_state(jparams._replace(depth=None), nopt)
    jd = jstate.init_state(jparams.depth, dopt)
    jstep = jax_joint_step(jp, nopt, dopt)
    tn = init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), LR, DECAY)
    td = init_state(tparams.depth, LR)
    tstep = make_joint_train_step(tp)
    d0 = {k: v.clone() for k, v in tparams.depth.state_dict().items()}
    for it in range(2):
        jbatch, tbatch = batch_pair(jp, rng)
        key = jax.random.PRNGKey(30 + it)
        jn, jd, jm = jstep(jn, jd, jbatch, key)
        k_nerf, _ = jax.random.split(key)
        tn, td, tm = tstep(tn, td, tbatch, seed=0, draws=draws_from_key(k_nerf, N))
        assert set(tm) == set(jm)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        live = it >= warmup
        assert float(tm.get("depth_live", 1.0)) == float(live)
        for net in ("coarse", "fine"):
            jg = getattr(jn.opt_state[0], net)
            assert tree_rel(net_tree(tn.model, net, "grad"), jg) <= 1e-3
            assert_one_adam_step(net_tree(tn.model, net), getattr(jn.params, net), LR)
        got_d = tckpt.depth_net_params_to_jax(td.model.state_dict())
        if not live:  # frozen: the same bits, no Adam state, grads never taken
            for k, v in td.model.state_dict().items():
                torch.testing.assert_close(v, d0[k], rtol=0, atol=0)
            assert adam_count(td.optimizer) == 0 == int(jd.opt_state[1][0].count)
            assert all(p.grad is None for p in td.model.parameters())
        else:
            jg = jd.opt_state[0]
            assert tree_rel(tckpt.depth_net_params_to_jax({n: p.grad for n, p in td.model.named_parameters()}),
                            jg) <= 1e-3
            assert_one_adam_step(got_d, jd.params, LR)
        sync_from_jax(jn.params._replace(depth=jd.params), tn.model, td.model)
    assert (tn.step, td.step) == (2, 2) and adam_count(td.optimizer) == 2 - warmup


def committed_pair_and_rays(rng, n=64):
    """The committed checkpoint's NeRFs and DepthNet (8x256 and 10x256, the
    production widths) and n rays of test view 0 of the example scene."""
    from test_torch_train import committed_params, production_pipe

    from nerf_sampling_tpu_torch.core.rays import get_rays_np
    from nerf_sampling_tpu_torch.data.example import _orbit_poses

    pipe = production_pipe("plain")
    params = committed_params(pipe)
    H = W = 400
    focal = 0.5 * 800 / np.tan(0.5 * 0.6911112070083618) / 2.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    ro, rd = get_rays_np(H, W, K, _orbit_poses(4, 2)[0][:3, :4])
    idx = rng.choice(H * W, n, replace=False)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(a.reshape(-1, 3)[idx], np.float32)) for a in (ro, rd))
    return pipe, params, (*rays, torch.from_numpy(rng.random((n, 3), dtype=np.float32)))


def test_cuda_steps_on_cpu_agree_with_plain(rng):
    """The "cuda" nerf and joint steps on CPU tensors (K4/K5 as their plain
    bf16 versions) from one state, batch and draws as the plain steps, on
    the committed checkpoint: img_loss within 1e-2 relative, gradient
    cosine per net at least 0.995 (the gates of chip_smoke.py's [step]
    phase, which holds the kernels to the same). The committed coarse NeRF
    renders no density on some batches; its gradient is then zero on both
    paths."""
    pipe, _, batch = committed_pair_and_rays(rng)
    n = batch[0].shape[0]
    draws = StepDraws(torch.rand(n, 64, generator=torch.Generator().manual_seed(1)),
                      torch.rand(n, 128, generator=torch.Generator().manual_seed(2)))
    res = {}
    for impl in ("plain", "cuda"):
        p = dataclasses.replace(pipe, mlp_impl=impl)
        params = committed_pair_and_rays(np.random.default_rng(0))[1]
        n_state = init_nerf_state(nerf_modules(params.coarse, params.fine))
        _, m = make_nerf_train_step(p)(n_state, batch, 0, draws)
        params = committed_pair_and_rays(np.random.default_rng(0))[1]
        jn_state = init_nerf_state(nerf_modules(params.coarse, params.fine))
        jd_state = init_state(params.depth)
        _, _, jm = make_joint_train_step(p)(jn_state, jd_state, batch, 0, draws)
        grads = {f"{tag}{net}": torch.cat([q.grad.flatten() for name, q in st.model.named_parameters()
                                           if name.startswith(net + ".")])
                 for tag, st in (("nerf ", n_state), ("joint ", jn_state)) for net in ("coarse", "fine")}
        grads["joint depth"] = torch.cat([q.grad.flatten() for q in jd_state.model.parameters()])
        res[impl] = (m, jm, grads)
    (mk, jmk, gk), (mp, jmp, gp) = res["cuda"], res["plain"]
    for a, b in ((mk, mp), (jmk, jmp)):
        assert abs(float(a["img_loss"]) - float(b["img_loss"])) <= 1e-2 * float(b["img_loss"])
    for net in gk:
        if float(gp[net].norm()) == 0.0:
            assert float(gk[net].norm()) == 0.0, net
        else:
            assert float(torch.nn.functional.cosine_similarity(gk[net], gp[net], dim=0)) >= 0.995, net


def camera(H, W):
    focal = 0.8 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    return K, c2w


def test_full_nerf_plain_matches_jax():
    """FULL_NERF on the plain path against the JAX XLA render of an 8x8
    view. The det u spread over [0, 1] always puts fine samples in the
    empty tail of the coarse CDF, bins of mass near 1e-5, where the inverse
    CDF multiplies the packages' last-bit differences in the CDF (their
    sums round in another order) by bin width / bin mass. So: max_z at
    1e-4 on every ray; rgb at 1e-4 on at least 60 of the 64 rays and disp
    on at least 56, both 2e-3 on all (measured: 2 and 5 rays above 1e-4,
    max 1.0e-3); fine z at 1e-4 on at least 56 rays and 1e-2 on all
    (measured: 7 rays, 5.3e-3)."""
    jparams, tparams = small_models()
    jp, tp = pipelines()
    K, c2w = camera(8, 8)
    want = jengine.render_image(jp, jparams, 8, 8, jnp.asarray(K), jnp.asarray(c2w), jax.random.PRNGKey(0),
                                mode=jengine.EvalMode.FULL_NERF)
    got = tengine.render_image(tp, tparams, 8, 8, K, c2w, device="cpu", mode=tengine.EvalMode.FULL_NERF)
    assert set(got) == set(want)

    def per_ray(name):
        return np.abs(got[name].numpy() - np.asarray(want[name])).reshape(64, -1).max(-1)

    assert per_ray("max_z_vals").max() <= 1e-4
    for name, n_ok, tol_all in (("depth_net_rgb_map", 60, 2e-3), ("depth_net_disp_map", 56, 2e-3),
                                ("depth_net_z_vals", 56, 1e-2)):
        d = per_ray(name)
        assert (d <= 1e-4).sum() >= n_ok and d.max() <= tol_all, name


def test_k7_wrapper_matches_pallas_det():
    """K7's CPU wrapper (the det plain version at bf16, no launch) against
    the JAX det kernel at bf16 in interpret mode, and the "cuda" FULL_NERF
    render against the plain one: mean |rgb| difference 2e-3 and max 5e-2
    (on this random field a flipped bf16 rounding can move a fine sample,
    and with it a ray; measured max 2.8e-2)."""
    jparams, tparams = small_models()
    jp, tp = pipelines()
    K, c2w = camera(8, 8)
    ro, rd = (np.asarray(a).reshape(-1, 3) for a in jget_rays(8, 8, jnp.asarray(K), jnp.asarray(c2w)))
    want = jax_fused_hier(jparams.coarse, JNeRFConfig(**NERF_KW), jparams.fine, JNeRFConfig(**NERF_KW),
                          jnp.asarray(ro), jnp.asarray(rd), n_coarse=NC, n_importance=NF,
                          dtype=jnp.bfloat16, interpret=True)
    before = build.launches.copy()
    got = k67.render_hier_kernel(k67.pack_hier(tparams.coarse, tparams.fine), tparams.coarse.cfg,
                                 tparams.fine.cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                 n_coarse=NC, n_importance=NF)
    assert build.launches == before
    for name in ("rgb_map", "acc_map"):
        d = np.abs(got[name].numpy() - np.asarray(want[name]))
        assert d.max() <= 5e-2 and d.mean() <= 2e-3, name
    kernel = tengine.render_image(dataclasses.replace(tp, mlp_impl="cuda"), tparams, 8, 8, K, c2w,
                                  device="cpu", mode=tengine.EvalMode.FULL_NERF)
    plain = tengine.render_image(tp, tparams, 8, 8, K, c2w, device="cpu", mode=tengine.EvalMode.FULL_NERF)
    d = (kernel["depth_net_rgb_map"] - plain["depth_net_rgb_map"]).abs()
    assert float(d.max()) <= 5e-2 and float(d.mean()) <= 2e-3
    torch.testing.assert_close(kernel["depth_net_rgb_map"].reshape(-1, 3), got["rgb_map"], rtol=0, atol=0)


def nerf_trainer_cfg(tmp_path, mode, **kw):
    base = dict(
        datadir=tiny_scene(tmp_path), basedir=str(tmp_path / "logs"), expname=mode, train_mode=mode,
        netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, n_layers=3, layer_width=32,
        sphere_radius=2.0, N_samples=NC, N_importance=NF, N_rand=64, n_depth_samples=16,
        sampling_mode="gaussian", distance=1.0, mlp_impl="cuda", i_testset=2, i_weights=2,
        i_print=1, keep_best=True, testskip=1, lrate=LR, lrate_decay=DECAY, seed=3,
    )
    base.update(kw)
    return TrainerConfig(**base)


def test_trainer_nerf_mode_end_to_end_and_resume(tmp_path):
    """Nerf mode from scratch on the kernel path (CPU tensors): FULL_NERF
    evals through K7, {i:06d}.npz with the NeRFs' Adam, the JAX log line
    (no depth loss), the NeRF packs made anew for the eval; then a resume
    from step 2 with the Adam count."""
    cfg = nerf_trainer_cfg(tmp_path, "nerf")
    tr = Trainer(cfg, device="cpu")
    tr.train(N_iters=3)
    exp = tr.expdir
    assert tr.pipeline.depth is None and tr.params.depth is None
    for f in ("000002.npz", os.path.join("best", "000002.npz"), os.path.join("testset_000002", "000.png")):
        assert os.path.exists(os.path.join(exp, f)), f
    lines = open(os.path.join(exp, "psnr.txt")).read().splitlines()
    assert [ln.split()[1] for ln in lines] == ["1", "2"] and "Depth Net Loss" not in lines[0]
    assert tr.eval_params.kernels.hier is not None
    fresh = k67.pack_hier(tr.params.coarse, tr.params.fine)
    torch.testing.assert_close(tr.eval_params.kernels.hier["fine"]["w0"], fresh["fine"]["w0"], rtol=0, atol=0)
    tree, step = tckpt.load_checkpoint(os.path.join(exp, "000002.npz"))
    assert step == 2 and int(tree["opt_state"][0]["count"]) == int(tree["opt_state"][1]["count"]) == 2
    tr2 = Trainer(cfg, device="cpu")
    tr2.train(N_iters=5)
    assert tr2.start == 2 and tr2.global_step == 4 and adam_count(tr2._nerf_state.optimizer) == 4


@pytest.mark.parametrize("mode", ["nerf", "joint"])
def test_resume_is_exact(tmp_path, rng, mode):
    """2 steps, a checkpoint written as the Trainer writes it, fresh modules
    and optimizers restored from it, 2 more steps == 4 steps straight, bit
    for bit (the decayed lr follows the restored count; joint mode with a
    warmup that ends after the checkpoint, and the DepthNet's Adam)."""
    _, tp = pipelines(joint_depth_warmup=3)
    batches = [batch_pair(pipelines()[0], rng)[1] for _ in range(4)]
    step = (make_joint_train_step if mode == "joint" else make_nerf_train_step)(tp)

    def fresh():
        _, tparams = small_models()
        return (init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), LR, DECAY),
                init_state(tparams.depth, LR))

    def run_steps(n_state, d_state, n):
        for _ in range(n):
            b, seed = batches[n_state.step], 100 + n_state.step
            if mode == "joint":
                n_state, d_state, _ = step(n_state, d_state, b, seed)
            else:
                n_state, _ = step(n_state, b, seed)
        return n_state, d_state

    straight = run_steps(*fresh(), 4)
    n_half, d_half = run_steps(*fresh(), 2)
    path = str(tmp_path / "000002.npz")
    sds = {net: n_half.model[net].state_dict() for net in ("coarse", "fine")}
    tree = {"opt_state": tckpt.nerf_adam_state_to_jax(n_half.model, n_half.optimizer)}
    if mode == "joint":
        sds["depth"] = d_half.model.state_dict()
        tree["depth_opt_state"] = tckpt.adam_state_to_jax(d_half.model, d_half.optimizer)
    tree["params"] = tckpt.JaxNeRFParams(**tckpt.params_to_jax(sds))
    tckpt.save_checkpoint(path, tree, 2)
    tree, n = tckpt.load_checkpoint(path)
    n_res, d_res = fresh()
    n_res.step = d_res.step = n
    loaded = tckpt.params_from_jax(tree["params"])
    for net in ("coarse", "fine"):
        n_res.model[net].load_state_dict(loaded[net])
    assert tckpt.nerf_adam_state_from_jax(tree["opt_state"], n_res.model, n_res.optimizer) == 2
    if mode == "joint":
        d_res.model.load_state_dict(loaded["depth"])
        assert tckpt.adam_state_from_jax(tree["depth_opt_state"], d_res.model, d_res.optimizer) == 0
    resumed = run_steps(n_res, d_res, 2)
    for got, want in zip(resumed, straight):
        for k, v in want.model.state_dict().items():
            torch.testing.assert_close(got.model.state_dict()[k], v, rtol=0, atol=0)


def test_trainer_joint_mode_warmup_and_checkpoint(tmp_path):
    """Joint mode from a NeRF-only checkpoint on the kernel path (CPU
    tensors): the DepthNet bit for bit unchanged through the warmup,
    depth_live 0 then 1, DEPTH_NET evals of fresh packs, and a joint
    {i:06d}.npz carrying the DepthNet and both Adam states."""
    jparams, _ = small_models()
    ft = str(tmp_path / "nerf.npz")
    jckpt.save_checkpoint(ft, {"params": jparams._replace(depth=None)}, 0)
    cfg = nerf_trainer_cfg(tmp_path, "joint", ft_path=ft, joint_depth_warmup=2, bg_depth_loss_weight=0.0)
    tr = Trainer(cfg, device="cpu")
    tr.setup_models()
    d0 = {k: v.clone() for k, v in tr.params.depth.state_dict().items()}
    tr = Trainer(cfg, device="cpu")
    tr.train(N_iters=3)
    for k, v in tr.params.depth.state_dict().items():
        torch.testing.assert_close(v, d0[k], rtol=0, atol=0)
    m = [ln for ln in open(os.path.join(tr.expdir, "metrics.jsonl")) if '"depth_live"' in ln]
    assert len(m) == 2 and all('"depth_live": 0.0' in ln for ln in m)
    assert tr.eval_params.kernels.depth is not None and tr.eval_params.kernels.hier is None
    tree, step = tckpt.load_checkpoint(os.path.join(tr.expdir, "000002.npz"))
    assert step == 2 and "depth" in tree["params"] and int(tree["depth_opt_state"][0]["count"]) == 0
    tr2 = Trainer(dataclasses.replace(cfg, ft_path=None), device="cpu")
    tr2.train(N_iters=4)
    assert tr2.start == 2 and tr2._depth_state.step == 3
    assert any(not torch.equal(v, d0[k]) for k, v in tr2.params.depth.state_dict().items())
    last = open(os.path.join(tr2.expdir, "psnr.txt")).read().splitlines()[-1]
    assert last.startswith("Iter: 3") and "Depth Net Loss" in last


@pytest.mark.parametrize("mode", ["nerf", "joint"])
def test_port_checkpoint_loads_in_jax(tmp_path, mode):
    """The port's nerf and joint .npz restore in the JAX Trainer's templates
    (params, the NeRF optimizer's state with its schedule count and, for
    joint, the DepthNet and its optimizer's state), leaf for leaf."""
    cfg = nerf_trainer_cfg(tmp_path, mode, i_testset=100)
    tr = Trainer(cfg, device="cpu")
    tr.train(N_iters=3)
    jparams, _ = small_models()
    nopt = jstate.make_nerf_optimizer(LR, DECAY)
    template = {"params": jparams._replace(depth=jparams.depth if mode == "joint" else None),
                "opt_state": nopt.init(jparams._replace(depth=None))}
    if mode == "joint":
        template["depth_opt_state"] = jstate.make_depth_optimizer(LR).init(jparams.depth)
    restored, step = jckpt.load_checkpoint(os.path.join(tr.expdir, "000002.npz"), template)
    assert step == 2 and int(restored["opt_state"][0].count) == int(restored["opt_state"][1].count) == 2
    st = tr._nerf_state
    mu = {n: st.optimizer.state[p]["exp_avg"] for n, p in st.model.named_parameters() if n.startswith("fine.")}
    assert max_rel(tckpt.nerf_params_to_jax({n[5:]: v for n, v in mu.items()}),
                   restored["opt_state"][0].mu.fine) == 0.0
    assert max_rel(tckpt.nerf_params_to_jax(tr.params.fine.state_dict()), restored["params"].fine) == 0.0
    if mode == "joint":
        assert int(restored["depth_opt_state"][0].count) == 2
        assert max_rel(tckpt.depth_net_params_to_jax(tr.params.depth.state_dict()), restored["params"].depth) == 0.0


def test_jax_nerf_checkpoint_resumes_in_port(tmp_path, rng):
    """A JAX nerf-mode .npz (one step of the JAX nerf step) restores in the
    port's Trainer: the NeRFs, the step and the Adam moments and count."""
    jparams, _ = small_models()
    jp, _ = pipelines()
    opt = jstate.make_nerf_optimizer(LR, DECAY)
    js = jstate.init_state(jparams._replace(depth=None), opt)
    jbatch, _ = batch_pair(jp, rng)
    js, _ = jax_nerf_step(jp, opt)(js, jbatch, jax.random.PRNGKey(0))
    cfg = nerf_trainer_cfg(tmp_path, "nerf")
    os.makedirs(os.path.join(cfg.basedir, cfg.expname))
    jckpt.save_checkpoint(os.path.join(cfg.basedir, cfg.expname, "000001.npz"),
                          {"params": js.params, "opt_state": js.opt_state}, 1)
    tr = Trainer(cfg, device="cpu")
    tr.setup_models()
    assert tr.start == 1
    nerf, _, _ = tr._make_states()
    assert adam_count(nerf.optimizer) == 1
    assert max_rel(net_tree(nerf.model, "coarse"), js.params.coarse) == 0.0
    nu = {n: nerf.optimizer.state[p]["exp_avg_sq"] for n, p in nerf.model.named_parameters()}
    got = tckpt.nerf_params_to_jax({n[5:]: v for n, v in nu.items() if n.startswith("fine.")})
    assert max_rel(got, js.opt_state[0].nu.fine) == 0.0


def test_cli_nerf_mode_defaults(tmp_path):
    """--mode nerf: precrop_iters 500 when the entry leaves it at 0, the
    expname {name}_nerf, no DepthNet in the pipeline; the kernel path on
    CPU tensors for 2 steps of a small config entry (the CLI's -c)."""
    datadir = str(tmp_path / "scene")
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset

    generate_example_dataset(datadir, H=16, W=16, n_train=2, n_val=1, n_test=1)
    config = tmp_path / "small.yaml"
    config.write_text(
        "small:\n  kwargs:\n    N_rand: 64\n    half_res: False\n    netdepth: 2\n    netwidth: 32\n"
        "    netdepth_fine: 2\n    netwidth_fine: 32\n    N_samples: 8\n    N_importance: 16\n"
        "    i_weights: 100\n    precrop_iters: 0\n")
    tr = run.main(["-c", str(config), "-m", "small", "-dp", datadir, "--mode", "nerf", "--mlp_impl", "cuda",
                   "--n_iters", "2", "-ip", "1", "--basedir", str(tmp_path / "logs"), "--testskip", "1",
                   "--i_testset", "2", "--seed", "0", "--device", "cpu"])
    cfg = tr.cfg
    assert (cfg.train_mode, cfg.precrop_iters, cfg.expname) == ("nerf", 500, "custom_nerf")
    assert tr.pipeline.depth is None and tr.global_step == 2 and tr._avg_eval_psnr > 0


def test_nerf_and_joint_raise_outside_the_kernels():
    """A "cuda" nerf or joint step outside K4/K5's envelope raises, naming
    what is missing; it never drops to the plain path."""
    _, tp = pipelines()
    cp = dataclasses.replace(tp, mlp_impl="cuda")
    for make in (make_nerf_train_step, make_joint_train_step):
        with pytest.raises(ValueError, match="use_viewdirs"):
            make(dataclasses.replace(cp, use_viewdirs=False))
        with pytest.raises(ValueError, match="positional encoding"):
            make(dataclasses.replace(cp, i_embed=-1))
        make(dataclasses.replace(cp, ndc=True, near=0.0, far=1.0, H=8, W=8, focal=9.0))  # NDC: K4/K5 take it
    _, model = nerf_pair("noskip")
    pts = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="do not split"):
        k4.nerf_points_kernel(pack_nerf(model), model.cfg, pts, torch.zeros(3, 3))
    with pytest.raises(TypeError, match="bf16 matrices"):
        k4.nerf_points_kernel(pack_nerf(model, torch.float32), model.cfg, pts, torch.zeros(10, 3))
    with pytest.raises(ValueError, match="g must be"):
        k5.nerf_points_bwd_kernel(pack_nerf(model), model.cfg, pts, torch.zeros(10, 3), torch.zeros(10, 3),
                                  want_dx=False)
    with pytest.raises(ValueError, match="train_mode"):
        Trainer(TrainerConfig(train_mode="bogus"), device="cpu")
