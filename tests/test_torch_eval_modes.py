"""The port's eval modes, the render CLI and the kernels behind them against the JAX package on CPU.

- K8's plain version (``render_linspace_plain``, linspace and lindisp)
  against the JAX Pallas ``fused_render`` in interpret mode: fp32 at 1e-5
  (measured 1.7e-6), bf16 at 1e-3 (measured 2.7e-4 on depth, the rotation
  PE off on the JAX side).
- K9's plain version (``shade_plain``, sorted and unsorted z) against the
  JAX ``fused_shade`` in interpret mode: fp32 at 1e-5, bf16 at 1e-3.
- K1 and K7 at fp32 through their CPU wrappers against
  ``fused_depth_net_apply`` and ``fused_render_hier`` at
  ``dtype=jnp.float32`` in interpret mode: 1e-4 (K7 3e-4, the tolerance of
  the JAX package's own fp32 hierarchical test).
- ``render_image`` in COMPARE_NERF, NERF_MAX and FULL_NERF (N_importance 0
  and 8) on the plain path and the kernel path on CPU tensors (the
  kernels' plain versions) against the JAX ``render_image`` (xla and
  pallas-interpret), each with its tolerance; COMPARE at the JAX test's
  1e-4 (depth_net_z_vals) and 3e-4 (max_z, rgb).
- ``render_path``'s psnr.txt with the compare MSE against JAX's, and its
  NaN on rays that miss the sphere.
- The Trainer's ``render_only`` (test views and path), train-set render and
  spiral video; the render CLI with its four modes and its ``-e`` grid.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each of
them to its plain version there.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import depth_pair, nerf_pair
from test_torch_kernels import rays_np as rays_np_narrow
from test_torch_train import NC, NERF_KW, NF, rays_np, small_models, tiny_scene

from nerf_sampling_tpu.kernels.fused_depth_net import fused_depth_net_apply as jax_fused_depth_net
from nerf_sampling_tpu.kernels.fused_hier import fused_render_hier as jax_fused_hier
from nerf_sampling_tpu.kernels.fused_render import fused_render as jax_fused_render
from nerf_sampling_tpu.kernels.fused_render import fused_shade as jax_fused_shade
from nerf_sampling_tpu.models import DepthNetConfig as JDepthNetConfig
from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu.render import path as jpath
from nerf_sampling_tpu_torch.experiments import render as render_cli
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
from nerf_sampling_tpu_torch.kernels import fused_hier as k7
from nerf_sampling_tpu_torch.kernels import fused_render as k89
from nerf_sampling_tpu_torch.models import DepthNetConfig, NeRFConfig
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.render.path import render_path
from nerf_sampling_tpu_torch.train import checkpoint as tckpt
from nerf_sampling_tpu_torch.train.trainer import Trainer
from nerf_sampling_tpu_torch.utils.config import TrainerConfig

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
MAPS = ("rgb_map", "disp_map", "acc_map", "depth_map")
# 1e-5 absolute at fp32 (relative for disp, which reaches 1e10 where acc is 0); bf16: the
# same roundings in both packages, up to the ones fp32 summation order flips
PLAIN_TOL = {"fp32": 1e-5, "bf16": 1e-3}


def assert_maps_close(got, want, tol, names=MAPS):
    for name in names:
        g, w = got[name].numpy(), np.asarray(want[name])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("lindisp,S", [(False, 64), (True, 16), (False, 2)])
def test_k8_plain_matches_pallas(rng, dt, lindisp, S):
    """K8's plain version against the JAX kernel; its z grid is the JAX
    kernel's, bit for bit."""
    params, jcfg, model = nerf_pair(2, 3, (0,))
    ro, rd = rays_np_narrow(150, rng)
    jdt, tdt = DTYPES[dt]
    want = jax_fused_render(params, jcfg, jnp.asarray(ro), jnp.asarray(rd), n_samples=S, lindisp=lindisp,
                            dtype=jdt, interpret=True, pe_rotation=False)
    got = k89.render_linspace_plain(k89.pack_nerf(model, tdt), model.cfg, torch.from_numpy(ro),
                                    torch.from_numpy(rd), n_samples=S, lindisp=lindisp, dtype=tdt)
    assert_maps_close(got, want, PLAIN_TOL[dt])
    t = np.arange(S, dtype=np.float32) / np.float32(S - 1)
    a, b = (np.float32(1 / 2.0), np.float32(1 / 6.0)) if lindisp else (np.float32(2.0), np.float32(6.0))
    v = a * (np.float32(1.0) - t) + b * t
    np.testing.assert_array_equal(k89.linspace_grid(S, 2.0, 6.0, lindisp).numpy(),
                                  np.float32(1.0) / v if lindisp else v)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("assume_sorted", [True, False])
def test_k9_plain_matches_pallas(rng, dt, assume_sorted):
    """K9's plain version against the JAX kernel on a gaussian population
    (sorted, or per ray in a random order) with a tie in every ray."""
    params, jcfg, model = nerf_pair(5, 2, (4,))
    n, S = 130, 16
    ro, rd = rays_np_narrow(n, rng)
    z = (4.0 + 0.5 * rng.standard_normal((n, S))).astype(np.float32)
    z[:, 3] = z[:, 7]  # a tie in every ray
    z = np.sort(z, -1)
    if not assume_sorted:
        z = np.take_along_axis(z, rng.permuted(np.tile(np.arange(S), (n, 1)), axis=1), 1)
    jdt, tdt = DTYPES[dt]
    want = jax_fused_shade(params, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), dtype=jdt,
                           interpret=True, assume_sorted=assume_sorted)
    got = k89.shade_plain(k89.pack_nerf(model, tdt), model.cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                          torch.from_numpy(z), assume_sorted=assume_sorted, dtype=tdt)
    assert_maps_close(got, want, PLAIN_TOL[dt])


def test_k9_unsorted_equals_sorted_and_nan_rays():
    """input_unsorted on a per-ray shuffled copy is input on the sorted z,
    bit for bit; a NaN ray stays NaN (sorted last), its neighbours finite."""
    _, _, model = nerf_pair(6, 2, (4,))
    rng = np.random.default_rng(3)
    n, S = 40, 12
    ro, rd = (torch.from_numpy(a) for a in rays_np_narrow(n, rng))
    z = torch.sort(torch.from_numpy((4.0 + rng.standard_normal((n, S))).astype(np.float32)), -1).values
    z[5, 4] = float("nan")
    shuffled = torch.gather(z, 1, torch.from_numpy(rng.permuted(np.tile(np.arange(S), (n, 1)), axis=1)))
    for dt in (torch.float32, torch.bfloat16):
        packed = k89.pack_nerf(model, dt)
        a = k89.fused_shade(packed, model.cfg, ro, rd, torch.sort(shuffled, dim=-1, stable=True).values, dtype=dt)
        b = k89.fused_shade(packed, model.cfg, ro, rd, shuffled, assume_sorted=False, dtype=dt)
        for name in MAPS:
            torch.testing.assert_close(a[name], b[name], rtol=0, atol=0, equal_nan=True)
        assert torch.isnan(b["rgb_map"][5]).all() and torch.isfinite(b["rgb_map"][6]).all()


def test_fp32_wrappers_on_cpu_match_pallas(rng):
    """K1 and K7 at fp32 through their CPU wrappers (no launch) against the
    JAX kernels at dtype=jnp.float32 in interpret mode; NaN on the rays that
    miss the sphere, as the JAX kernel."""
    params, jcfg, model = depth_pair(0)
    ro, rd = rays_np_narrow(96, rng, miss=3)
    before = build.launches.copy()
    want = np.asarray(jax_fused_depth_net(params, jcfg, jnp.asarray(ro), jnp.asarray(rd), dtype=jnp.float32,
                                          interpret=True))[:, 0]
    got = k1.fused_depth_net_apply(k1.pack_depth_net(model, torch.float32), model.cfg, torch.from_numpy(ro),
                                   torch.from_numpy(rd), torch.float32).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-3:]).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, equal_nan=True)

    jc, jcfg_n, coarse = nerf_pair(7)
    jf, _, fine = nerf_pair(8)
    ro, rd = rays_np(130, rng)
    want = jax_fused_hier(jc, jcfg_n, jf, jcfg_n, jnp.asarray(ro), jnp.asarray(rd), n_coarse=NC, n_importance=NF,
                          dtype=jnp.float32, interpret=True)
    got = k7.fused_render_hier(k7.pack_hier(coarse, fine, torch.float32), coarse.cfg, fine.cfg,
                               torch.from_numpy(ro), torch.from_numpy(rd), seed=None, n_coarse=NC,
                               n_importance=NF, dtype=torch.float32)
    for name in ("rgb_map", "max_z", "max_w", "max_rgb"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=3e-4, atol=3e-4, err_msg=name)
    assert build.launches == before


def test_fp32_wrappers_check_their_packs():
    """A wrapper takes the pack of its dtype and raises on the other; K6
    (seeded) runs bf16 only; K8 and K9 check their shapes."""
    _, _, model = nerf_pair(0)
    ro = torch.zeros(4, 3)
    for dt, other in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
        with pytest.raises(TypeError, match=f"{k89.dtype_name(dt)} matrices and fp32 biases"):
            k89.fused_render(k89.pack_nerf(model, other), model.cfg, ro, ro, n_samples=8, dtype=dt)
        with pytest.raises(TypeError, match=f"{k89.dtype_name(dt)} matrices and fp32 biases"):
            k89.fused_shade(k89.pack_nerf(model, other), model.cfg, ro, ro, torch.zeros(4, 8), dtype=dt)
    with pytest.raises(ValueError, match="n_samples"):
        k89.fused_render(k89.pack_nerf(model), model.cfg, ro, ro, n_samples=1)
    with pytest.raises(ValueError, match="z_vals"):
        k89.fused_shade(k89.pack_nerf(model), model.cfg, ro, ro, torch.zeros(4, 513))
    with pytest.raises(ValueError, match="bf16 only"):
        k7.render_hier_kernel(k7.pack_hier(model, model, torch.float32), model.cfg, model.cfg, ro, ro,
                              n_coarse=8, n_importance=8, seed=3, dtype=torch.float32)
    with pytest.raises(TypeError, match="both bf16 or both fp32"):
        z = torch.zeros(4, 128)
        k1.depth_net_kernel(k1.pack_depth_net(depth_pair(0)[2], torch.float32), depth_pair(0)[2].cfg, z,
                            z.to(torch.bfloat16))


# --- render_image in every mode against the JAX package -------------------------------------

DEPTH_KW = dict(hidden_sizes=(16, 16), cat_hidden_sizes=(16, 16))


def mode_setup(n_importance=NF, sampling_mode="uniform"):
    """The JAX package's own mode-dispatch fields (tests/test_fused_render.py::
    TestFusedModeDispatch): active 2x32 NeRFs, a 2x16 DepthNet, 8 samples
    around the depth at distance 0.5, a 6x8 view from z = 4."""
    jparams, tparams = small_models()
    from nerf_sampling_tpu.models import depth_net_init
    from nerf_sampling_tpu_torch.models import DepthNet

    jd = depth_net_init(jax.random.PRNGKey(2), JDepthNetConfig(**DEPTH_KW))
    depth = DepthNet(DepthNetConfig(**DEPTH_KW))
    depth.load_state_dict(tckpt.params_from_jax({"depth": jax.tree.map(np.asarray, jd)})["depth"], strict=True)
    jparams, tparams = jparams._replace(depth=jd), tparams._replace(depth=depth.eval())
    kw = dict(N_samples=NC, N_importance=n_importance, n_depth_samples=8, sampling_mode=sampling_mode,
              distance=0.5)
    jp = jengine.Pipeline(nerf=JNeRFConfig(**NERF_KW), fine=JNeRFConfig(**NERF_KW),
                          depth=JDepthNetConfig(**DEPTH_KW), mlp_impl="xla", **kw)
    tp = tengine.Pipeline(nerf=NeRFConfig(**NERF_KW), fine=NeRFConfig(**NERF_KW),
                          depth=DepthNetConfig(**DEPTH_KW), mlp_impl="plain", **kw)
    H, W, focal = 6, 8, 10.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    c2w = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
    return jparams, tparams, jp, tp, H, W, K, c2w


def per_ray(got, want, name, n):
    return np.abs(got[name].numpy() - np.asarray(want[name])).reshape(n, -1).max(-1)


# per (mode, impl): {output: tolerance}, a tolerance being (bound on every ray,), or (bound,
# looser bound, rays that may take it), or ("mean", bound on the mean, bound on every ray).
# The plain FULL_NERF pass meets the inverse-CDF amplification of
# tests/test_torch_nerf_train.py::test_full_nerf_plain_matches_jax on a few rays (measured:
# 3 rays above 1e-4, max 9.0e-4). Measured maxima: COMPARE max_z 8.4e-5 (plain) and
# 8.6e-6 (kernel path), rgb 9.8e-6, z 4.8e-7; NERF_MAX kernel path max_z 1.6e-3, rgb
# 4.8e-4; FULL_NERF kernel path rgb mean 5.5e-4, max 2.4e-2 (K7's bounds in
# tests/test_torch_nerf_train.py::test_k7_wrapper_matches_pallas_det); N_importance 0: rgb
# 1.7e-6 (plain), 1.6e-5 (K8 at bf16 against JAX's bf16 kernel with its rotation PE).
MODE_CASES = {
    ("COMPARE_NERF", "plain"): {"depth_net_z_vals": (1e-4,), "max_z_vals": (3e-4,), "depth_net_rgb_map": (3e-4,)},
    ("COMPARE_NERF", "cuda"): {"depth_net_z_vals": (1e-4,), "max_z_vals": (3e-4,), "depth_net_rgb_map": (3e-4,)},
    ("NERF_MAX", "plain"): {"max_z_vals": (3e-4,), "depth_net_rgb_map": (3e-4,), "depth_net_disp_map": (0.0,)},
    ("NERF_MAX", "cuda"): {"max_z_vals": (0.05,), "depth_net_rgb_map": (0.02,)},
    ("FULL_NERF", "plain"): {"depth_net_rgb_map": (1e-4, 2e-3, 4), "max_z_vals": (3e-4,)},
    ("FULL_NERF", "cuda"): {"depth_net_rgb_map": ("mean", 2e-3, 5e-2)},
    ("FULL_NERF_N0", "plain"): {"depth_net_rgb_map": (1e-5,), "depth_net_z_vals": (1e-5,)},
    ("FULL_NERF_N0", "cuda"): {"depth_net_rgb_map": (1e-3,)},
}


@pytest.mark.parametrize("mode,impl", list(MODE_CASES))
def test_render_image_modes_match_jax(mode, impl):
    """Each mode on the plain path against JAX's xla render, and on the
    kernel path (CPU tensors: the kernels' plain versions, fp32 in COMPARE,
    bf16 otherwise) against JAX's pallas render in interpret mode. The
    kernel path's bf16 cases hold to the JAX package's own bounds for its
    bf16 kernels (tests/test_fused_render.py: 0.02 rgb, 0.05 max_z)."""
    n_imp = 0 if mode == "FULL_NERF_N0" else NF
    jparams, tparams, jp, tp, H, W, K, c2w = mode_setup(n_imp)
    emode = mode.replace("_N0", "")
    jimpl, timpl = ("xla", "plain") if impl == "plain" else ("pallas", "cuda")
    want = jengine.render_image(dataclasses.replace(jp, mlp_impl=jimpl), jparams, H, W, jnp.asarray(K),
                                jnp.asarray(c2w), jax.random.PRNGKey(0), getattr(jengine.EvalMode, emode))
    got = tengine.render_image(dataclasses.replace(tp, mlp_impl=timpl), tparams, H, W, K, c2w, device="cpu",
                               mode=getattr(tengine.EvalMode, emode))
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
    for name, tol in MODE_CASES[mode, impl].items():
        d = per_ray(got, want, name, H * W)
        if len(tol) == 1:
            assert d.max() <= tol[0], (name, d.max())
        elif tol[0] == "mean":
            assert d.mean() <= tol[1] and d.max() <= tol[2], (name, d.mean(), d.max())
        else:
            assert (d > tol[0]).sum() <= tol[2] and d.max() <= tol[1], (name, np.sort(d)[-5:])
    if emode == "NERF_MAX":  # the reference quirk: disp is zeros shaped like rgb
        assert got["depth_net_disp_map"].shape == (H, W, 3) and not got["depth_net_disp_map"].any()


def test_compare_gaussian_kernel_path_matches_plain():
    """COMPARE with the gaussian population: JAX and torch draws differ, so
    the kernel path on CPU tensors is held to the plain path with the same
    generator: the same z, max_z at 3e-4 and rgb at 3e-4."""
    _, tparams, _, tp, H, W, K, c2w = mode_setup(sampling_mode="gaussian")
    out = {impl: tengine.render_image(dataclasses.replace(tp, mlp_impl=impl), tparams, H, W, K, c2w, device="cpu",
                                      mode=tengine.EvalMode.COMPARE_NERF,
                                      generator=torch.Generator().manual_seed(4))
           for impl in ("plain", "cuda")}
    with pytest.raises(ValueError, match="Generator"):
        tengine.render_image(dataclasses.replace(tp, mlp_impl="cuda"), tparams, H, W, K, c2w, device="cpu",
                             mode=tengine.EvalMode.COMPARE_NERF)
    a, b = out["plain"], out["cuda"]
    torch.testing.assert_close(a["depth_net_z_vals"], b["depth_net_z_vals"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a["max_z_vals"], b["max_z_vals"], rtol=0, atol=3e-4)
    torch.testing.assert_close(a["depth_net_rgb_map"], b["depth_net_rgb_map"], rtol=0, atol=3e-4)
    assert float(a["depth_net_z_vals"].std()) > 0.1  # a real spread


def test_kernel_path_envelope_raises():
    """Where the JAX package drops to its composable path, the port's "cuda"
    path raises ValueError naming the envelope (a decided divergence)."""
    _, tparams, _, tp, H, W, K, c2w = mode_setup()
    cp = dataclasses.replace(tp, mlp_impl="cuda")
    M = tengine.EvalMode
    cases = [
        (dataclasses.replace(cp, N_importance=0), M.COMPARE_NERF, "N_importance > 0"),
        (dataclasses.replace(cp, N_importance=0), M.NERF_MAX, "N_importance > 0"),
        (dataclasses.replace(cp, N_samples=2), M.FULL_NERF, "N_samples >= 4"),
        (dataclasses.replace(cp, N_samples=400, N_importance=200), M.NERF_MAX, "<= 512"),
        (dataclasses.replace(cp, N_samples=1, N_importance=0), M.FULL_NERF, "2..512"),
        (dataclasses.replace(cp, sampling_mode="depth_only", n_depth_samples=1), M.COMPARE_NERF, "2..512"),
    ]
    for pipe, mode, match in cases:
        with pytest.raises(ValueError, match=match):
            tengine.render_image(pipe, tparams, H, W, K, c2w, device="cpu", mode=mode)
    # the plain path renders them all, as the JAX composable path does
    for pipe, mode, _ in cases[:2] + cases[-1:]:
        out = tengine.render_image(dataclasses.replace(pipe, mlp_impl="plain"), tparams, H, W, K, c2w,
                                   device="cpu", mode=mode)
        assert torch.isfinite(out["depth_net_rgb_map"]).all()


def test_packs_for_each_mode_and_full_outputs():
    """eval_packs names what each mode's kernel path reads; packs made once
    render what the path packs on its own; full_outputs renders per-sample
    outputs on the plain path whatever mlp_impl says."""
    _, tparams, _, tp, H, W, K, c2w = mode_setup()
    cp = dataclasses.replace(tp, mlp_impl="cuda")
    M = tengine.EvalMode
    assert tengine.eval_packs(cp, M.COMPARE_NERF) == {"with_hier": False, "with_coarse": False, "with_fp32": True}
    assert tengine.eval_packs(cp, M.NERF_MAX)["with_hier"]
    assert tengine.eval_packs(dataclasses.replace(cp, N_importance=0), M.FULL_NERF)["with_coarse"]
    packed = tengine.pack_kernel_weights(tparams, **tengine.eval_packs(cp, M.COMPARE_NERF))
    assert packed.kernels.fp32.hier["fine"]["w0"].dtype == torch.float32
    assert packed.kernels.fp32.depth["head_w"].dtype == torch.float32
    once = tengine.render_image(cp, packed, H, W, K, c2w, device="cpu", mode=M.COMPARE_NERF)
    each = tengine.render_image(cp, tparams, H, W, K, c2w, device="cpu", mode=M.COMPARE_NERF)
    for name in once:
        torch.testing.assert_close(once[name], each[name], rtol=0, atol=0)
    full = tengine.render_image(cp, tparams, H, W, K, c2w, device="cpu", mode=M.COMPARE_NERF, full_outputs=True)
    plain = tengine.render_image(tp, tparams, H, W, K, c2w, device="cpu", mode=M.COMPARE_NERF)
    assert full["depth_net_pts"].shape == (H, W, 8, 3)
    for name in plain:
        torch.testing.assert_close(full[name], plain[name], rtol=0, atol=0)


# --- render_path, the Trainer and the CLI -----------------------------------------------------


def test_render_path_compare_mse_matches_jax(tmp_path):
    """psnr.txt in COMPARE mode: the per-image MSE and its average line, as
    JAX's render_path writes them (PSNR and MSE at 1e-4 relative)."""
    jparams, tparams, jp, tp, H, W, K, c2w = mode_setup()
    poses = [np.concatenate([c2w, [[0, 0, 0, 1]]]).astype(np.float32)] * 2
    poses[1] = poses[1].copy()
    poses[1][0, 3] = 0.2
    gts = np.full((2, H, W, 3), 0.7, np.float32)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(), tdir.mkdir()
    jpath.render_path(jp, jparams, poses, (H, W, 10.0), K, jax.random.PRNGKey(0), mode=jengine.EvalMode.COMPARE_NERF,
                      gt_imgs=gts, savedir=str(jdir), verbose=False)
    _, _, avg = render_path(tp, tparams, poses, (H, W, 10.0), K, device="cpu", mode=tengine.EvalMode.COMPARE_NERF,
                            gt_imgs=gts, savedir=str(tdir), verbose=False)
    jl, tl = ((d / "psnr.txt").read_text().splitlines() for d in (jdir, tdir))
    assert len(tl) == len(jl) == 5 and tl[2] == jl[2] == "Avg of 2 images:"
    assert tl[4].startswith("MSE: ") and ", MSE: " in tl[0]

    def numbers(line):
        return [float(x.split(",")[0]) for x in line.split(": ")[1:]]

    for a, b in zip(tl, jl):
        if a != b:
            np.testing.assert_allclose(numbers(a), numbers(b), rtol=1e-4)
    assert abs(avg - numbers(tl[3])[0]) < 1e-9
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))


def test_compare_mse_is_nan_where_rays_miss_the_sphere():
    """A ray that misses the bounding sphere has NaN DepthNet depth, so the
    compare MSE of its image is NaN, as in the JAX diagnostic."""
    jparams, tparams, jp, tp, H, W, K, c2w = mode_setup()
    far = c2w.copy()
    far[2, 3] = 40.0  # the view from z = 40: the border rays miss the r=1 sphere
    want = jengine.render_image(jp, jparams, H, W, jnp.asarray(K), jnp.asarray(far), jax.random.PRNGKey(0),
                                jengine.EvalMode.COMPARE_NERF)
    from nerf_sampling_tpu_torch.render.path import compare_mse

    for impl in ("plain", "cuda"):
        got = tengine.render_image(dataclasses.replace(tp, mlp_impl=impl), tparams, H, W, K, far, device="cpu",
                                   mode=tengine.EvalMode.COMPARE_NERF)
        miss = torch.isnan(got["depth_net_z_vals"]).all(-1)
        np.testing.assert_array_equal(miss.numpy(), np.isnan(np.asarray(want["depth_net_z_vals"])).all(-1))
        assert miss.any() and not miss.all()
        assert np.isnan(compare_mse(got))


def trainer_cfg(tmp_path, **kw):
    base = dict(
        datadir=tiny_scene(tmp_path), basedir=str(tmp_path / "logs"), expname="e", netdepth=2, netwidth=32,
        netdepth_fine=2, netwidth_fine=32, n_layers=3, layer_width=32, sphere_radius=2.0, N_samples=NC,
        N_importance=NF, N_rand=64, n_depth_samples=8, sampling_mode="uniform", distance=1.0, mlp_impl="cuda",
        testskip=1, i_print=1,
    )
    base.update(kw)
    return TrainerConfig(**base)


def small_npz(path):
    """A JAX-layout .npz of the small NeRFs and a 3x32 DepthNet."""
    jparams, _ = small_models()
    from nerf_sampling_tpu.train import checkpoint as jckpt

    jckpt.save_checkpoint(path, {"params": jparams}, 0)
    return path


@pytest.mark.parametrize("render_test", [True, False])
def test_trainer_render_only(tmp_path, render_test):
    """render_only in COMPARE mode on the kernel path (CPU tensors): the
    test views with psnr.txt (and the MSE) and the scene data, or the
    spiral path at half resolution (render_factor 2) without; PNGs and a
    video either way; nothing trained, no checkpoint written."""
    cfg = trainer_cfg(tmp_path, render_only=True, render_test=render_test, compare_nerf=True,
                      ft_path=small_npz(str(tmp_path / "ck.npz")), save_scene_data=render_test,
                      render_factor=0 if render_test else 2)
    tr = Trainer(cfg, device="cpu")
    avg = tr.train(N_iters=1)
    d = os.path.join(tr.expdir, f"renderonly_{'test' if render_test else 'path'}_000000")
    files = sorted(os.listdir(d))
    n = len(tr.scene.i_test) if render_test else len(tr.scene.render_poses)
    assert files[:n] == [f"{i:03d}.png" for i in range(n)] and "video.gif" in files
    assert not [f for f in os.listdir(tr.expdir) if f.endswith(".npz")]
    assert tr.eval_params.kernels.fp32 is not None
    H, W, _ = tr.scene.hwf
    if render_test:
        lines = open(os.path.join(d, "psnr.txt")).read().splitlines()
        assert ", MSE: " in lines[0] and lines[-1].startswith("MSE: ")
        assert abs(avg - float(lines[-2].split(": ")[1])) < 1e-9
        data = np.load(os.path.join(d, "scene_data.npz"))  # the plain path's per-sample outputs
        assert data["all_pts"].shape == (n * H * W * 8, 3) and data["all_weights"].shape == (n * H * W * 8,)
    else:
        assert avg == 0.0 and "psnr.txt" not in files and "scene_data.npz" not in files
        from PIL import Image

        with Image.open(os.path.join(d, "000.png")) as im:
            assert im.size == (W // 2, H // 2)


def test_trainer_repacks_fp32_packs_for_compare_evals(tmp_path):
    """Joint training with COMPARE_NERF evals on the kernel path (CPU
    tensors): the eval reads fp32 packs made from the trained weights, not
    from the weights at setup."""
    from nerf_sampling_tpu.train import checkpoint as jckpt

    jparams, _ = small_models()
    ft = str(tmp_path / "nerf.npz")
    jckpt.save_checkpoint(ft, {"params": jparams._replace(depth=None)}, 0)
    cfg = trainer_cfg(tmp_path, train_mode="joint", compare_nerf=True, ft_path=ft, i_testset=2, i_weights=100,
                      bg_depth_loss_weight=0.0)
    tr = Trainer(cfg, device="cpu")
    tr.train(N_iters=3)
    fp32 = tr.eval_params.kernels.fp32
    assert tr._eval_mode() == tengine.EvalMode.COMPARE_NERF
    fresh = tengine.pack_kernel_weights(tr.params, with_fp32=True).kernels.fp32
    for a, b in ((fp32.hier["fine"]["w0"], fresh.hier["fine"]["w0"]), (fp32.nerf["w0"], fresh.nerf["w0"]),
                 (fp32.depth["head_w"], fresh.depth["head_w"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    start = tengine.pack_kernel_weights(small_models()[1], with_fp32=True).kernels.fp32
    assert not torch.equal(fp32.hier["fine"]["w0"], start.hier["fine"]["w0"])
    assert "MSE: " in open(os.path.join(tr.expdir, "testset_000002", "psnr.txt")).read()


def test_trainer_train_set_render_and_spiral_video(tmp_path):
    """save_train_set_render at the eval step and the spiral video at
    i_video, in NERF_MAX mode on the kernel path (CPU tensors)."""
    cfg = trainer_cfg(tmp_path, use_nerf_max_pts=True, save_train_set_render=True, i_testset=2, i_video=2,
                      i_weights=100, ft_path=small_npz(str(tmp_path / "ck.npz")), bg_depth_loss_weight=0.0)
    tr = Trainer(cfg, device="cpu")
    tr.train(N_iters=3)
    exp = tr.expdir
    assert sorted(os.listdir(os.path.join(exp, "trainset_000002"))) == [
        f"{i:03d}.png" for i in range(len(tr.scene.i_train[:10]))]
    for f in ("e_spiral_000002_rgb.gif", "e_spiral_000002_disp.gif", os.path.join("testset_000002", "psnr.txt")):
        assert os.path.exists(os.path.join(exp, f)), f
    from PIL import Image

    with Image.open(os.path.join(exp, "e_spiral_000002_rgb.gif")) as im:
        assert im.n_frames == len(tr.scene.render_poses)


def test_trainer_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    """Trainer(cfg) runs on the card; without one it raises, and the CLIs
    with it. device="cpu" (--device cpu) runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainerConfig(), device="cuda")
    assert Trainer(TrainerConfig(), device="cpu").device.type == "cpu"
    datadir = str(tmp_path / "scene")
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset

    generate_example_dataset(datadir, H=16, W=16, n_train=1, n_val=1, n_test=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_cli.main(["-dp", datadir, "--basedir", str(tmp_path / "logs")])
    from nerf_sampling_tpu_torch.experiments import run

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["-dp", datadir, "--basedir", str(tmp_path / "logs"), "--n_iters", "1"])


def cli_scene(tmp_path):
    """A 32x32 scene with 2 test views, a small config entry and its
    checkpoint (NeRFs and DepthNet) for the render CLI."""
    datadir = str(tmp_path / "scene")
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset

    generate_example_dataset(datadir, H=32, W=32, n_train=1, n_val=1, n_test=2)
    config = tmp_path / "small.yaml"
    config.write_text(
        "small:\n  kwargs:\n    half_res: False\n    netdepth: 2\n    netwidth: 32\n    netdepth_fine: 2\n"
        "    netwidth_fine: 32\n    N_samples: 8\n    N_importance: 16\n")
    jparams, _ = small_models()
    from nerf_sampling_tpu.models import depth_net_init
    from nerf_sampling_tpu.train import checkpoint as jckpt

    jcfg = JDepthNetConfig(hidden_sizes=(256,) * 10, cat_hidden_sizes=(256,) * 10)
    jd = depth_net_init(jax.random.PRNGKey(9), jcfg)  # the CLI's 10x256 DepthNet
    ckpt = str(tmp_path / "ck.npz")
    jckpt.save_checkpoint(ckpt, {"params": jparams._replace(depth=jd)}, 0)
    return datadir, str(config), ckpt


def test_render_cli_modes(tmp_path):
    """The render CLI's four modes on the kernel path (CPU tensors), on the
    test views: PNGs, psnr.txt (with the MSE for -nc), the expnames of the
    JAX CLI, and no kernel launched (CPU tensors run the plain versions)."""
    datadir, config, ckpt = cli_scene(tmp_path)
    base = ["-c", config, "-m", "small", "-dp", datadir, "--ft_path", ckpt, "--basedir", str(tmp_path / "logs"),
            "--device", "cpu", "--n_samples", "16", "--distance", "1.0", "--testskip", "1"]
    counts = build.launches.copy()
    for flag, expname in (([], "None_depth_net_render_n_samples_16_distance_1.0_sampling_mode_uniform"),
                          (["-nc"], "None_depth_net_render_mse"), (["-nm"], "None_nerf_max_render"),
                          (["-nf"], "None_nerf_full_render")):
        tr = render_cli.main(base + flag)
        assert tr.cfg.expname == expname and tr.pipeline.mlp_impl == "cuda"
        d = os.path.join(tr.expdir, "renderonly_test_000000")
        lines = open(os.path.join(d, "psnr.txt")).read().splitlines()
        assert lines[0].startswith("000.png, PSNR: ") and lines[2] == "Avg of 2 images:"
        assert (", MSE: " in lines[0]) == (flag == ["-nc"])
        assert {"000.png", "001.png", "video.gif"} <= set(os.listdir(d))
    assert build.launches == counts
    # the int8 mode (K10): calibrated on the loaded NeRFs, the int8 kernels' plain versions on CPU
    tr = render_cli.main(base + ["--mlp_impl", "pallas_int8"])
    assert tr.pipeline.mlp_impl == "cuda_int8" and len(tr.pipeline.quant_calib) == 2
    assert tr.eval_params.kernels.nerf["trunk_wq"][0].dtype == torch.int8
    lines = open(os.path.join(tr.expdir, "renderonly_test_000000", "psnr.txt")).read().splitlines()
    assert lines[0].startswith("000.png, PSNR: ") and lines[2] == "Avg of 2 images:"


def test_render_cli_experiment_grid(tmp_path):
    """-e: the 32 renders of the sweep grid into experiments_results.txt in
    the JAX CLI's format, each PSNR that Trainer's average to 2 digits."""
    datadir, config, ckpt = cli_scene(tmp_path)
    tr = render_cli.main(["-c", config, "-m", "small", "-dp", datadir, "--ft_path", ckpt, "--testskip", "2",
                          "--basedir", str(tmp_path / "logs"), "--device", "cpu", "--mlp_impl", "plain", "-e"])
    text = open(tmp_path / "logs" / "experiments" / "experiments_results.txt").read()
    lines = text.splitlines()
    assert lines[0] == "Experiments" and lines[2] == "Sampling mode: uniform"
    psnrs = [ln for ln in lines if ln.startswith("    Distance: ")]
    assert len(psnrs) == 32 and lines.count("N_samples: 128:") == 2
    assert psnrs[0].startswith("    Distance: 0.1, PSNR: ") and psnrs[-1].startswith("    Distance: 1, PSNR: ")
    assert all(np.isfinite(float(ln.split("PSNR: ")[1])) for ln in psnrs)
    assert tr.cfg.sampling_mode == "gaussian" and tr.cfg.n_depth_samples == 128
