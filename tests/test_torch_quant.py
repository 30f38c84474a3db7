"""The port's int8 mode (K10, W8A8) against the JAX package on CPU.

Same inputs from a numpy seed through both packages; the JAX Pallas paths
run in interpret mode (``pe_rotation=False`` where the kernel has it), as
``tests/test_torch_kernels.py`` runs them. Tolerances:

- ``_decompose``: equal; the integer requant equal to JAX's ``_requant_int``
  bit for bit and within one LSB of a/S; saturation, not wrap-around.
- ``calibrate_nerf_quant``: the shifts (p, q) equal, the multipliers m
  equal but for at most one off by one, the float scales within 1e-5
  relative. The PE (cos against JAX's sin(x + pi/2)) and the matmul order
  differ in last bits, and m = round(2^(p+q) / S) flips where its argument
  sits at a half: measured with 64 rays x 9 z, trunk layer 3's m is 25089
  here and 25090 in JAX (a requant scale 4e-5 apart); at 512 x 17 all equal.
- ``qpack_nerf``: int8 weights and int32 bias rows bit-equal, fp32 rows
  within 1 ulp, the folded alpha head bit-equal in bf16.
- ``mlp_plain_q`` against ``mlp_forward_affine_q`` on the same bf16 S (the
  port's embeddings mapped into JAX's S layout): raw within 1e-5 of the
  largest |raw| (measured: equal). The int8 activations absorb last-bit
  differences of the fp32 sums unless one sits on a rounding boundary,
  which then moves an int8 value by one and its ray's raw by about 1e-2.
- The int8 plain versions of K2, K3, K8, K9 and K7 against the JAX int8
  kernels, on fields with density (mean acc above 0.2): NaN where JAX is,
  every map within 1e-3 on average and 5e-2 at most. The JAX kernels
  build their PE affinely in z, so a bf16 PE value differs now and then,
  and an int8 activation on a rounding boundary flips with it (measured:
  K2 and K3 equal; K9 one flip, 2.3e-4; K8 depth mean 1.3e-4, max 5.5e-3).
  K7, where a flip moves fine samples, at 2e-3 on average, the bound of
  its bf16 kernel path in tests/test_torch_eval_modes.py (measured: rgb
  mean 6.0e-4, max 1.6e-2; acc mean 1.2e-3, max 2.9e-2). Its depth and
  argmax move by a sample spacing where a flip moves a fine sample (depth
  mean 1.5e-2, max 0.16; max_w mean 4.6e-3): max_z is held by its median,
  within a coarse spacing, as JAX's test_int8_hier_close_to_bf16 holds it.
- ``render_flat_rays`` under "cuda_int8" against JAX's "pallas_int8": the
  maps of DEPTH_NET, FULL_NERF and NERF_MAX at the same bounds;
  COMPARE_NERF is the "cuda" path's, bit for bit.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each int8
mode to its plain version there.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import tiny_trainer_cfg

from nerf_sampling_tpu.kernels import quant as jquant
from nerf_sampling_tpu.kernels.fused_hier import fused_render_hier as jax_fused_hier
from nerf_sampling_tpu.kernels.fused_render import fused_render as jax_fused_render
from nerf_sampling_tpu.kernels.fused_render import fused_render_around_depth as jax_fused_around_depth
from nerf_sampling_tpu.kernels.fused_render import fused_shade as jax_fused_shade
from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig
from nerf_sampling_tpu.models import nerf_init_active
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.experiments import run
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_hier as k67
from nerf_sampling_tpu_torch.kernels import fused_render as k289
from nerf_sampling_tpu_torch.kernels import philox, quant
from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.render.quantize import calibrate_pipeline, scene_rays
from nerf_sampling_tpu_torch.train.checkpoint import params_from_jax
from nerf_sampling_tpu_torch.train.trainer import Trainer

# the production trunk (8 layers, a skip at layer 5) at a narrow width
KW = dict(D=8, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True)
MAPS = ("rgb_map", "acc_map", "depth_map", "disp_map")
KERNEL_MEAN_TOL, KERNEL_MAX_TOL = 1e-3, 5e-2
HIER_MEAN_TOL = 2e-3


def nerf_pair(seed, **kw):
    """The same active NeRF in both packages."""
    cfg = {**KW, **kw}
    params = nerf_init_active(jax.random.PRNGKey(seed), JNeRFConfig(**cfg))
    model = NeRF(NeRFConfig(**cfg))
    model.load_state_dict(params_from_jax({"coarse": jax.tree.map(np.asarray, params)})["coarse"])
    return params, JNeRFConfig(**cfg), model


def rays_np(n, rng):
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
    rd[:, 2] = -1.0
    return ro, rd


def calibrate(model, ro, rd, **kw):
    return quant.calibrate_nerf_quant(model, torch.from_numpy(ro), torch.from_numpy(rd), n_rays=64, n_z=9, **kw)


def to_jax(calib: quant.QuantCalib) -> jquant.QuantCalib:
    return jquant.QuantCalib(sh0=calib.sh0, steps=calib.steps, feat=calib.feat)


def quant_setup(rng, seed=0, n=64):
    jp, jcfg, model = nerf_pair(seed)
    ro, rd = rays_np(n, rng)
    calib = calibrate(model, ro, rd)
    return jp, jcfg, model, ro, rd, calib


def assert_close(g, w, name, mean_tol=KERNEL_MEAN_TOL):
    """NaN where the JAX map is, the rest within ``mean_tol`` on average and
    KERNEL_MAX_TOL at most (an int8 flip at a rounding boundary)."""
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
    d = np.abs(g - w)[~np.isnan(w)]
    assert d.mean() <= mean_tol and d.max() <= KERNEL_MAX_TOL, (name, d.mean(), d.max())


def assert_maps(got, want, names=MAPS, mean_tol=KERNEL_MEAN_TOL):
    assert np.nanmean(np.asarray(want["acc_map"])) > 0.2  # a field with density: the maps say something
    for name in names:
        assert_close(got[name].numpy(), np.asarray(want[name]), name, mean_tol)


# --- the integer requant and the calibration --------------------------------------------------


@pytest.mark.parametrize("S", [0.51, 3.7, 127.0, 5e3, 3.3e6])
def test_decompose_and_requant_match_jax(S):
    """JAX's TestDecompose scales: the same (p, q, m); the requant of the
    unsigned and the signed clip equal to JAX's and within 1 LSB of a/S."""
    assert quant._decompose(S) == jquant._decompose(S)
    step = ("int",) + quant._decompose(S)
    a = np.linspace(-127 * S, 127 * S, 513).astype(np.int64)
    for lo in (0, -127):
        got = quant._requant_int(torch.from_numpy(a), step, lo).numpy()
        want = np.asarray(jquant._requant_int(jnp.asarray(a, jnp.int32), step, lo)).astype(np.float32)
        np.testing.assert_array_equal(got, want)
        assert np.abs(got - np.clip(a / S, lo, 127)).max() <= 1.0


def test_requant_saturates_not_wraps():
    """JAX's TestRequantSaturation on the port: an accumulator far past the
    calibrated range clips to the rail, it does not wrap through t*m."""
    step = ("int",) + quant._decompose((2.0**20) / 127.0)
    assert step[1] > 0
    assert int(quant._requant_int(torch.tensor([2**19]), step, 0)[0]) > 0
    huge = torch.tensor([2**31 - 1])
    assert int(quant._requant_int(huge, step, 0)[0]) == 127
    assert int(quant._requant_int(huge, step, -127)[0]) == 127
    assert int(quant._requant_int(-huge, step, -127)[0]) == -127


@pytest.mark.parametrize("n_rays,n_z", [(64, 9), (512, 17)])
def test_calibration_matches_jax(rng, n_rays, n_z):
    jp, jcfg, model = nerf_pair(0)
    ro, rd = rays_np(600, rng)
    want = jquant.calibrate_nerf_quant(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), n_rays=n_rays, n_z=n_z)
    got = quant.calibrate_nerf_quant(model, torch.from_numpy(ro), torch.from_numpy(rd), n_rays=n_rays, n_z=n_z)
    assert [s[0] for s in got.steps] == [s[0] for s in want.steps] == ["int"] * 4 + ["skip"] + ["int"] * 2
    flips = 0
    for g, w in zip(got.steps + (got.feat,), want.steps + (want.feat,)):
        if g[0] == "int":
            assert g[:3] == w[:3] and abs(g[3] - w[3]) <= 1, (g, w)
            flips += g[3] != w[3]
        else:
            np.testing.assert_allclose(g[1], w[1], rtol=1e-5)
    assert flips <= 1
    np.testing.assert_allclose(got.sh0, want.sh0, rtol=1e-5)
    hash(got)  # static, as JAX's jit key


def test_qpack_matches_jax(rng):
    jp, jcfg, model, _, _, calib = quant_setup(rng, seed=1)
    jq = jquant.qpack_nerf_params(jp, jcfg, to_jax(calib))
    tq = quant.qpack_nerf(model, calib)
    for i in range(1, KW["D"]):
        assert tq["trunk_wq"][i - 1].dtype == torch.int8
        np.testing.assert_array_equal(tq["trunk_wq"][i - 1].numpy().T, np.asarray(jq["trunk_wq"][i]))  # [out, in]
        row, jrow = tq["trunk_row"][i - 1].numpy(), np.asarray(jq["trunk_row"][i])[0]
        if calib.steps[i - 1][0] == "skip":
            assert row.dtype == np.float32
            np.testing.assert_array_max_ulp(row, jrow, maxulp=1)
            np.testing.assert_array_equal(tq["skip_b"][i].numpy(), np.asarray(jq["skip_b"][i])[0])
        else:
            assert row.dtype == np.int32
            np.testing.assert_array_equal(row, jrow)
    np.testing.assert_array_equal(tq["feature_wq"].numpy().T, np.asarray(jq["feature_wq"]))
    np.testing.assert_array_equal(tq["feature_bz"].numpy(), np.asarray(jq["feature_bz"])[0])
    np.testing.assert_array_equal(tq["views_wq"].numpy().T, np.asarray(jq["views_wq"]))
    np.testing.assert_array_max_ulp(tq["views_sw"].numpy(), np.asarray(jq["views_sw"])[0], maxulp=1)
    assert tq["alpha_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tq["alpha_w"].float().numpy(),
                                  np.asarray(jq["head_alpha4"][:, 3]).astype(np.float32))
    np.testing.assert_array_equal(tq["b0"].numpy(), np.asarray(jq["b0"]).reshape(-1))


def jax_s_matrix(x_pts: np.ndarray, x_v: np.ndarray):
    """The port's bf16 embeddings [x, sin/cos per frequency] in the JAX
    kernel's S layout (fused_nerf._pe_matrices): the sin/cos lanes of the
    points then of the directions, then the raw passthrough lanes."""
    from nerf_sampling_tpu.kernels.fused_nerf import PAD, raw_base

    rb = raw_base(10, 4)
    S = np.zeros((x_pts.shape[0], PAD), np.float32)
    S[:, 0:60], S[:, 60:rb] = x_pts[:, 3:63], x_v[:, 3:27]
    S[:, rb:rb + 3], S[:, rb + 3:rb + 6] = x_pts[:, 0:3], x_v[:, 0:3]
    return jnp.asarray(S, jnp.bfloat16)


@pytest.mark.parametrize("heads", ["full", "sigma"])
def test_mlp_plain_q_matches_jax(rng, heads):
    jp, jcfg, model, ro, rd, calib = quant_setup(rng, seed=2)
    z = np.linspace(2.5, 5.5, 16, dtype=np.float32)
    pts = (ro[:, None] + z[None, :, None] * rd[:, None]).reshape(-1, 3)
    dirs = np.repeat(rd / np.linalg.norm(rd, axis=1, keepdims=True), 16, 0)
    x_pts = positional_encoding(torch.from_numpy(pts), 10).to(torch.bfloat16).float()
    x_v = positional_encoding(torch.from_numpy(dirs), 4).to(torch.bfloat16).float()
    jc = to_jax(calib)
    w = jquant.unpack_qwrefs(jcfg, jquant.flatten_qpacked(jquant.qpack_nerf_params(jp, jcfg, jc)), jc)
    want = np.asarray(jquant.mlp_forward_affine_q(jcfg, jnp.bfloat16, jax_s_matrix(x_pts.numpy(), x_v.numpy()),
                                                  w, heads=heads))
    got = quant.mlp_plain_q(quant.qpack_nerf(model, calib), model.cfg, x_pts, x_v, sigma_only=heads == "sigma")
    if heads == "sigma":
        want = want[:, 3]
    scale = np.abs(want).max()
    assert scale > 1.0  # a real field
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


# --- the int8 plain versions of the kernels against the JAX int8 kernels ----------------------


def test_k2_int8_plain_matches_pallas_and_keeps_nan(rng):
    jp, jcfg, model, ro, rd, calib = quant_setup(rng, seed=5)
    n, S = ro.shape[0], 16
    depth = np.linspace(2.5, 5.5, n, dtype=np.float32)
    depth[5] = np.nan
    want = jax_fused_around_depth(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(depth[:, None]),
                                  n_samples=S, std=1.0, interpret=True, pe_rotation=False, quant=to_jax(calib))
    args = (model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(depth),
            torch.from_numpy(k289.uniform_population_offsets(S, 1.0)))
    got = k289.render_around_depth_plain(quant.qpack_nerf(model, calib), *args)
    assert_maps(got, want)
    # the NaN depth's maps stay NaN, as the bf16 path's, and only there
    bf16 = k289.render_around_depth_plain(k289.pack_nerf(model), *args)
    for name in MAPS:
        np.testing.assert_array_equal(torch.isnan(got[name]).numpy(), torch.isnan(bf16[name]).numpy())
        assert torch.isnan(got[name][5]).all() and not torch.isnan(got[name][6]).any()
    # non-vacuous: int8 is not the bf16 render
    assert float((got["rgb_map"] - bf16["rgb_map"]).abs().nan_to_num().max()) > 1e-4


@pytest.mark.parametrize("lindisp", [False, True])
def test_k8_int8_plain_matches_pallas(rng, lindisp):
    jp, jcfg, model, ro, rd, calib = quant_setup(rng, seed=9)
    want = jax_fused_render(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), n_samples=16, lindisp=lindisp,
                            interpret=True, pe_rotation=False, quant=to_jax(calib))
    got = k289.render_linspace_plain(quant.qpack_nerf(model, calib), model.cfg, torch.from_numpy(ro),
                                     torch.from_numpy(rd), n_samples=16, lindisp=lindisp)
    assert_maps(got, want, ("rgb_map", "acc_map", "depth_map"))


@pytest.mark.parametrize("assume_sorted", [True, False])
def test_k9_int8_plain_matches_pallas(rng, assume_sorted):
    jp, jcfg, model, ro, rd, calib = quant_setup(rng, seed=2)
    n, S = ro.shape[0], 12
    z = np.sort((4.0 + 0.5 * rng.standard_normal((n, S))).astype(np.float32), -1)
    if not assume_sorted:
        z = np.take_along_axis(z, rng.permuted(np.tile(np.arange(S), (n, 1)), axis=1), 1)
    want = jax_fused_shade(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), interpret=True,
                           assume_sorted=assume_sorted, quant=to_jax(calib))
    got = k289.fused_shade(quant.qpack_nerf(model, calib), model.cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                           torch.from_numpy(z), assume_sorted=assume_sorted)
    assert_maps(got, want, ("rgb_map", "acc_map", "depth_map"))


def test_k3_int8_plain_with_injected_noise_matches_pallas(rng):
    """K3's gaussian population from injected noise, shaded in int8: JAX's
    int8 fused_shade on the same sorted population (its CPU gaussian path)."""
    jp, jcfg, model, ro, rd, calib = quant_setup(rng, seed=6)
    n, S, std = ro.shape[0], 16, 0.7
    depth = torch.from_numpy(np.linspace(2.5, 5.5, n, dtype=np.float32))
    noise = torch.from_numpy(rng.standard_normal((n, S - 1)).astype(np.float32))
    z = k289.gaussian_population(depth, noise, std)
    want = jax_fused_shade(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z.numpy()), interpret=True,
                           quant=to_jax(calib))
    qp = quant.qpack_nerf(model, calib)
    got = k289.render_gaussian_plain(qp, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), depth, noise,
                                     std=std)
    assert_maps(got, want, ("rgb_map", "acc_map", "depth_map"))
    # the CPU wrapper with a seed is the plain version on the Philox draws
    before = build.launches.copy()
    wrapped = k289.fused_render_gaussian(qp, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), depth, seed=4,
                                         n_samples=S, std=std)
    plain = k289.render_gaussian_plain(qp, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), depth,
                                       philox.gaussian_noise(4, n, S - 1), std=std)
    for name in wrapped:
        torch.testing.assert_close(wrapped[name], plain[name], rtol=0, atol=0)
    assert build.launches == before


def hier_setup(rng):
    jc, jcfg, coarse, ro, rd, qc = quant_setup(rng, seed=9)
    jf, _, fine = nerf_pair(5)
    qf = calibrate(fine, ro, rd)
    return jc, jf, jcfg, coarse, fine, ro, rd, (qc, qf)


def test_k7_int8_plain_matches_pallas(rng):
    jc, jf, jcfg, coarse, fine, ro, rd, calib = hier_setup(rng)
    want = jax_fused_hier(jc, jcfg, jf, jcfg, jnp.asarray(ro), jnp.asarray(rd), n_coarse=8, n_importance=16,
                          interpret=True, quant=tuple(map(to_jax, calib)))
    before = build.launches.copy()
    got = k67.fused_render_hier(k67.qpack_hier(coarse, fine, calib), coarse.cfg, fine.cfg, torch.from_numpy(ro),
                                torch.from_numpy(rd), seed=None, n_coarse=8, n_importance=16)
    assert build.launches == before  # CPU tensors launch nothing
    # the depth and the argmax not: a flip that moves a fine sample moves them by its spacing
    assert_maps(got, want, ("rgb_map", "acc_map"), HIER_MEAN_TOL)
    assert float(np.median(np.abs(got["max_z"].numpy() - np.asarray(want["max_z"])))) < (6.0 - 2.0) / 8


def test_k6_int8_wrapper_is_its_plain_version_with_draws(rng):
    """K6 in int8 (the depth-net oracle) on CPU tensors: the plain version
    on the Philox draws of its seed, bit for bit; injected draws likewise;
    and close to the bf16 pass (JAX's test_int8_hier_close_to_bf16 bounds)."""
    _, _, _, coarse, fine, ro, rd, calib = hier_setup(rng)
    n, NC, NF = ro.shape[0], 8, 16
    qp = k67.qpack_hier(coarse, fine, calib)
    args = (coarse.cfg, fine.cfg, torch.from_numpy(ro), torch.from_numpy(rd))
    got = k67.render_hier_kernel(qp, *args, n_coarse=NC, n_importance=NF, seed=9)
    draws = philox.hier_draws(9, n, NC + NF)
    want = k67.render_hier_plain(qp, *args, n_coarse=NC, n_importance=NF, t_rand=draws[:, :NC], u=draws[:, NC:])
    for name in k67.HIER_OUTPUTS:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    injected = k67.render_hier_kernel(qp, *args, n_coarse=NC, n_importance=NF, draws=draws)
    torch.testing.assert_close(injected["max_z"], want["max_z"], rtol=0, atol=0)
    bf16 = k67.render_hier_kernel(k67.pack_hier(coarse, fine), *args, n_coarse=NC, n_importance=NF, seed=9)
    for name in ("rgb_map", "acc_map"):
        assert float((got[name] - bf16[name]).abs().mean()) < 0.04, name
    assert float((got["max_z"] - bf16["max_z"]).abs().median()) < (6.0 - 2.0) / NC


def test_int8_wrappers_check_their_packs(rng):
    _, _, model, ro, rd, calib = quant_setup(rng, seed=9)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    qp = quant.qpack_nerf(model, calib)
    with pytest.raises(TypeError, match="default dtype"):
        k289.fused_render(qp, model.cfg, ro, rd, n_samples=8, dtype=torch.float32)
    with pytest.raises(TypeError, match="both be int8"):
        k67.render_hier_kernel({"coarse": k67.pack_hier(model, model)["coarse"], "fine": qp}, model.cfg,
                               model.cfg, ro, rd, n_coarse=8, n_importance=8)
    bad = dict(qp, feature_bz=qp["feature_bz"].float())
    with pytest.raises(TypeError, match="qpack_nerf"):
        k289.fused_render(bad, model.cfg, ro, rd, n_samples=8)
    with pytest.raises(ValueError, match="architecture"):
        quant.qpack_nerf(NeRF(NeRFConfig(**{**KW, "skips": (2,)})), calib)
    plan = quant.quant_plan(qp, KW["D"])
    assert plan.dtype == np.int32 and plan.shape == (1 + 4 * 7 + 3,)
    assert plan[0].view(np.float32) == np.float32(1.0 / calib.sh0)
    assert plan[1 + 4 * 4 + 3].view(np.float32) == np.float32(calib.steps[4][1])  # the skip layer
    assert tuple(plan[1:4]) == calib.steps[0][1:] and tuple(plan[-3:]) == calib.feat[1:]


# --- the engine, the Trainer and the CLIs -----------------------------------------------------


def engine_setup(**kw):
    """JAX's TestEngineInt8 fields (tests/test_render_engine.py's tiny
    pipeline: 3x32 NeRFs with a skip, 8 + 16 samples, a 2x16 DepthNet) in
    both packages, the port's calibration given to both."""
    from tests.test_render_engine import sphere_hitting_rays, tiny_params, tiny_pipeline

    jpipe = tiny_pipeline(mlp_impl="pallas_int8", **kw)
    jparams = tiny_params(jpipe)
    sds = params_from_jax(jax.tree.map(np.asarray, {"coarse": jparams.coarse, "fine": jparams.fine,
                                                    "depth": jparams.depth}))
    def port(cls, c):  # the JAX config's fields but its matmul precision
        return cls(**{k: v for k, v in dataclasses.asdict(c).items() if k != "precision"})

    coarse, fine = NeRF(port(NeRFConfig, jpipe.nerf)), NeRF(port(NeRFConfig, jpipe.fine))
    depth = DepthNet(port(DepthNetConfig, jpipe.depth))
    for m, k in ((coarse, "coarse"), (fine, "fine"), (depth, "depth")):
        m.load_state_dict(sds[k], strict=True)
    tparams = tengine.NeRFParams(coarse, fine, depth.eval())
    fields = {f.name: getattr(jpipe, f.name) for f in dataclasses.fields(tengine.Pipeline)  # the JAX Pipeline
              if f.name not in ("nerf", "fine", "depth", "quant_calib", "matmul_precision")}  # keeps it per net
    tpipe = tengine.Pipeline(nerf=coarse.cfg, fine=fine.cfg, depth=depth.cfg, **fields)
    rays = sphere_hitting_rays(jpipe, n=40)
    ro, rd = np.asarray(rays.rays_o), np.asarray(rays.rays_d)

    class Scene:  # the SceneData surface calibrate_pipeline reads
        hwf = (8, 8, 10.0)
        K = None
        i_train = np.array([0])
        poses = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 4, 4))

    tpipe = calibrate_pipeline(tpipe, tparams, Scene())
    jpipe = dataclasses.replace(jpipe, quant_calib=tuple(map(to_jax, tpipe.quant_calib)))
    return jpipe, jparams, tpipe, tparams, ro, rd, Scene()


@pytest.mark.parametrize("mode", ["DEPTH_NET", "FULL_NERF", "NERF_MAX"])
def test_render_flat_rays_int8_matches_jax(mode):
    jpipe, jparams, tpipe, tparams, ro, rd, _ = engine_setup()
    assert tpipe.mlp_impl == "cuda_int8"
    want = jengine.render_flat_rays(jpipe, jparams, jnp.asarray(ro), jnp.asarray(rd), jax.random.PRNGKey(0),
                                    mode=getattr(jengine.EvalMode, mode))
    got = tengine.render_flat_rays(tpipe, tparams, torch.from_numpy(ro), torch.from_numpy(rd),
                                   mode=getattr(tengine.EvalMode, mode))
    names = ["depth_net_rgb_map", "depth_net_weights"] + (["max_z_vals"] if mode == "NERF_MAX" else [])
    for name in names:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape, name
        assert_close(g, w, name, HIER_MEAN_TOL if mode != "DEPTH_NET" else KERNEL_MEAN_TOL)
    bf16 = tengine.render_flat_rays(dataclasses.replace(tpipe, mlp_impl="cuda"), tparams, torch.from_numpy(ro),
                                    torch.from_numpy(rd), mode=getattr(tengine.EvalMode, mode))
    d = (got["depth_net_rgb_map"] - bf16["depth_net_rgb_map"]).abs()
    assert 0.0 < float(d.mean()) < 0.05  # int8, not bf16, and close to it (JAX's TestEngineInt8 bound)


def test_int8_compare_mode_is_the_fp32_path_and_missing_calib_raises():
    _, _, tpipe, tparams, ro, rd, _ = engine_setup()
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    out = {impl: tengine.render_flat_rays(dataclasses.replace(tpipe, mlp_impl=impl), tparams, ro, rd,
                                          mode=tengine.EvalMode.COMPARE_NERF) for impl in ("cuda", "cuda_int8")}
    for name in out["cuda"]:
        torch.testing.assert_close(out["cuda_int8"][name], out["cuda"][name], rtol=0, atol=0)
    bare = dataclasses.replace(tpipe, quant_calib=None)
    with pytest.raises(ValueError, match="quant_calib"):
        tengine.render_flat_rays(bare, tparams, ro, rd, mode=tengine.EvalMode.FULL_NERF)
    # a pack made once renders what the path packs on its own
    packed = tengine.pack_kernel_weights(tparams, **tengine.eval_packs(tpipe, tengine.EvalMode.FULL_NERF, tparams))
    assert packed.kernels.hier["fine"]["trunk_wq"][0].dtype == torch.int8
    once = tengine.render_flat_rays(tpipe, packed, ro, rd, mode=tengine.EvalMode.FULL_NERF)
    each = tengine.render_flat_rays(tpipe, tparams, ro, rd, mode=tengine.EvalMode.FULL_NERF)
    torch.testing.assert_close(once["depth_net_rgb_map"], each["depth_net_rgb_map"], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["DEPTH_NET", "FULL_NERF"])
def test_packs_of_the_other_type_are_made_anew(mode):
    """A pack is int8 or bf16 by what it holds: the kernel path renders
    cuda_int8 with int8 packs and cuda with bf16 ones, whatever packs it is
    given, and the depth step's K6 branch refuses hier packs of the other
    type."""
    _, _, tpipe, tparams, ro, rd, _ = engine_setup()
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    m = getattr(tengine.EvalMode, mode)
    cuda = dataclasses.replace(tpipe, mlp_impl="cuda")
    packed = {impl: tengine.pack_kernel_weights(tparams, **tengine.eval_packs(p, m, tparams))
              for impl, p in (("cuda", cuda), ("cuda_int8", tpipe))}
    assert quant.is_int8(packed["cuda_int8"].kernels.nerf) and not quant.is_int8(packed["cuda"].kernels.nerf)
    for impl, p in (("cuda", cuda), ("cuda_int8", tpipe)):
        want = tengine.render_flat_rays(p, packed[impl], ro, rd, mode=m)
        other = packed["cuda" if impl == "cuda_int8" else "cuda_int8"]
        got = tengine.render_flat_rays(p, other, ro, rd, mode=m)
        torch.testing.assert_close(got["depth_net_rgb_map"], want["depth_net_rgb_map"], rtol=0, atol=0)
    from nerf_sampling_tpu_torch.train.steps import depth_net_loss

    bf16 = tengine.pack_kernel_weights(tparams, with_hier=True)
    target = torch.zeros_like(ro)
    with pytest.raises(ValueError, match="hier packs"):
        depth_net_loss(tpipe, bf16, tparams.depth, tengine.make_ray_batch(tpipe, ro, rd), target, seed=0)


def test_calibrate_pipeline_uses_the_first_train_view():
    _, _, tpipe, tparams, _, _, scene = engine_setup()
    ro, rd = scene_rays(scene, 512)
    assert ro.shape == (64, 3)  # an 8x8 view has fewer rays than asked for
    kw = dict(near=tpipe.near, far=tpipe.far)
    assert tpipe.quant_calib == (quant.calibrate_nerf_quant(tparams.coarse, ro, rd, **kw),
                                 quant.calibrate_nerf_quant(tparams.fine, ro, rd, **kw))
    plain = dataclasses.replace(tpipe, mlp_impl="cuda", quant_calib=None)
    assert calibrate_pipeline(plain, tparams, scene) is plain


@pytest.mark.parametrize("mode", ["nerf", "joint"])
def test_trainer_int8_needs_a_frozen_nerf(tmp_path, mode):
    """JAX's TestInt8TrainModeGuard: nerf and joint training update the
    NeRF, whose calibration is made once; both raise up front."""
    cfg = tiny_trainer_cfg(tmp_path, train_mode=mode, mlp_impl="pallas_int8")
    with pytest.raises(ValueError, match="frozen NeRF"):
        Trainer(cfg, device="cpu").train(N_iters=3)


def test_trainer_depth_net_int8_calibrates_and_runs_the_int8_oracle(tmp_path, monkeypatch):
    calls = []
    real = quant.mlp_plain_q

    def counting(packed, cfg, x_pts, x_v, sigma_only=False):
        calls.append(sigma_only)
        return real(packed, cfg, x_pts, x_v, sigma_only)

    monkeypatch.setattr(quant, "mlp_plain_q", counting)
    cfg = tiny_trainer_cfg(tmp_path, mlp_impl="pallas_int8", i_testset=2, i_weights=2)
    tr = Trainer(cfg, device="cpu")
    tr.train(N_iters=3)
    p = tr.pipeline
    assert p.mlp_impl == "cuda_int8" and len(p.quant_calib) == 2
    assert p.quant_calib[0] == quant.calibrate_nerf_quant(
        tr.params.coarse, *scene_rays(tr.scene, 512), near=p.near, far=p.far)
    assert quant.is_int8(tr.params.kernels.hier["fine"]) and quant.is_int8(tr.eval_params.kernels.nerf)
    assert not quant.is_int8(tr.eval_params.kernels.depth)  # K1 stays bf16
    # the oracle's coarse (sigma-only) and fine passes, and the eval, ran the int8 chain
    assert True in calls and False in calls
    for f in ("depth_000002.npz", os.path.join("testset_000002", "000.png")):
        assert os.path.exists(os.path.join(tr.expdir, f)), f


def test_cli_int8_flags(tmp_path):
    """run.py takes pallas_int8 (and cuda_int8) for depth_net mode and
    raises the frozen-NeRF guard for --mode nerf."""
    from test_torch_train import tiny_scene

    datadir = tiny_scene(tmp_path)
    with pytest.raises(ValueError, match="frozen NeRF"):
        run.main(["-dp", datadir, "--mode", "nerf", "--mlp_impl", "pallas_int8", "--n_iters", "1",
                  "--basedir", str(tmp_path / "logs"), "--device", "cpu"])
    assert "8.8 dB" in " ".join(run.build_parser().format_help().split())
