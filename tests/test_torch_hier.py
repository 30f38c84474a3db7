"""The port's hierarchical sampling and K6/K3 plain versions against the JAX package on CPU.

- ``stratified_z_vals`` and ``sample_pdf`` with the same injected draws: 1e-6.
- ``render_hier_plain`` in det mode (fp32) against the JAX Pallas kernel
  ``fused_render_hier`` in interpret mode, as the JAX package's own tests
  run it: rgb, max_z and max_w at 3e-4 (that test's tolerance).
- ``render_hier_plain`` with injected draws (fp32) against the JAX XLA
  composition of the train pass: every map and max_z/max_w/max_rgb at 1e-4.
- ``render_gaussian_plain`` with injected noise against the JAX gaussian
  population and XLA shading: 1e-4.
- The wrappers' contracts, and the Philox stream the kernels share with
  ``kernels/philox.py`` (the Random123 known-answer vectors).

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each of them to its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sampling_tpu.core import compositing as jcomp
from nerf_sampling_tpu.core import sampling as jsampling
from nerf_sampling_tpu.kernels.fused_hier import fused_render_hier as jax_fused_hier
from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig
from nerf_sampling_tpu.models import nerf_init_active
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu_torch.core.compositing import RenderOutputs
from nerf_sampling_tpu_torch.core.sampling import sample_pdf, stratified_z_vals
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_hier as k6
from nerf_sampling_tpu_torch.kernels import fused_render as k3
from nerf_sampling_tpu_torch.kernels import philox
from nerf_sampling_tpu_torch.models import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.train.checkpoint import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
N_RAYS, NC, NF = 130, 8, 16


def rays_np(n, rng, miss=0):
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
    rd[:, 2] = -1.0
    return ro, rd


def nerf_pair(seed):
    """The same active 2x32 NeRF in both packages."""
    kw = dict(D=2, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True)
    params = nerf_init_active(jax.random.PRNGKey(seed), JNeRFConfig(**kw))
    model = NeRF(NeRFConfig(**kw))
    model.load_state_dict(params_from_jax({"coarse": jax.tree.map(np.asarray, params)})["coarse"])
    return params, JNeRFConfig(**kw), model


def hier_setup(rng, seed=3):
    jc, jcfg, coarse = nerf_pair(seed)
    jf, _, fine = nerf_pair(seed + 1)
    ro, rd = rays_np(N_RAYS, rng)
    return jc, jf, jcfg, coarse, fine, ro, rd


@pytest.mark.parametrize("perturb", [0.0, 1.0])
@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals_matches_jax(rng, perturb, lindisp):
    near = np.full((N_RAYS, 1), 2.0, np.float32)
    far = np.full((N_RAYS, 1), 6.0, np.float32)
    t_rand = rng.random((N_RAYS, NC), dtype=np.float32)
    want = jsampling.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), NC, perturb=perturb,
                                       lindisp=lindisp, t_rand=jnp.asarray(t_rand))
    got = stratified_z_vals(torch.from_numpy(near), torch.from_numpy(far), NC, perturb=perturb,
                            lindisp=lindisp, t_rand=torch.from_numpy(t_rand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_pdf_matches_jax(rng, det, lindisp):
    near = np.full((N_RAYS, 1), 2.0, np.float32)
    far = np.full((N_RAYS, 1), 6.0, np.float32)
    z = np.asarray(jsampling.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), NC + 1,
                                               lindisp=lindisp))
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    weights = rng.random((N_RAYS, NC - 1), dtype=np.float32) ** 3
    weights[:5, 2:4] = 0.0  # empty bins: denominators below 1e-5
    u = None if det else rng.random((N_RAYS, NF), dtype=np.float32)
    want = jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), NF, det=det,
                                u=None if u is None else jnp.asarray(u))
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), NF, det=det,
                     u=None if u is None else torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lindisp,seed,nf", [(False, 7, NF), (True, 11, 8)])
def test_render_hier_plain_det_matches_pallas(rng, lindisp, seed, nf):
    """The fields, rays and sizes of the JAX package's own Pallas-vs-XLA
    hierarchical tests (tests/test_fused_render.py::TestFusedHier)."""
    jc, jf, jcfg, coarse, fine, ro, rd = hier_setup(rng, seed)
    want = jax_fused_hier(jc, jcfg, jf, jcfg, jnp.asarray(ro), jnp.asarray(rd), n_coarse=NC,
                          n_importance=nf, lindisp=lindisp, dtype=jnp.float32, interpret=True)
    got = k6.render_hier_plain(k6.pack_hier(coarse, fine, torch.float32), coarse.cfg, fine.cfg,
                               torch.from_numpy(ro), torch.from_numpy(rd), n_coarse=NC,
                               n_importance=nf, lindisp=lindisp, dtype=torch.float32)
    for name in ("rgb_map", "max_z", "max_w"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=3e-4, atol=3e-4,
                                   err_msg=name)
    assert float(got["acc_map"].max()) > 0.1  # the active field is not empty


def jax_train_pass(jc, jf, jcfg, ro, rd, t_rand, u):
    """The JAX XLA composition of the seeded hierarchical pass, draws injected."""
    p = jengine.Pipeline(nerf=jcfg, fine=jcfg, N_samples=NC, N_importance=NF, mlp_impl="xla")
    rays = jengine.make_ray_batch(p, jnp.asarray(ro), jnp.asarray(rd))
    z_c = jsampling.stratified_z_vals(rays.near, rays.far, NC, perturb=1.0, t_rand=jnp.asarray(t_rand))
    raw_c = jengine.query_nerf(p, jc, jcfg, jsampling.z_to_points(rays.rays_o, rays.rays_d, z_c),
                               rays.viewdirs)
    coarse = jcomp.raw2outputs(raw_c, z_c, rays.rays_d, 0.0, True)
    z_f = jsampling.sample_pdf(0.5 * (z_c[..., 1:] + z_c[..., :-1]), coarse.weights[..., 1:-1], NF,
                               u=jnp.asarray(u))
    z = jnp.sort(jnp.concatenate([z_c, z_f], -1), -1)
    raw = jengine.query_nerf(p, jf, jcfg, jsampling.z_to_points(rays.rays_o, rays.rays_d, z),
                             rays.viewdirs)
    out = jcomp.raw2outputs(raw, z, rays.rays_d, 0.0, True)
    max_z, _, max_w = jengine._argmax_depth(out, z, rays)
    top = jnp.argmax(out.weights, axis=1)
    max_rgb = jax.nn.sigmoid(raw[..., :3])[jnp.arange(raw.shape[0]), top]
    return {"rgb_map": out.rgb_map, "disp_map": out.disp_map, "acc_map": out.acc_map,
            "depth_map": out.depth_map, "max_z": max_z[:, 0], "max_w": max_w[:, 0], "max_rgb": max_rgb}


def test_render_hier_plain_draws_match_jax_xla(rng):
    jc, jf, jcfg, coarse, fine, ro, rd = hier_setup(rng)
    t_rand = rng.random((N_RAYS, NC), dtype=np.float32)
    u = rng.random((N_RAYS, NF), dtype=np.float32)
    want = jax_train_pass(jc, jf, jcfg, ro, rd, t_rand, u)
    got = k6.render_hier_plain(k6.pack_hier(coarse, fine, torch.float32), coarse.cfg, fine.cfg,
                               torch.from_numpy(ro), torch.from_numpy(rd), n_coarse=NC,
                               n_importance=NF, t_rand=torch.from_numpy(t_rand),
                               u=torch.from_numpy(u), dtype=torch.float32)
    assert set(got) == set(k6.HIER_OUTPUTS)
    for name in k6.HIER_OUTPUTS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)


def test_argmax_tie_takes_first_in_sorted_order():
    """Two samples of one ray with the same, largest weight: the port takes
    the first in sorted z order, as the JAX XLA path does. In storage
    (concat) order the fine sample at z=3.0 comes after the coarse one at
    z=4.0, so the TPU kernel's storage-order rule would pick z=4.0."""
    z = np.array([[2.0, 3.0, 4.0, 5.0]], np.float32)  # sorted union
    w = np.array([[0.1, 0.4, 0.4, 0.1]], np.float32)
    ro = np.zeros((1, 3), np.float32)
    rd = np.array([[0.0, 0.0, -1.0]], np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    fine = RenderOutputs(t(w[:, :1]), t(w[:, 0]), t(w[:, 0]), t(w[:, 0]), t(w), t(w), t(w))
    trays = tengine.RayBatch(t(ro), t(rd), None, t(ro[:, :1]), t(ro[:, :1]))
    max_z, _, max_w = tengine._argmax_depth(fine, t(z), trays)
    jfine = jcomp.RenderOutputs(*(jnp.asarray(x.numpy()) for x in fine))
    jrays = jengine.RayBatch(jnp.asarray(ro), jnp.asarray(rd), None, jnp.zeros((1, 1)), jnp.zeros((1, 1)))
    jmax_z, _, _ = jengine._argmax_depth(jfine, jnp.asarray(z), jrays)
    assert max_z.item() == np.asarray(jmax_z).item() == 3.0 and max_w.item() == np.float32(0.4)
    # render_hier_plain and K6 take the same rule (torch.argmax / a strict >
    # scan over the sorted union): the first maximum of the sorted weights
    assert int(torch.argmax(t(w), dim=1)) == 1


def test_render_gaussian_plain_matches_jax(rng):
    jp, jcfg, model = nerf_pair(6)
    n, S, std = 96, 16, 0.7
    ro, rd = rays_np(n, rng)
    depth = np.linspace(2.5, 5.5, n, dtype=np.float32)
    depth[7] = np.nan
    noise = rng.standard_normal((n, S - 1)).astype(np.float32)
    p = jengine.Pipeline(nerf=jcfg, mlp_impl="xla")
    rays = jengine.make_ray_batch(p, jnp.asarray(ro), jnp.asarray(rd))
    pts, z = jsampling.sample_points_around_mean(rays.rays_o, rays.rays_d, jnp.asarray(depth[:, None]),
                                                 S, "gaussian", std, noise=jnp.asarray(noise))
    raw = jengine.query_nerf(p, jp, jcfg, pts, rays.viewdirs)
    want = jcomp.raw2outputs(raw, z, rays.rays_d, 0.0, True)
    got = k3.render_gaussian_plain(k3.pack_nerf(model, torch.float32), model.cfg, torch.from_numpy(ro),
                                   torch.from_numpy(rd), torch.from_numpy(depth), torch.from_numpy(noise),
                                   std=std, dtype=torch.float32)
    for name in ("rgb_map", "acc_map", "depth_map", "disp_map"):
        g, w = got[name].numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        assert np.isnan(g[7]).all() and not np.isnan(np.delete(g, 7, 0)).any(), name
        np.testing.assert_allclose(g, w, equal_nan=True, err_msg=name, **TOL)


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors, which csrc/philox.cuh
    implements as well; the kernels' draws are uniforms on a 2^-24 grid."""
    zero, ones = np.uint64(0), np.uint64(0xFFFFFFFF)
    pi = [np.uint64(x) for x in (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)]
    for ctr, key, want in (
        ([zero] * 4, [zero] * 2, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ([ones] * 4, [ones] * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (pi, [np.uint64(0xA4093822), np.uint64(0x299F31D0)],
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ):
        assert tuple(int(w) for w in philox.philox4x32_10(ctr, key)) == want
    d = philox.hier_draws(5, 64, 40).numpy()
    assert d.shape == (64, 40) and d.min() >= 0.0 and d.max() < 1.0
    np.testing.assert_array_equal(d * 2**24, np.round(d * 2**24))
    # a ray's draws do not depend on the other rays of the call
    np.testing.assert_array_equal(philox.hier_draws(5, 8, 40, ray0=10).numpy(), d[10:18])
    g = philox.gaussian_noise(5, 4000, 63).numpy()
    assert abs(g.mean()) < 0.01 and abs(g.std() - 1.0) < 0.01


def test_hier_wrapper_on_cpu_is_plain_bf16_with_philox_draws(rng):
    _, _, _, coarse, fine, ro, rd = hier_setup(rng)
    packed = k6.pack_hier(coarse, fine)
    args = (packed, coarse.cfg, fine.cfg, torch.from_numpy(ro), torch.from_numpy(rd))
    before = build.launches.copy()
    got = k6.render_hier_kernel(*args, n_coarse=NC, n_importance=NF, seed=9)
    assert build.launches == before
    draws = philox.hier_draws(9, N_RAYS, NC + NF)
    want = k6.render_hier_plain(*args, n_coarse=NC, n_importance=NF, t_rand=draws[:, :NC],
                                u=draws[:, NC:], dtype=torch.bfloat16)
    for name in k6.HIER_OUTPUTS:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    other = k6.render_hier_kernel(*args, n_coarse=NC, n_importance=NF, seed=10)
    assert not torch.equal(other["max_z"], got["max_z"])


def test_gaussian_wrapper_on_cpu_is_plain_bf16_with_philox_draws(rng):
    _, _, model = nerf_pair(7)
    n, S = 64, 16
    ro, rd = (torch.from_numpy(a) for a in rays_np(n, rng))
    depth = torch.linspace(2.5, 5.5, n)
    before = build.launches.copy()
    got = k3.fused_render_gaussian(k3.pack_nerf(model), model.cfg, ro, rd, depth, seed=4,
                                   n_samples=S, std=0.5)
    assert build.launches == before
    want = k3.render_gaussian_plain(k3.pack_nerf(model), model.cfg, ro, rd, depth,
                                    philox.gaussian_noise(4, n, S - 1), std=0.5)
    for name in got:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_hier_and_gaussian_wrappers_check_inputs(rng):
    _, _, _, coarse, fine, ro, rd = hier_setup(rng)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    packed = k6.pack_hier(coarse, fine)
    with pytest.raises(TypeError, match="bf16 matrices and fp32 biases"):
        k6.render_hier_kernel(k6.pack_hier(coarse, fine, torch.float32), coarse.cfg, fine.cfg, ro, rd,
                              n_coarse=NC, n_importance=NF)
    with pytest.raises(ValueError, match="draws"):
        k6.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro, rd, n_coarse=NC, n_importance=NF,
                              draws=torch.zeros(N_RAYS, NC))
    with pytest.raises(ValueError, match="n_coarse"):
        k6.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro, rd, n_coarse=3, n_importance=NF)
    with pytest.raises(ValueError, match="n_importance"):
        k6.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro, rd, n_coarse=64, n_importance=449)
    with pytest.raises(TypeError):
        k6.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro.double(), rd, n_coarse=NC, n_importance=NF)
    depth = torch.full((N_RAYS,), 4.0)
    with pytest.raises(TypeError, match="bf16 matrices and fp32 biases"):
        k3.render_gaussian_kernel(k3.pack_nerf(fine, torch.float32), fine.cfg, ro, rd, depth,
                                  n_samples=8, std=1.0)
    with pytest.raises(ValueError, match="noise"):
        k3.render_gaussian_kernel(k3.pack_nerf(fine), fine.cfg, ro, rd, depth, n_samples=8, std=1.0,
                                  noise=torch.zeros(N_RAYS, 8))
    with pytest.raises(ValueError, match="n_samples"):
        k3.render_gaussian_kernel(k3.pack_nerf(fine), fine.cfg, ro, rd, depth, n_samples=1, std=1.0)
