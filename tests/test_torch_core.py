"""The port's core functions and data layer against the JAX package on CPU.

Inputs come from numpy and go through both packages; core ops agree to
1e-5, the numpy data layer bit for bit.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sampling_tpu.core import compositing as jc
from nerf_sampling_tpu.core import encoding as je
from nerf_sampling_tpu.core import geometry as jg
from nerf_sampling_tpu.core import metrics as jm
from nerf_sampling_tpu.core import rays as jr
from nerf_sampling_tpu.core import sampling as js
from nerf_sampling_tpu.data import blender as jblender
from nerf_sampling_tpu.data import example as jexample
from nerf_sampling_tpu_torch.core import compositing as tc
from nerf_sampling_tpu_torch.core import encoding as te
from nerf_sampling_tpu_torch.core import geometry as tg
from nerf_sampling_tpu_torch.core import metrics as tm
from nerf_sampling_tpu_torch.core import rays as tr
from nerf_sampling_tpu_torch.core import sampling as ts
from nerf_sampling_tpu_torch.data import blender as tblender
from nerf_sampling_tpu_torch.data import example as texample

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rays_np(n, rng, miss=0):
    """Rays from radius 4 towards the origin; the last ``miss`` rays miss r=2."""
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
    rd[:, 2] = -1.0
    if miss:
        rd[n - miss :] = np.array([1.0, 0.0, 0.0], np.float32)
    return ro, rd


def test_get_rays_matches(rng):
    K = np.array([[30.0, 0, 8.0], [0, 30.0, 6.0], [0, 0, 1]], np.float32)
    c2w = np.asarray(jblender.pose_spherical(30.0, -30.0, 4.0)[:3, :4])
    ro_j, rd_j = jr.get_rays(12, 16, jnp.asarray(K), jnp.asarray(c2w))
    ro_t, rd_t = tr.get_rays(12, 16, K, c2w)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), **TOL)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), **TOL)
    for a, b in zip(tr.get_rays_np(12, 16, K, c2w), jr.get_rays_np(12, 16, K, c2w)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("multires,include_input", [(4, True), (10, True), (10, False), (0, True)])
def test_positional_encoding_matches(rng, multires, include_input):
    x = (rng.standard_normal((37, 3)) * 2).astype(np.float32)
    want = je.positional_encoding(jnp.asarray(x), multires, include_input)
    got = te.positional_encoding(t(x), multires, include_input)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert te.Embedder(3, multires, include_input).out_dim == je.Embedder(3, multires, include_input).out_dim


def test_sphere_intersection_matches_with_misses(rng):
    ro, rd = rays_np(64, rng, miss=5)
    tj, pj = jg.find_intersection_points_with_sphere(jnp.asarray(ro), jnp.asarray(rd), 2.0)
    tt, pt = tg.find_intersection_points_with_sphere(t(ro), t(rd), 2.0)
    np.testing.assert_array_equal(np.isnan(tt.numpy()), np.isnan(np.asarray(tj)))
    assert np.isnan(tt.numpy()[-5:]).all() and not np.isnan(tt.numpy()[:-5]).any()
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), equal_nan=True, **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), equal_nan=True, **TOL)


@pytest.mark.parametrize("mode,n_samples", [("uniform", 16), ("uniform", 2), ("gaussian", 16), ("depth_only", 1)])
def test_sample_points_around_mean_matches(rng, mode, n_samples):
    ro, rd = rays_np(48, rng)
    # means near both ends of [2, 6] so the uniform population is clipped
    mean = np.linspace(2.05, 5.95, 48, dtype=np.float32)[:, None]
    noise = rng.standard_normal((48, n_samples - 1)).astype(np.float32)
    pj, zj = js.sample_points_around_mean(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(mean), n_samples, mode, 1.0,
        noise=jnp.asarray(noise),
    )
    pt, zt = ts.sample_points_around_mean(t(ro), t(rd), t(mean), n_samples, mode, 1.0, noise=t(noise))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    if mode == "uniform":  # linspace(-1, 1, 1) is [-1]: only S > 2 reaches past 6
        assert zt.min() == 2.0 and (n_samples == 2 or zt.max() == 6.0)


def test_sampling_errors():
    z = torch.zeros((2, 1))
    with pytest.raises(ValueError, match="bogus"):
        ts.sample_points_around_mean(z.expand(2, 3), z.expand(2, 3), z, 4, "bogus")
    with pytest.raises(ValueError, match="Generator"):
        ts.sample_points_around_mean(z.expand(2, 3), z.expand(2, 3), z, 4, "gaussian")


def test_uniform_clip_keeps_nan():
    mean = torch.tensor([[float("nan")], [4.0]])
    _, z = ts.sample_points_around_mean(torch.zeros(2, 3), torch.ones(2, 3), mean, 8, "uniform", 1.0)
    assert torch.isnan(z[0]).all() and not torch.isnan(z[1]).any()


@pytest.mark.parametrize("white_bkgd,noise_std", [(True, 0.0), (False, 0.0), (True, 0.5)])
def test_raw2outputs_matches(rng, white_bkgd, noise_std):
    raw = rng.standard_normal((40, 16, 4)).astype(np.float32) * 3
    z = np.sort(rng.uniform(2, 6, (40, 16)).astype(np.float32), -1)
    _, rd = rays_np(40, rng)
    noise = (rng.standard_normal((40, 16)) * noise_std).astype(np.float32)
    want = jc.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd), noise_std,
                          white_bkgd, noise=jnp.asarray(noise))
    got = tc.raw2outputs(t(raw), t(z), t(rd), noise_std, white_bkgd, noise=t(noise))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)


def test_raw2outputs_zero_samples_fallback():
    raw = np.zeros((3, 0, 4), np.float32)
    z = np.zeros((3, 0), np.float32)
    rd = np.ones((3, 3), np.float32)
    want = jc.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd))
    got = tc.raw2outputs(t(raw), t(z), t(rd))
    np.testing.assert_allclose(got.rgb_map.numpy(), np.asarray(want.rgb_map), **TOL)
    np.testing.assert_allclose(got.disp_map.numpy(), np.asarray(want.disp_map), **TOL)


def test_metrics_match(rng):
    a = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    mse_t, mse_j = tm.img2mse(t(a), t(b)), jm.img2mse(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(mse_t), float(mse_j), **TOL)
    np.testing.assert_allclose(float(tm.mse2psnr(mse_t)), float(jm.mse2psnr(mse_j)), **TOL)
    assert tm.psnr_np(a, b) == jm.psnr_np(a, b)
    np.testing.assert_array_equal(tm.to8b(a * 1.2 - 0.1), jm.to8b(a * 1.2 - 0.1))


def test_example_dataset_bit_exact(tmp_path):
    """The generator and loader reproduce the JAX package's scene bit for bit."""
    dj = jexample.generate_example_dataset(str(tmp_path / "j"), H=32, W=32, n_train=3, n_val=2, n_test=2)
    dt = texample.generate_example_dataset(str(tmp_path / "t"), H=32, W=32, n_train=3, n_val=2, n_test=2)
    for split in ("train", "val", "test"):
        with open(os.path.join(dj, f"transforms_{split}.json")) as a, \
                open(os.path.join(dt, f"transforms_{split}.json")) as b:
            assert json.load(a) == json.load(b)
    for half_res in (False, True):
        sj = jblender.load_blender_data(dj, half_res=half_res, testskip=1)
        st = tblender.load_blender_data(dt, half_res=half_res, testskip=1)
        for sd in (sj, st):
            sd.composite_white_background()
        np.testing.assert_array_equal(st.images, sj.images)
        np.testing.assert_array_equal(st.poses, sj.poses)
        np.testing.assert_array_equal(st.render_poses, sj.render_poses)
        assert st.hwf == sj.hwf
        for k in ("i_train", "i_val", "i_test"):
            np.testing.assert_array_equal(getattr(st, k), getattr(sj, k))
        np.testing.assert_array_equal(st.intrinsics(), sj.intrinsics())


@pytest.mark.parametrize("seed", [0, 2])
def test_render_analytic_bit_exact(seed):
    """The analytic ray tracer, before PNG quantization, equals the JAX package's."""
    focal = 0.5 * 64 / np.tan(0.5 * jexample._CAMERA_ANGLE_X)
    for pose in jexample._orbit_poses(3, seed):
        np.testing.assert_array_equal(texample._render_analytic(64, 64, focal, pose),
                                      jexample._render_analytic(64, 64, focal, pose))
