"""The kernels' plain versions against the JAX Pallas kernels on CPU.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them; the port's plain versions in fp32 agree with them to 1e-4. The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds each of
them to its plain version there. On CPU tensors the wrappers run the plain
version at bf16 and launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sampling_tpu.kernels.fused_depth_net import fused_depth_net_apply as jax_fused_depth_net
from nerf_sampling_tpu.kernels.fused_render import (
    fused_render_around_depth as jax_fused_around_depth,
    uniform_population_offsets as jax_offsets,
)
from nerf_sampling_tpu.models import (
    DepthNetConfig as JDepthNetConfig,
    NeRFConfig as JNeRFConfig,
    depth_net_init,
    nerf_init_active,
)
from nerf_sampling_tpu_torch.core.compositing import raw2outputs
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.core.sampling import sample_points_around_mean
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
from nerf_sampling_tpu_torch.kernels import fused_render as k2
from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.train.checkpoint import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def rays_np(n, rng, miss=0):
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    rd[:, 2] = -1.0
    if miss:
        rd[n - miss :] = np.array([1.0, 0.0, 0.0], np.float32)
    return ro, rd


def depth_pair(seed=0, width=32, layers=3):
    kw = dict(hidden_sizes=(width,) * layers, cat_hidden_sizes=(width,) * layers)
    params = depth_net_init(jax.random.PRNGKey(seed), JDepthNetConfig(**kw))
    model = DepthNet(DepthNetConfig(**kw))
    model.load_state_dict(params_from_jax({"depth": jax.tree.map(np.asarray, params)})["depth"])
    return params, JDepthNetConfig(**kw), model


def nerf_pair(seed=0, D=2, skips=(4,)):
    kw = dict(D=D, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=skips, use_viewdirs=True)
    params = nerf_init_active(jax.random.PRNGKey(seed), JNeRFConfig(**kw))
    model = NeRF(NeRFConfig(**kw))
    model.load_state_dict(params_from_jax({"coarse": jax.tree.map(np.asarray, params)})["coarse"])
    return params, JNeRFConfig(**kw), model


@pytest.mark.parametrize("n", [64, 200])
def test_depth_net_plain_matches_pallas_f32(rng, n):
    params, jcfg, model = depth_pair(0)
    ro, rd = rays_np(n, rng, miss=3)
    want = np.asarray(jax_fused_depth_net(
        params, jcfg, jnp.asarray(ro), jnp.asarray(rd), dtype=jnp.float32, interpret=True
    ))[:, 0]
    A, B = k1.depth_net_inputs(model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), torch.float32)
    got = k1.depth_net_plain(k1.pack_depth_net(model, torch.float32), model.cfg, A, B, torch.float32)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want[-3:]).all()
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **TOL)
    # and the unfused module, to the same tolerance
    with torch.no_grad():
        np.testing.assert_allclose(
            model(torch.from_numpy(ro), torch.from_numpy(rd))[:, 0].numpy(), got.numpy(),
            equal_nan=True, **TOL,
        )


def test_depth_net_wrapper_on_cpu_is_plain_bf16(rng):
    params, jcfg, model = depth_pair(1)
    ro, rd = rays_np(96, rng, miss=2)
    before = build.launches.copy()
    got = k1.fused_depth_net_apply(k1.pack_depth_net(model), model.cfg, torch.from_numpy(ro),
                                   torch.from_numpy(rd))
    assert build.launches == before  # a CPU tensor launches nothing
    A, B = k1.depth_net_inputs(model.cfg, torch.from_numpy(ro), torch.from_numpy(rd))
    plain = k1.depth_net_plain(k1.pack_depth_net(model), model.cfg, A, B, torch.bfloat16)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    # bf16 rounding moves the depth by a small fraction of [near, far]
    want = np.asarray(jax_fused_depth_net(
        params, jcfg, jnp.asarray(ro), jnp.asarray(rd), dtype=jnp.bfloat16, interpret=True
    ))[:, 0]
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.nanmean(np.abs(got.numpy() - want)) < 2e-2


def test_depth_net_wrapper_checks_inputs():
    _, _, model = depth_pair(0)
    packed = k1.pack_depth_net(model)
    with pytest.raises(TypeError):
        k1.depth_net_kernel(packed, model.cfg, torch.zeros(4, 128), torch.zeros(4, 128))
    with pytest.raises(ValueError):
        z = torch.zeros(4, 64, dtype=torch.bfloat16)
        k1.depth_net_kernel(packed, model.cfg, z, z)


def test_depth_net_wrapper_rejects_fp32_packed_weights():
    """fp32 weights would be read as bf16 bytes by the kernel: the wrapper
    refuses them before it picks a device."""
    _, _, model = depth_pair(0)
    z = torch.zeros(4, 128, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 matrices and fp32 biases"):
        k1.depth_net_kernel(k1.pack_depth_net(model, torch.float32), model.cfg, z, z)
    packed = k1.pack_depth_net(model)
    packed["o"]["b"][0] = packed["o"]["b"][0].to(torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 matrices and fp32 biases"):
        k1.depth_net_kernel(packed, model.cfg, z, z)


@pytest.mark.parametrize("S", [2, 16])
@pytest.mark.parametrize("D,skips", [(2, (4,)), (3, (0,))])
def test_render_around_depth_plain_matches_pallas_f32(rng, S, D, skips):
    params, jcfg, model = nerf_pair(2, D, skips)
    n = 128
    ro, rd = rays_np(n, rng)
    # depths near both bounds so the population is clipped, and one NaN ray
    depth = np.linspace(2.05, 5.95, n, dtype=np.float32)
    depth[5] = np.nan
    want = jax_fused_around_depth(
        params, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(depth[:, None]),
        n_samples=S, std=1.0, dtype=jnp.float32, interpret=True, pe_rotation=False,
    )
    offsets = torch.from_numpy(k2.uniform_population_offsets(S, 1.0))
    np.testing.assert_array_equal(offsets.numpy(), jax_offsets(S, 1.0)[:, 0])
    got = k2.render_around_depth_plain(
        k2.pack_nerf(model, torch.float32), model.cfg, torch.from_numpy(ro),
        torch.from_numpy(rd), torch.from_numpy(depth), offsets, dtype=torch.float32,
    )
    for name in ("rgb_map", "acc_map", "depth_map", "disp_map"):
        g, w = got[name].numpy(), np.asarray(want[name])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        assert np.isnan(g[5]).all(), name
        np.testing.assert_allclose(g, w, equal_nan=True, err_msg=name, **TOL)


def test_render_around_depth_plain_matches_composable(rng):
    """The fused plain version equals the composable path: populate -> NeRF -> raw2outputs."""
    _, _, model = nerf_pair(3, 3, (0,))
    n, S = 64, 16
    ro, rd = (torch.from_numpy(a) for a in rays_np(n, rng))
    depth = torch.from_numpy(np.linspace(2.5, 5.5, n, dtype=np.float32))
    got = k2.render_around_depth_plain(
        k2.pack_nerf(model, torch.float32), model.cfg, ro, rd, depth,
        torch.from_numpy(k2.uniform_population_offsets(S, 0.7)), dtype=torch.float32,
    )
    pts, z = sample_points_around_mean(ro, rd, depth[:, None], S, "uniform", 0.7)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    emb = torch.cat([positional_encoding(pts, 10),
                     positional_encoding(vd, 4)[:, None, :].expand(n, S, 27)], -1)
    with torch.no_grad():
        want = raw2outputs(model(emb), z, rd, 0.0, True)
    for name in ("rgb_map", "acc_map", "depth_map", "disp_map"):
        np.testing.assert_allclose(got[name].numpy(), getattr(want, name).numpy(), err_msg=name, **TOL)


def test_render_around_depth_wrapper_on_cpu_is_plain_bf16(rng):
    params, jcfg, model = nerf_pair(4, 3, (0,))
    n, S = 96, 16
    ro, rd = rays_np(n, rng)
    depth = np.linspace(2.5, 5.5, n, dtype=np.float32)
    args = (torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(depth))
    before = build.launches.copy()
    got = k2.fused_render_around_depth(k2.pack_nerf(model), model.cfg, *args, n_samples=S, std=1.0)
    assert build.launches == before
    plain = k2.render_around_depth_plain(
        k2.pack_nerf(model), model.cfg, *args,
        torch.from_numpy(k2.uniform_population_offsets(S, 1.0)), dtype=torch.bfloat16,
    )
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), plain[name].numpy())
    want = jax_fused_around_depth(
        params, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(depth[:, None]),
        n_samples=S, std=1.0, interpret=True, pe_rotation=False,
    )
    assert float(np.abs(got["rgb_map"].numpy() - np.asarray(want["rgb_map"])).mean()) < 1e-2


def test_render_around_depth_wrapper_checks_inputs():
    _, _, model = nerf_pair(0)
    packed = k2.pack_nerf(model)
    ro = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="n_samples"):
        k2.render_around_depth_kernel(packed, model.cfg, ro, ro, torch.zeros(4), torch.zeros(513))
    with pytest.raises(TypeError):
        k2.render_around_depth_kernel(packed, model.cfg, ro.double(), ro, torch.zeros(4), torch.zeros(8))


def test_render_around_depth_wrapper_rejects_fp32_packed_weights():
    _, _, model = nerf_pair(0)
    ro = torch.zeros(4, 3)
    with pytest.raises(TypeError, match="bf16 matrices and fp32 biases"):
        k2.render_around_depth_kernel(k2.pack_nerf(model, torch.float32), model.cfg, ro, ro,
                                      torch.zeros(4), torch.zeros(8))
    packed = k2.pack_nerf(model)
    packed["rgb_b"] = packed["rgb_b"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 matrices and fp32 biases"):
        k2.render_around_depth_kernel(packed, model.cfg, ro, ro, torch.zeros(4), torch.zeros(8))
