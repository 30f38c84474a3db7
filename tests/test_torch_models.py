"""The port's models, weight converter and checkpoint reader against the JAX package.

JAX parameters go through ``params_from_jax`` into the port's modules
(strict state-dict loads); both forwards then see the same numpy inputs and
agree to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sampling_tpu.models import (
    DepthNetConfig as JDepthNetConfig,
    NeRFConfig as JNeRFConfig,
    depth_net_apply,
    depth_net_init,
    nerf_apply,
    nerf_init_active,
)
from nerf_sampling_tpu.render.engine import NeRFParams as JNeRFParams
from nerf_sampling_tpu.train import checkpoint as jckpt
from nerf_sampling_tpu_torch.models import DepthNet, DepthNetConfig, NeRF, NeRFConfig
from nerf_sampling_tpu_torch.train.checkpoint import (
    load_render_params,
    params_from_jax,
    read_npz_tree,
)
from nerf_sampling_tpu_torch.utils.config import TrainerConfig

CKPT = "evidence/ckpt/example_depth.npz"
TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def rays_np(n, rng, miss=0):
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
    rd[:, 2] = -1.0
    if miss:
        rd[n - miss :] = np.array([1.0, 0.0, 0.0], np.float32)
    return ro, rd


@pytest.mark.parametrize("use_viewdirs,skips", [(True, (4,)), (True, (0,)), (False, (0,))])
def test_nerf_converted_matches(rng, use_viewdirs, skips):
    kw = dict(D=2, W=32, input_ch=63, input_ch_views=27 if use_viewdirs else 0,
              output_ch=4, skips=skips, use_viewdirs=use_viewdirs)
    params = nerf_init_active(jax.random.PRNGKey(3), JNeRFConfig(**kw))
    model = NeRF(NeRFConfig(**kw))
    model.load_state_dict(params_from_jax({"coarse": np_tree(params)})["coarse"], strict=True)
    x = rng.standard_normal((50, 63 + kw["input_ch_views"])).astype(np.float32)
    want = np.asarray(nerf_apply(params, JNeRFConfig(**kw), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_depth_net_converted_matches(rng):
    kw = dict(hidden_sizes=(32, 32, 32), cat_hidden_sizes=(32, 32, 32))
    params = depth_net_init(jax.random.PRNGKey(4), JDepthNetConfig(**kw))
    model = DepthNet(DepthNetConfig(**kw))
    model.load_state_dict(params_from_jax({"depth": np_tree(params)})["depth"], strict=True)
    ro, rd = rays_np(96, rng, miss=4)
    want = np.asarray(depth_net_apply(params, JDepthNetConfig(**kw), jnp.asarray(ro), jnp.asarray(rd)))
    with torch.no_grad():
        got = model(torch.from_numpy(ro), torch.from_numpy(rd)).numpy()
    assert got.shape == (96, 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-4:]).all()
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def _production_trainer_config() -> TrainerConfig:
    cfg = TrainerConfig(N_importance=128)
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    return cfg


def test_npz_reader_matches_jax_loader():
    """Every leaf of the committed fp16 checkpoint, read without jax tree
    utilities, equals what the JAX package's loader restores."""
    from nerf_sampling_tpu.models import nerf_init
    from nerf_sampling_tpu.utils.config import TrainerConfig as JTrainerConfig

    tree, step = read_npz_tree(CKPT)
    jpipe = JTrainerConfig(n_layers=10, layer_width=256, sphere_radius=2).pipeline()
    k = jax.random.PRNGKey(0)
    template = JNeRFParams(
        coarse=nerf_init(k, jpipe.nerf), fine=nerf_init(k, jpipe.fine),
        depth=depth_net_init(k, jpipe.depth),
    )
    jtree, jstep = jckpt.load_checkpoint(CKPT, {"params": template})
    assert step == jstep
    leaves_t = jax.tree_util.tree_leaves_with_path(
        {"params": {"coarse": tree["params"]["coarse"], "fine": tree["params"]["fine"],
                    "depth": tree["params"]["depth"]}}
    )
    leaves_j = dict(jax.tree_util.tree_leaves_with_path(
        {"params": jtree["params"]._asdict()}
    ))
    assert len(leaves_t) == len(leaves_j) == 130
    for path, leaf in leaves_t:
        np.testing.assert_array_equal(leaf, np.asarray(leaves_j[path]))
        assert leaf.dtype == np.float16


def test_committed_checkpoint_depth_net_matches(rng):
    """The committed 10x256 DepthNet, converted, on 256 rays of the scene."""
    tree, _ = read_npz_tree(CKPT)
    pipe = _production_trainer_config().pipeline()
    params = load_render_params(CKPT, pipe, "cpu")
    assert isinstance(params.fine, NeRF) and isinstance(params.depth, DepthNet)
    assert params.depth.cfg.hidden_sizes == (256,) * 10
    ro = np.tile(np.array([[0.3, -0.2, 4.0]], np.float32), (256, 1))
    rd = (rng.standard_normal((256, 3)) * 0.15).astype(np.float32)
    rd[:, 2] = -1.0
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree["params"]["depth"])
    jcfg = JDepthNetConfig(hidden_sizes=(256,) * 10, cat_hidden_sizes=(256,) * 10, sphere_radius=2.0)
    want = np.asarray(depth_net_apply(jparams, jcfg, jnp.asarray(ro), jnp.asarray(rd)))
    with torch.no_grad():
        got = params.depth(torch.from_numpy(ro), torch.from_numpy(rd)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the fine NeRF too, on embedded random inputs
    x = rng.standard_normal((64, 90)).astype(np.float32)
    fparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree["params"]["fine"])
    fcfg = JNeRFConfig(input_ch=63, input_ch_views=27, output_ch=5, use_viewdirs=True)
    with torch.no_grad():
        got = params.fine(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(nerf_apply(fparams, fcfg, jnp.asarray(x))), **TOL)
