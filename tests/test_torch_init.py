"""The port's initial weights against the JAX package's, bit for bit.

``core/prng.py`` draws JAX's threefry2x32 stream in numpy
(``PRNGKey``, ``split``, ``uniform``, ``linear_init``), and the Trainer
initializes its NeRFs and DepthNet from it as the JAX Trainer's
``_init_params`` does (keys 0, 1, 2 of ``split(PRNGKey(seed), 3)``), so a
seed starts the same run in both packages. At seed 0, for one, the JAX
package's coarse NeRF starts with no density anywhere and never trains;
its fine NeRF then learns from samples spread over the whole ray, which
shapes the depth targets a DepthNet is later trained on.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nerf_sampling_tpu.models.common import linear_init as jax_linear_init
from nerf_sampling_tpu.train.trainer import Trainer as JTrainer
from nerf_sampling_tpu.utils.config import TrainerConfig as JTrainerConfig
from nerf_sampling_tpu_torch.core import prng
from nerf_sampling_tpu_torch.train import checkpoint as tckpt
from nerf_sampling_tpu_torch.train.trainer import Trainer
from nerf_sampling_tpu_torch.utils.config import TrainerConfig


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_threefry_stream_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(key))
    keys = jax.random.split(key, 7)
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed), 7), np.asarray(keys))
    for shape, lo, hi in (((5,), 0.0, 1.0), ((63, 256), -0.3, 0.3), ((3, 4, 5), -1.0, 2.0)):
        want = np.asarray(jax.random.uniform(keys[3], shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(prng.uniform(np.asarray(keys[3]), shape, lo, hi), want)
    for n_in, n_out in ((63, 256), (283, 256), (256, 1), (155, 128)):
        want = jax_linear_init(keys[5], n_in, n_out)
        w, b = prng.linear_init(np.asarray(keys[5]), n_in, n_out)
        np.testing.assert_array_equal(w, np.asarray(want["weight"]).T)
        np.testing.assert_array_equal(b, np.asarray(want["bias"]))


def initial_models(mode: str, seed: int, **kw):
    """(port state dicts, JAX state dicts) of each Trainer's models as set
    up for ``mode`` at ``seed``, before any step (no scene, no checkpoint)."""
    cfg = TrainerConfig(train_mode=mode, seed=seed, netdepth=8, netwidth=256, netdepth_fine=8, netwidth_fine=256,
                        n_layers=10, layer_width=256, N_importance=128, mlp_impl="plain", ft_path=None,
                        basedir="/nonexistent", **kw)
    port = Trainer(cfg, device="cpu")
    port.setup_models()
    jt = JTrainer.__new__(JTrainer)
    jt.cfg = JTrainerConfig(**{**dataclasses.asdict(cfg), "mlp_impl": "xla"})
    jt.pipeline = jt.cfg.pipeline(with_depth=mode != "nerf")
    want = tckpt.params_from_jax(jax.tree.map(np.asarray, {k: v for k, v in jt._init_params()._asdict().items()
                                                           if v is not None}))
    got = {k: getattr(port.params, k).state_dict() for k in ("coarse", "fine", "depth")
           if getattr(port.params, k) is not None}
    return got, want


@pytest.mark.parametrize("mode,seed", [("nerf", 0), ("depth_net", 42), ("joint", 0), ("joint", 7)])
def test_trainer_initial_weights_are_jax(mode, seed):
    """The port's Trainer starts from the JAX Trainer's weights for the same
    seed: every tensor of every net equal bit for bit."""
    got, want = initial_models(mode, seed)
    assert set(got) == set(want) == ({"coarse", "fine"} if mode == "nerf" else {"coarse", "fine", "depth"})
    for net in want:
        assert set(got[net]) == set(want[net])
        for name, w in want[net].items():
            torch.testing.assert_close(got[net][name], w.float(), rtol=0, atol=0, msg=f"{net}.{name}")


def test_seed_0_coarse_nerf_starts_without_density():
    """At seed 0 both packages' coarse NeRF has an alpha-head bias of
    -0.0613 (the bound is 1/16) and no positive density in the box [-2, 2]^3;
    the fine NeRF's bias is +0.0252 and its density positive almost everywhere."""
    got, _ = initial_models("nerf", 0)
    assert float(got["coarse"]["alpha_linear.bias"]) == pytest.approx(-0.06132415, abs=1e-7)
    assert float(got["fine"]["alpha_linear.bias"]) == pytest.approx(0.02520370, abs=1e-7)
    from nerf_sampling_tpu_torch.core.encoding import Embedder
    from nerf_sampling_tpu_torch.models import NeRF, NeRFConfig

    g = torch.Generator().manual_seed(0)
    pts = torch.rand(4096, 3, generator=g) * 4 - 2
    dirs = torch.nn.functional.normalize(torch.randn(4096, 3, generator=g), dim=-1)
    x = torch.cat([Embedder(3, 10)(pts), Embedder(3, 4)(dirs)], -1)
    cfg = NeRFConfig(D=8, W=256, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True)
    sigma = {}
    for net in ("coarse", "fine"):
        model = NeRF(cfg)
        model.load_state_dict(got[net])
        with torch.no_grad():
            sigma[net] = model(x)[:, 3]
    assert float(sigma["coarse"].max()) < 0  # relu: no density, so no gradient, ever
    assert float((sigma["fine"] > 0).float().mean()) > 0.9
