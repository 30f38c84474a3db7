"""The port's render slice against the JAX package on CPU, and its contracts.

``render_image`` DEPTH_NET uniform on the plain path agrees with the JAX
``render_image`` (mlp_impl="xla") to 1e-4 per pixel; the kernel path on CPU
(the kernels' plain versions at bf16) stays within bf16 noise of it.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sampling_tpu.models import depth_net_init, nerf_init_active
from nerf_sampling_tpu.render import engine as jengine
from nerf_sampling_tpu.utils import config as jconfig
from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
from nerf_sampling_tpu_torch.models import DepthNet, NeRF
from nerf_sampling_tpu_torch.render import (
    EvalMode,
    NeRFParams,
    Pipeline,
    pack_kernel_weights,
    render_image,
    render_path,
)
from nerf_sampling_tpu_torch.train.checkpoint import load_render_params, params_from_jax
from nerf_sampling_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_configs(mlp_impl_jax="xla", n_depth_samples=16, distance=0.8):
    """The same small pipeline in both packages: NeRF 2x32, DepthNet 3x32."""
    kw = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, N_importance=0,
              n_layers=3, layer_width=32, sphere_radius=2.0, n_depth_samples=n_depth_samples,
              distance=distance, sampling_mode="uniform")
    jpipe = jconfig.TrainerConfig(mlp_impl=mlp_impl_jax, **kw).pipeline()
    tpipe = tconfig.TrainerConfig(mlp_impl=mlp_impl_jax, **kw).pipeline()
    return jpipe, tpipe


def small_params(jpipe, tpipe):
    jparams = jengine.NeRFParams(
        coarse=nerf_init_active(jax.random.PRNGKey(5), jpipe.nerf),
        depth=depth_net_init(jax.random.PRNGKey(6), jpipe.depth),
    )
    sds = params_from_jax({"coarse": jax.tree.map(np.asarray, jparams.coarse),
                           "depth": jax.tree.map(np.asarray, jparams.depth)})
    coarse, depth = NeRF(tpipe.nerf), DepthNet(tpipe.depth)
    coarse.load_state_dict(sds["coarse"], strict=True)
    depth.load_state_dict(sds["depth"], strict=True)
    return jparams, NeRFParams(coarse=coarse.eval(), depth=depth.eval())


def camera(H=16, W=16):
    focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    from nerf_sampling_tpu_torch.data.blender import pose_spherical

    return K, pose_spherical(40.0, -30.0, 4.0)[:3, :4]


@pytest.mark.parametrize("S,distance", [(16, 0.8), (2, 0.01)])
def test_render_image_plain_matches_jax(S, distance):
    jpipe, tpipe = small_configs(n_depth_samples=S, distance=distance)
    assert tpipe.mlp_impl == "plain"
    jparams, tparams = small_params(jpipe, tpipe)
    K, c2w = camera()
    want = jengine.render_image(jpipe, jparams, 16, 16, jnp.asarray(K), jnp.asarray(c2w),
                                jax.random.PRNGKey(0))
    got = render_image(tpipe, tparams, 16, 16, K, c2w, device="cpu", chunk=100)
    for name in ("depth_net_rgb_map", "depth_net_disp_map", "depth_net_z_vals", "depth_net_weights"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    rgb = got["depth_net_rgb_map"].numpy()
    assert rgb.std() > 0.01  # the active field renders more than white


def test_render_image_kernel_path_on_cpu():
    jpipe, tpipe = small_configs()
    _, tparams = small_params(jpipe, tpipe)
    kpipe = dataclasses.replace(tpipe, mlp_impl="pallas")
    assert kpipe.mlp_impl == "cuda"
    K, c2w = camera()
    plain = render_image(tpipe, tparams, 16, 16, K, c2w, device="cpu")
    fused = render_image(kpipe, tparams, 16, 16, K, c2w, device="cpu")
    assert fused["depth_net_rgb_map"].shape == (16, 16, 3)
    err = (fused["depth_net_rgb_map"] - plain["depth_net_rgb_map"]).abs()
    assert float(err.mean()) < 1e-2, float(err.mean())
    # map-level outputs: acc and the expected depth
    np.testing.assert_allclose(fused["depth_net_weights"].numpy(),
                               plain["depth_net_weights"].sum(-1).numpy(), atol=3e-2)


def test_kernel_path_packs_weights_once():
    """Weights packed once (pack_kernel_weights) render what the kernel path
    packs on its own; load_render_params packs them for mlp_impl="cuda" only."""
    jpipe, tpipe = small_configs()
    _, tparams = small_params(jpipe, tpipe)
    kpipe = dataclasses.replace(tpipe, mlp_impl="cuda")
    packed = pack_kernel_weights(tparams)
    assert tparams.kernels is None and packed.kernels is not None
    assert packed.kernels.nerf["w0"].dtype == torch.bfloat16
    assert packed.kernels.depth["head_b"].dtype == torch.float32
    K, c2w = camera(8, 8)
    once = render_image(kpipe, packed, 8, 8, K, c2w, device="cpu")
    each = render_image(kpipe, tparams, 8, 8, K, c2w, device="cpu")
    for name in once:
        torch.testing.assert_close(once[name], each[name], rtol=0, atol=0, equal_nan=True)
    ckpt = os.path.join(REPO, "evidence", "ckpt", "example_depth.npz")
    tcfg = tconfig.load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    tcfg.n_layers, tcfg.layer_width, tcfg.sphere_radius = 10, 256, 2
    assert load_render_params(ckpt, tcfg.pipeline(), "cpu").kernels is None
    loaded = load_render_params(ckpt, dataclasses.replace(tcfg.pipeline(), mlp_impl="cuda"), "cpu")
    assert loaded.kernels is not None and len(loaded.kernels.depth["cat_w"]) == 9


def test_reference_psnr_matches_port_on_its_own_scene(tmp_path):
    """reference_psnr.py (the JAX fp32 number chip_smoke.py gates on) sees the
    port's generated and loaded scene bit for bit, and the port's plain path
    renders the committed checkpoint to the same PSNR, here at 16x16."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import reference_psnr
    from nerf_sampling_tpu_torch.data.blender import load_blender_data
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset

    gts, c2ws, focal = reference_psnr.ground_truth(1, 32)
    generate_example_dataset(str(tmp_path), H=32, W=32, n_train=1, n_val=1)
    scene = load_blender_data(str(tmp_path), half_res=True)
    scene.composite_white_background()
    view = int(scene.i_test[0])
    np.testing.assert_array_equal(gts[0], scene.images[view])
    np.testing.assert_array_equal(c2ws[0], scene.poses[view][:3, :4])
    assert focal == scene.hwf[2]

    tcfg = tconfig.load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    tcfg.n_layers, tcfg.layer_width, tcfg.sphere_radius = 10, 256, 2
    pipe = dataclasses.replace(tcfg.pipeline(with_depth=True), n_depth_samples=64,
                               sampling_mode="uniform", distance=1.0)
    params = load_render_params(reference_psnr.CKPT, pipe, "cpu")
    K = np.array([[focal, 0, 8], [0, focal, 8], [0, 0, 1.0]], np.float32)
    img = render_image(pipe, params, 16, 16, K, c2ws[0], device="cpu")["depth_net_rgb_map"].numpy()
    (want, want_std), = reference_psnr.reference_psnrs(1, 32)
    np.testing.assert_allclose(-10 * np.log10(np.mean((img - gts[0]) ** 2)), want, atol=1e-3)
    np.testing.assert_allclose(img.std(), want_std, atol=1e-5)


def test_mlp_impl_names():
    jpipe, tpipe = small_configs()
    assert dataclasses.replace(tpipe, mlp_impl="xla").mlp_impl == "plain"
    assert dataclasses.replace(tpipe, mlp_impl="cuda").mlp_impl == "cuda"
    # the int8 mode (K10): the JAX name maps onto the port's
    assert dataclasses.replace(tpipe, mlp_impl="pallas_int8").mlp_impl == "cuda_int8"
    assert dataclasses.replace(tpipe, mlp_impl="cuda_int8").mlp_impl == "cuda_int8"
    with pytest.raises(ValueError):
        dataclasses.replace(tpipe, mlp_impl="bogus")


@pytest.mark.parametrize("mode", [EvalMode.FULL_NERF, EvalMode.COMPARE_NERF, EvalMode.NERF_MAX])
@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_unported_modes_raise(mode, impl):
    """The three modes beside DEPTH_NET on the coarse-only pipeline
    (N_importance 0). The plain path renders each as the JAX XLA path does
    (1e-4 per pixel; tests/test_torch_eval_modes.py holds the hierarchical
    ones). The kernel path renders FULL_NERF through K8 (bf16, within bf16
    noise of the plain fp32 render) and raises ValueError for COMPARE_NERF
    and NERF_MAX, whose argmax comes from K7 only: the JAX package drops to
    its composable path there, the port names the envelope instead."""
    jpipe, tpipe = small_configs()
    jparams, tparams = small_params(jpipe, tpipe)
    K, c2w = camera(4, 4)
    pipe = dataclasses.replace(tpipe, mlp_impl=impl)
    if impl == "cuda" and mode != EvalMode.FULL_NERF:
        with pytest.raises(ValueError, match="N_importance > 0"):
            render_image(pipe, tparams, 4, 4, K, c2w, device="cpu", mode=mode)
        return
    out = render_image(pipe, tparams, 4, 4, K, c2w, device="cpu", mode=mode)
    if impl == "cuda":
        plain = render_image(tpipe, tparams, 4, 4, K, c2w, device="cpu", mode=mode)
        err = (out["depth_net_rgb_map"] - plain["depth_net_rgb_map"]).abs()
        assert float(err.mean()) < 1e-2 and float(err.max()) < 5e-2, float(err.max())
        return
    want = jengine.render_image(jpipe, jparams, 4, 4, jnp.asarray(K), jnp.asarray(c2w), jax.random.PRNGKey(0),
                                getattr(jengine.EvalMode, mode.name))
    assert set(out) == set(want)
    for name in out:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-4, err_msg=name)


def test_fused_gaussian_raises_and_plain_gaussian_renders():
    """The gaussian population renders on both paths (K3 on the kernel
    path); the kernel path raises outside K3's envelope and without a
    generator for its seed."""
    jpipe, tpipe = small_configs()
    _, tparams = small_params(jpipe, tpipe)
    K, c2w = camera(4, 4)
    gpipe = dataclasses.replace(tpipe, sampling_mode="gaussian")
    kpipe = dataclasses.replace(gpipe, mlp_impl="cuda")
    with pytest.raises(ValueError, match="Generator"):
        render_image(kpipe, tparams, 4, 4, K, c2w, device="cpu")
    with pytest.raises(ValueError, match="2..512"):
        render_image(dataclasses.replace(kpipe, n_depth_samples=513), tparams, 4, 4, K, c2w,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    for pipe in (gpipe, kpipe):
        out = render_image(pipe, tparams, 4, 4, K, c2w, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(out["depth_net_rgb_map"]).all()


def test_render_path_writes_pngs_and_psnr(tmp_path):
    jpipe, tpipe = small_configs()
    _, tparams = small_params(jpipe, tpipe)
    K, c2w = camera(8, 8)
    poses = [np.asarray(c2w), np.asarray(camera(8, 8)[1])]
    gts = np.full((2, 8, 8, 3), 0.8, np.float32)
    rgbs, disps, avg = render_path(tpipe, tparams, poses, (8, 8, float(K[0, 0])), K, device="cpu",
                                   gt_imgs=gts, savedir=str(tmp_path), verbose=False)
    assert rgbs.shape == (2, 8, 8, 3) and disps.shape == (2, 8, 8)
    want = np.mean([-10 * np.log10(np.mean((r - g) ** 2)) for r, g in zip(rgbs, gts)])
    np.testing.assert_allclose(avg, want, rtol=1e-6)
    assert sorted(os.listdir(tmp_path)) == ["000.png", "001.png", "psnr.txt"]
    lines = (tmp_path / "psnr.txt").read_text().splitlines()
    assert lines[0].startswith("000.png, PSNR: ") and lines[2] == "Avg of 2 images:"


def test_trainer_config_matches_jax():
    """lego.yaml's production module loads to the same fields in both packages."""
    jcfg = jconfig.load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    tcfg = tconfig.load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert set(jd) == set(td)
    # "xla" is the port's "plain"
    assert {k for k in jd if jd[k] != td[k]} == {"mlp_impl"}
    for cfg in (jcfg, tcfg):  # run.py's hard overrides (reference run.py:101-109)
        cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    tp, jp = tcfg.pipeline(), jcfg.pipeline()
    for f in ("n_depth_samples", "sampling_mode", "distance", "white_bkgd", "near", "far", "netchunk",
              "N_samples", "N_importance", "perturb", "raw_noise_std", "lindisp",
              "bg_depth_loss_weight"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.depth.hidden_sizes == jp.depth.hidden_sizes
    assert (tp.nerf.input_ch, tp.nerf.input_ch_views) == (jp.nerf.input_ch, jp.nerf.input_ch_views)
    d = {"a": 1}
    tconfig.override_config(d, {"a": 2})
    assert d == {"a": 2}
    with pytest.raises(KeyError):
        tconfig.override_config(d, {"b": 1})


def test_port_imports_no_jax():
    """Every module of the port imports without jax or the JAX package,
    the training slices (train/*, experiments/run.py, K4/K5), the render
    CLI and video writer, and the legacy, study and plot entry points, the
    plots, the losses, the pose math, the four loaders and the data-parallel
    package (parallel/) included."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerf_sampling_tpu_torch as p\n"
        "import nerf_sampling_tpu_torch.render.engine\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['train.trainer', 'train.steps', 'train.sampler', 'train.state', 'train.checkpoint',\n"
        "        'experiments.run', 'kernels.fused_hier', 'kernels.philox', 'utils.logging',\n"
        "        'utils.profiling', 'kernels.fused_nerf', 'kernels.fused_nerf_vjp', 'experiments.render',\n"
        "        'utils.video', 'kernels.quant', 'render.quantize', 'utils.precision', 'viz.visualize',\n"
        "        'experiments.legacy_run', 'experiments.study', 'experiments.plot', 'core.losses',\n"
        "        'core.poses', 'data.llff', 'data.linemod', 'data.deepvoxels', 'data.example',\n"
        "        'parallel.mesh', 'parallel.ops', 'parallel.render']\n"
        "missing = [m for m in need if 'nerf_sampling_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'nerf_sampling_tpu.')) or k == 'nerf_sampling_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
