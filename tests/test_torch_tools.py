"""The port's logger, plots, profiler window, NaN checks, matmul precision,
ray-data dump and auxiliary losses on CPU, against the JAX package where
it has the same function.

- ``MetricsLogger`` with a stub ``wandb`` module in ``sys.modules`` (what
  goes to wandb) and without one (``metrics.jsonl``, ray plots as PNG and
  pickle), ``log_render`` skipping the kernel paths' map-level outputs.
- ``viz.visualize`` against JAX's plots of the same arrays.
- The profiler window: steps [20, 40) of a tiny run traced, read back by
  ``read_trace``; ``read_trace`` on a hand-made trace.
- ``debug_nans``: a poisoned NeRF weight raises at its layer; a clean run
  passes.
- ``--precision``: the scope sets and restores torch's global state, and
  the steps and plain renders run inside it.
- ``save_rays_data`` round trip; ``core.losses`` and the sampling helpers
  against JAX's.
"""

import dataclasses
import json
import os
import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import camera, small_configs, small_params
from test_torch_train import small_models, tiny_trainer_cfg

from nerf_sampling_tpu.core import losses as jlosses
from nerf_sampling_tpu.core import sampling as jsampling
from nerf_sampling_tpu.train import checkpoint as jckpt
from nerf_sampling_tpu.viz import visualize as jviz
from nerf_sampling_tpu_torch.core import losses as tlosses
from nerf_sampling_tpu_torch.core import sampling as tsampling
from nerf_sampling_tpu_torch.experiments import run
from nerf_sampling_tpu_torch.render import engine as tengine
from nerf_sampling_tpu_torch.render.path import render_path
from nerf_sampling_tpu_torch.train.state import init_nerf_state, nerf_modules
from nerf_sampling_tpu_torch.train.steps import make_nerf_train_step
from nerf_sampling_tpu_torch.train.trainer import Trainer
from nerf_sampling_tpu_torch.utils import precision
from nerf_sampling_tpu_torch.utils.config import TrainerConfig
from nerf_sampling_tpu_torch.utils.logging import MetricsLogger
from nerf_sampling_tpu_torch.utils.profiling import read_trace
from nerf_sampling_tpu_torch.viz import visualize as tviz


def wandb_stub():
    """The wandb calls the logger makes, recorded."""
    wb = types.ModuleType("wandb")
    wb.calls = []

    class Image:
        def __init__(self, obj):
            self.obj = obj

    wb.Image = Image
    wb.init = lambda **kw: wb.calls.append(("init", kw))
    wb.log = lambda data, step=None: wb.calls.append(("log", data, step))
    wb.finish = lambda: wb.calls.append(("finish",))
    return wb


def render_two_poses(tmp_path, logger, mlp_impl: str):
    """render_path of two poses of the small models through ``logger``:
    the plain path (per-sample points) or the kernels' (map-level)."""
    jpipe, tpipe = small_configs()
    _, tparams = small_params(jpipe, tpipe)
    pipe = dataclasses.replace(tpipe, mlp_impl=mlp_impl)
    K, c2w = camera(8, 8)
    render_path(pipe, tparams, [c2w, c2w], (8, 8, float(K[0, 0])), K, device="cpu", verbose=False,
                logger=logger, step=5)


def test_logger_with_a_wandb_stub(tmp_path, monkeypatch):
    wb = wandb_stub()
    monkeypatch.setitem(sys.modules, "wandb", wb)
    logger = MetricsLogger(str(tmp_path), "offline", TrainerConfig(expname="x"))
    assert wb.calls[0][0] == "init" and wb.calls[0][1]["mode"] == "offline"
    assert wb.calls[0][1]["config"]["expname"] == "x"
    logger.log({"loss": 0.25}, 3)
    render_two_poses(tmp_path, logger, "plain")
    logger.close()
    logged = [c for c in wb.calls if c[0] == "log"]
    assert logged[0] == ("log", {"loss": 0.25}, 3)
    keys = [k for _, data, _ in logged[1:] for k in data]
    assert keys == ["render_5/pose_0", "Ray plot 5", "render_5/pose_1", "Ray plot 5"]
    assert logged[1][1]["render_5/pose_0"].obj.shape == (8, 8, 3)
    assert wb.calls[-1] == ("finish",)
    assert not (tmp_path / "ray_plots").exists()  # the plots went to wandb
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["loss"] == 0.25


@pytest.mark.parametrize("mlp_impl", ["plain", "cuda"])
def test_logger_without_wandb_plots_rays(tmp_path, monkeypatch, mlp_impl):
    """No wandb: the ray plots of the plain path go to ray_plots/ as PNG and
    pickle; the kernel path's maps have no per-sample points and no plot."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    logger = MetricsLogger(str(tmp_path), "online")
    render_two_poses(tmp_path, logger, mlp_impl)
    logger.close()
    plots = sorted(os.listdir(tmp_path / "ray_plots")) if (tmp_path / "ray_plots").exists() else []
    if mlp_impl == "plain":
        assert plots == ["rays_000005_000.pkl", "rays_000005_000.png", "rays_000005_001.pkl",
                         "rays_000005_001.png"]
        with open(tmp_path / "ray_plots" / "rays_000005_000.pkl", "rb") as fp:
            assert len(pickle.load(fp).axes) == 1
    else:
        assert plots == []
    off = MetricsLogger(str(tmp_path / "off"), "disabled", enabled=False)
    off.log({"loss": 1.0}, 1)
    off.print_line("Iter: 1")
    off.close()
    assert not (tmp_path / "off").exists()


@pytest.mark.parametrize("fn", ["plot_rays", "plot_points", "visualize_rays_pts", "plot_histogram"])
def test_viz_matches_jax(rng, fn):
    ro = rng.standard_normal((3, 3)).astype(np.float32)
    rd = rng.standard_normal((3, 3)).astype(np.float32)
    pts = rng.standard_normal((3, 4, 3)).astype(np.float32)
    args = {"plot_rays": (ro, rd), "plot_points": (pts,), "visualize_rays_pts": (ro, rd, pts),
            "plot_histogram": (np.abs(pts[..., 0]),)}[fn]
    np.testing.assert_array_equal(tviz.normalize_directions(torch.from_numpy(rd)), jviz.normalize_directions(rd))
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    (tfig, tax), (jfig, jax_) = getattr(tviz, fn)(*args), getattr(jviz, fn)(*args)
    for got, want in zip(tax.lines, jax_.lines, strict=True):
        np.testing.assert_array_equal(np.asarray(got.get_data_3d()), np.asarray(want.get_data_3d()))
    for got, want in zip(tax.collections, jax_.collections, strict=True):
        np.testing.assert_array_equal(np.asarray(got._offsets3d), np.asarray(want._offsets3d))
    for got, want in zip(tax.patches, jax_.patches, strict=True):
        assert got.get_height() == want.get_height()
    assert tax.get_title() == jax_.get_title()
    plt.close(tfig)
    plt.close(jfig)


@pytest.mark.parametrize("n_iters,traced", [(45, 20), (25, 5)])
def test_profile_window_writes_a_trace(tmp_path, n_iters, traced):
    """Steps [20, 40) after the start (all from 20 in a shorter run) are
    traced into profile_dir/trace.json, with the host's Python functions."""
    prof = str(tmp_path / "prof")
    cfg = tiny_trainer_cfg(tmp_path, profile_dir=prof, i_testset=1000, i_weights=1000, i_print=1000)
    Trainer(cfg, device="cpu").train(N_iters=n_iters)
    s = read_trace(os.path.join(prof, "trace.json"))
    assert s["steps"] == traced and s["window_ms"] > 0 and s["kernels"] == {} and s["device_idle"] == 1.0
    names = [n for n, _ in s["host"]]
    assert len(names) == 10 and all(ms > 0 for _, ms in s["host"])
    assert not any(" at 0x" in n for n in names)


def test_read_trace_sums_a_synthetic_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "train_step", "ts": 0, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "train_step", "ts": 150, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "step", "ts": 0, "dur": 90, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "<built-in method mm at 0xabc>", "ts": 10, "dur": 30,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "<built-in method mm at 0xdef>", "ts": 50, "dur": 20,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "step", "ts": 150, "dur": 80, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "outside", "ts": 400, "dur": 5, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "render_hier_kernel", "ts": 20, "dur": 40, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "render_hier_kernel", "ts": 240, "dur": 60, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 500, "dur": 10, "pid": 0, "tid": 7},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = read_trace(str(path), top=5)
    assert s["steps"] == 2 and s["window_ms"] == 0.3 and s["kernel_ms"] == 0.1
    assert s["kernels"] == {"render_hier_kernel": 0.1}
    assert s["device_idle"] == pytest.approx(1 - 0.1 / 0.3)
    assert s["host"] == [("step", 0.12), ("<built-in method mm>", 0.05)]


def poisoned_ft(tmp_path, poison: bool) -> str:
    jparams, _ = small_models()
    if poison:
        w = np.array(jparams.coarse["pts_linears"][1]["weight"])
        w[0, 0] = np.nan
        jparams.coarse["pts_linears"][1]["weight"] = w
    path = str(tmp_path / "ft.npz")
    jckpt.save_checkpoint(path, {"params": jparams._replace(depth=None)}, 0)
    return path


@pytest.mark.parametrize("poison", [True, False])
def test_debug_nans(tmp_path, poison):
    """nerf mode on the plain path with debug_nans: a NaN weight raises at
    the layer whose output it poisons; a clean run trains."""
    cfg = tiny_trainer_cfg(tmp_path, train_mode="nerf", mlp_impl="plain", debug_nans=True,
                           ft_path=poisoned_ft(tmp_path, poison), i_testset=100, i_weights=100)
    tr = Trainer(cfg, device="cpu")
    if poison:
        with pytest.raises(FloatingPointError, match=r"NeRF\.pts_linears\.1 \(Linear\)"):
            tr.train(N_iters=3)
    else:
        tr.train(N_iters=3)
        assert tr.global_step == 2
    torch.randn(2, requires_grad=True).sum().backward()  # the hooks and anomaly mode are gone
    assert not torch.is_anomaly_enabled()


def test_precision_scope_sets_and_restores():
    precision.strict_fp32()
    assert torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32
    for name, torch_name in (("high", "high"), ("default", "medium"), ("highest", "highest")):
        with precision.matmul_precision(name):
            assert torch.get_float32_matmul_precision() == torch_name
            assert torch.backends.cudnn.allow_tf32 == (name != "highest")
        assert torch.get_float32_matmul_precision() == "highest" and not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError, match="matmul_precision"):
        with precision.matmul_precision("bf16"):
            pass
    with pytest.raises(ValueError, match="matmul_precision"):
        TrainerConfig(matmul_precision="fast").pipeline()


def test_precision_reaches_the_steps_and_renders():
    """A plain nerf step and a plain render run at the pipeline's precision
    and leave the global state as it was; the kernels' plain versions
    (oracles) stay strict fp32 inside."""
    precision.strict_fp32()
    _, tparams = small_models()
    seen = []
    hook = tparams.coarse.register_forward_hook(lambda *_: seen.append(torch.get_float32_matmul_precision()))
    kw = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, N_samples=8, N_importance=16,
              n_layers=3, layer_width=32, matmul_precision="high")
    pipe = TrainerConfig(**kw).pipeline(with_depth=False)
    assert pipe.matmul_precision == "high"
    state = init_nerf_state(nerf_modules(tparams.coarse, tparams.fine), 1e-3, 2)
    rng = np.random.default_rng(0)
    ro = torch.zeros(16, 3) + torch.tensor([0.0, 0.0, 4.0])
    rd = torch.from_numpy(rng.standard_normal((16, 3)).astype(np.float32) * 0.1) - torch.tensor([0, 0, 1.0])
    make_nerf_train_step(pipe)(state, (ro, rd, torch.full((16, 3), 0.5)), 0)
    assert seen and set(seen) == {"high"}
    assert torch.get_float32_matmul_precision() == "highest"
    seen.clear()
    tengine.render_flat_rays(pipe, tengine.NeRFParams(tparams.coarse, tparams.fine), ro, rd,
                             mode=tengine.EvalMode.FULL_NERF)
    assert set(seen) == {"high"} and torch.get_float32_matmul_precision() == "highest"
    hook.remove()


def test_cli_precision_flag(tmp_path):
    datadir = str(tmp_path / "scene")
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset

    generate_example_dataset(datadir, H=64, W=64, n_train=2, n_val=1, n_test=1)
    tr = run.main(["-dp", datadir, "--precision", "default", "--n_iters", "1", "--basedir", str(tmp_path / "logs"),
                   "--testskip", "1", "--device", "cpu"])
    assert tr.cfg.matmul_precision == tr.pipeline.matmul_precision == "default"
    assert torch.get_float32_matmul_precision() == "highest"
    assert "TF32" in run.build_parser().format_help()


def test_save_rays_data_round_trip(tmp_path):
    from safetensors.numpy import load_file

    tr = Trainer(tiny_trainer_cfg(tmp_path), device="cpu")
    tr.global_step = 7
    os.makedirs(tr.expdir)
    rng = np.random.default_rng(1)
    data = {"origins": rng.standard_normal((5, 3)), "pts": rng.standard_normal((5, 4, 3)),
            "alpha": rng.random((5, 4))}
    path = tr.save_rays_data(torch.from_numpy(data["origins"]), data["pts"], torch.from_numpy(data["alpha"]))
    assert path == os.path.join(tr.expdir, "e2e_7.safetensors")
    back = load_file(path)
    for k, v in data.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32))


@pytest.mark.parametrize("fn", ["alphas_or_weights_loss", "mean_density_loss", "gaussian_distribution",
                                "gaussian_log_likelihood", "scale_points_with_weights", "scale_to_near_far"])
def test_losses_and_sampling_helpers_match_jax(rng, fn):
    x = rng.random((6, 5)).astype(np.float32)
    m, s = np.float32(0.4), np.float32(0.3)
    ro, rd = rng.standard_normal((6, 3)).astype(np.float32), rng.standard_normal((6, 3)).astype(np.float32)
    if fn in ("alphas_or_weights_loss", "mean_density_loss"):
        args = (x,)
    elif fn.startswith("gaussian"):
        args = (x, m, s)
    elif fn == "scale_points_with_weights":
        args = (x, ro, rd)
    else:
        args = (x, ro, rd, 2.0, 6.0)
    jmod, tmod = (jlosses, tlosses) if hasattr(jlosses, fn) else (jsampling, tsampling)
    want = getattr(jmod, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    got = getattr(tmod, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else torch.tensor(a)
                              if isinstance(a, np.float32) else a for a in args))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert [e.name for e in tlosses.SamplerLossInput] == [e.name for e in jlosses.SamplerLossInput]
