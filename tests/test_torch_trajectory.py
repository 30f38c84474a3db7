"""Both Trainers in lockstep over whole short runs: the port's and the JAX
package's, from the same initial weights (the port draws the JAX Trainer's
for the seed, ``core/prng.py``) and with the same draws at every step
(``scripts/torch_parity_runs.py``'s ``lockstep``: every port step takes the
JAX step's draws), with no re-sync between steps.

Four cases at tiny widths (2x32 NeRFs, a 3x32 DepthNet, N_rand 64, 8 + 8
samples, a 32x32 scene; the NDC case a 24x32 forward-facing one), each 40
steps with evals at steps 20 and 40 (the first a ``keep_best`` save):
``nerf`` from scratch, ``depth_net`` against the NeRF the JAX side of the
nerf case wrote, ``joint`` from scratch across a 10-step warmup, and
``depth_net`` under NDC against a JAX-initialized NeRF the JAX package
wrote. Each case holds the loss at every step, each net's final weights
and each eval to the bounds below, stated beside what they rest on.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("torch_parity_runs",
                                               os.path.join(REPO, "scripts", "torch_parity_runs.py"))
parity = sys.modules["torch_parity_runs"] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(parity)

from nerf_sampling_tpu.models import NeRFConfig as JNeRFConfig  # noqa: E402
from nerf_sampling_tpu.models import nerf_init_active  # noqa: E402
from nerf_sampling_tpu.render.engine import NeRFParams as JNeRFParams  # noqa: E402
from nerf_sampling_tpu.train import checkpoint as jckpt  # noqa: E402
from nerf_sampling_tpu_torch.data.example import generate_example_dataset, generate_example_llff_dataset  # noqa: E402

STEPS, EVERY = 40, 20
TINY = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, n_layers=3, layer_width=32,
            sphere_radius=2.0, N_samples=8, N_importance=8, N_rand=64, n_depth_samples=16,
            sampling_mode="uniform", distance=1.0, i_print=10, i_weights=STEPS, i_testset=EVERY,
            i_video=10**6, keep_best=True, export_torch_ckpt=False, lrate=5e-4, lrate_decay=250,
            depth_net_lr=1e-4, seed=3, matmul_precision="highest", testskip=1)
# Bounds, from the cases as measured on the CPU (jax 0.9 and torch 2.13, both
# on the CPU). The two packages round the CDF sums, the sorts' ties and the
# fp32 matmuls in other orders, and Adam turns an element's near-zero
# gradient into a step of +-lr whatever its last digits, so the runs part
# slowly: measured, the largest per-step relative loss difference over the
# four cases was 9.1e-3 (nerf, one step whose loss is small), the final
# weights 9.6e-4 of their norm (nerf fine) and 2.0e-4 (the DepthNet), the
# uniform and FULL_NERF evals 1.8e-4 dB apart. The NDC case's gaussian eval
# population is drawn by each package's own generator: 0.046 and 0.032 dB.
# Each bound is about 3x the measured value or more.
LOSS_RTOL = 3e-2  # per step, relative
WEIGHT_RTOL = {"coarse": 3e-3, "fine": 3e-3, "depth": 1e-2}  # final weights, share of each net's norm
EVAL_DB = {"nerf": 2e-2, "depth_net": 2e-2, "joint": 2e-2, "ndc_depth_net": 0.15}  # each eval's PSNR


@functools.lru_cache(maxsize=None)
def scenes(root: str) -> dict[str, str]:
    return {"blender": generate_example_dataset(os.path.join(root, "blender"), H=32, W=32, n_train=20, n_val=1,
                                                n_test=2),
            "llff": generate_example_llff_dataset(os.path.join(root, "llff"), H=24, W=32, n_images=9)}


def jax_active_nerf(path: str) -> str:
    """Active 2x32 coarse and fine NeRFs, as the JAX package initializes and writes them."""
    cfg = JNeRFConfig(D=2, W=32, input_ch=63, input_ch_views=27, output_ch=5, skips=(4,), use_viewdirs=True)
    params = JNeRFParams(nerf_init_active(jax.random.PRNGKey(7), cfg), nerf_init_active(jax.random.PRNGKey(8), cfg),
                         None)
    jckpt.save_checkpoint(path, {"params": params}, 0)
    return path


@functools.lru_cache(maxsize=None)
def run_case(root: str, case: str) -> dict:
    sc = scenes(root)
    blender = dict(TINY, dataset_type="blender", datadir=sc["blender"], half_res=False, white_bkgd=True,
                   no_batching=True, bg_depth_loss_weight=0.0)
    kw = {
        "nerf": dict(blender, train_mode="nerf"),
        "depth_net": dict(blender, train_mode="depth_net"),
        "joint": dict(blender, train_mode="joint", joint_depth_warmup=10),
        "ndc_depth_net": dict(TINY, dataset_type="llff", datadir=sc["llff"], factor=1, llffhold=4, white_bkgd=False,
                              train_mode="depth_net", sampling_mode="gaussian", distance=0.25),
    }[case]
    kw.update(basedir=os.path.join(root, case), expname=case)
    if case == "depth_net":  # the NeRF the JAX side of the nerf case wrote
        run_case(root, "nerf")
        kw["ft_path"] = os.path.join(root, "nerf", "jax", "nerf", f"{STEPS:06d}.npz")
    if case == "ndc_depth_net":
        kw["ft_path"] = jax_active_nerf(os.path.join(root, "ndc_nerf.npz"))
    return parity.lockstep(kw, STEPS, every=EVERY, warmup=kw.get("joint_depth_warmup", 0))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("trajectory"))


@pytest.mark.parametrize("case", ["nerf", "depth_net", "joint", "ndc_depth_net"])
def test_trainers_in_lockstep(root, case):
    out = run_case(root, case)
    assert out["steps"] == STEPS
    assert out["loss_rel_max"] <= LOSS_RTOL, (out["first_loss_departure"], out["loss_rel_max"])
    final = out["weights_rel_final"]
    assert set(final) == set(parity.NETS["nerf" if case == "nerf" else "joint" if case == "joint" else "depth_net"])
    for net, rel in final.items():
        assert rel <= WEIGHT_RTOL[net], (net, rel)
    assert sorted(out["evals"]) == [EVERY, STEPS]
    for i, e in out["evals"].items():
        assert np.isfinite(e["port"]) and abs(e["delta"]) <= EVAL_DB[case], (i, e)
    if case == "joint":  # the DepthNet held through the warmup, then trained
        live = [out["port"].metrics[i]["depth_live"] for i in (10, 11)]
        assert live == [0.0, 1.0]
    for tag in ("port", "jax"):  # the first eval is a keep_best save on both sides
        best = os.path.join(root, case, tag, case, "best")
        assert sorted(os.listdir(best))[0].endswith(f"{EVERY:06d}.npz"), (tag, os.listdir(best))
