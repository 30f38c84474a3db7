"""Drive the PyTorch port's render and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. Device: a CUDA device is required; prints nvidia-smi's name and power limit.
2. Build: compiles the hand-written kernels from ``nerf_sampling_tpu_torch/kernels/csrc``.
3. Kernel vs plain, on the committed checkpoint's weights, each held to
   its plain version at bf16 rounding with the tolerances below:
   K1 (DepthNet) on the 160,000 rays of test view 0 plus 64 rays that miss
   the bounding sphere; K2 (uniform populate-and-shade) and K3 (gaussian)
   on the same 160,000 rays in one launch at S=64, std=1.0, with 16 NaN
   depths spread among them (K3 with injected noise); K6 (the seeded
   hierarchical pass) on 1024-ray train batches with injected draws. K3
   and K6 also: one seed gives the same bits, the next seed others, and
   the mean rgb of the in-kernel draws matches torch draws.
4. The render path: the example scene (generated on first use), the
   production pipeline (lego.yaml's recommended_depth_net_module with
   run.py's overrides, uniform/64/distance 1.0), evidence/ckpt/
   example_depth.npz through the weight converter, the 4 test views with
   ``render_path`` on the kernels (K1 and K2 must launch), view 0 against
   the JAX package's fp32 render of it (REFERENCE_PSNR_VIEW0), the image
   std in evidence/ckpt/expected.json and the port's plain fp32 path; a
   400x400 frame timed on both paths, one kernel-path frame profiled.
5. The training path, through the CLI's main in process: the recipe with
   ``--mlp_impl cuda``, seed 42, a fresh DepthNet against a NeRF-only copy
   of the committed checkpoint, 2500 steps (K6, K1 and K3 must launch);
   the depth-net loss must fall, best/depth_002500.npz must exist, and the
   step-2500 eval must be at most EVAL_GAP_TOL dB below the committed
   DepthNet's under the same eval. Then one step on both paths from one
   state, batch and draws, the median step time on both paths, and one
   profiled kernel-path step with its phases.

The last two lines of standard output are the kernels' JSON record and the
device JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(HERE, "evidence", "ckpt", "expected.json")
CKPT = os.path.join(HERE, "evidence", "ckpt", "example_depth.npz")
OUT_DIR = os.path.join(HERE, "logs", "chip_smoke")  # renders and psnr.txt (gitignored)
TRAIN_DIR = os.path.join(HERE, "logs", "chip_smoke_train")  # the training run (gitignored)
TRAIN_ITERS = EVAL_STEP = 2500  # the recipe's first eval (i_testset) and checkpoint
TRAIN_PRINT = 100  # i_print of the training run

# kernel vs its plain version at bf16 rounding (same inputs, same weights):
# the two differ only in fp32 summation order and the few bf16 roundings
# that order flips
K1_MEAN_TOL, K1_MAX_TOL = 1e-3, 5e-2  # |depth| on rays that hit, depth in [2, 6]
K2_MEAN_TOL, K2_MAX_TOL = 1e-3, 2e-2  # |rgb|, |acc| in [0, 1]; depth and disp scaled by 6
K3_MEAN_RGB_TOL = 1e-3  # in-kernel draws vs torch draws: equal in distribution
# K6 at bf16 rounding on train batches: a flipped bf16 rounding can move a
# fine sample and with it a whole ray, so the tail is held by percentile
K6_MEAN_TOL, K6_P999_TOL = 1e-3, 2e-2  # |rgb|, |acc|
K6_Z_MEAN_TOL, K6_Z_P99_TOL = 2e-3, 2e-2  # |max_z| on rays with acc > 0.5
K6_MEAN_RGB_TOL = 1e-3  # in-kernel draws vs torch draws over 64 batches
PSNR_TOL, STD_TOL, PLAIN_PSNR_TOL = 0.10, 0.003, 0.05
EVAL_GAP_TOL = 0.5  # dB the trained DepthNet may eval below the committed one
# one step, cuda vs plain, same state, batch and draws: img_loss is the same
# fp32 code on both; the depth target comes from bf16 (K6) vs fp32, so the
# bound of tests/test_train_pallas.py:41
STEP_IMG_TOL, STEP_DEPTH_TOL, STEP_COS_TOL = 1e-5, 0.05, 0.99
# View 0 as the JAX package renders it through its own fp32 path
# (mlp_impl="xla") from the committed checkpoint: `python3 reference_psnr.py`
# prints it (33.6077 dB on an NVIDIA H100 80GB HBM3 at 700 W, jax 0.9.0).
# evidence/ckpt/expected.json records 31.17 dB for the same view from a TPU
# v5e run of the JAX package; its fp32 path on the H100 does not reproduce
# that, and the cause is not known (PERF.md, Open questions). The recorded
# image std (0.4181) is reproduced and stays a gate.
REFERENCE_PSNR_VIEW0 = 33.6077


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frame_ms(fn, reps: int) -> float:
    """Median host time in ms of ``fn`` with a synchronize inside the window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    d = (got - want).abs()
    d = d[~torch.isnan(d)]
    return float(d.mean()), float(d.max())


def view0_camera():
    """Test view 0 of the example scene at half resolution (400x400)."""
    from nerf_sampling_tpu_torch.data.example import _CAMERA_ANGLE_X, _orbit_poses

    H = W = 400
    focal = 0.5 * 800 / np.tan(0.5 * _CAMERA_ANGLE_X) / 2.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    return H, W, K, _orbit_poses(4, 2)[0][:3, :4].astype(np.float32)


def load_example_scene():
    """The example scene's views at 400x400 on white (generated at 800x800 on
    first use, as the JAX package's bench does) and their intrinsics K."""
    from nerf_sampling_tpu_torch.data.blender import load_blender_data
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset
    from nerf_sampling_tpu_torch.definitions import DATASET_DIR

    t0 = time.perf_counter()
    datadir = os.path.join(DATASET_DIR, "example")
    if not os.path.exists(os.path.join(datadir, "transforms_test.json")):
        generate_example_dataset(datadir, H=800, W=800)
    scene = load_blender_data(datadir, half_res=True, testskip=1)
    scene.composite_white_background()
    log(f"[scene] example scene ready in {time.perf_counter() - t0:.1f} s: "
        f"{len(scene.images)} views at {scene.hwf[0]}x{scene.hwf[1]}")
    H, W, focal = scene.hwf
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    _, _, K0, c2w0 = view0_camera()
    require(np.allclose(K, K0) and np.allclose(scene.poses[int(scene.i_test[0])][:3, :4], c2w0),
            "test view 0 of the loaded scene is not the camera the kernel phases used")
    return scene, K


def production_pipeline(mlp_impl: str):
    import dataclasses

    from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.utils.config import load_trainer_config

    cfg = load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    # run.py's hard overrides (reference run.py:101-109): the checkpoint's DepthNet is 10x256
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    return dataclasses.replace(
        cfg.pipeline(with_depth=True), n_depth_samples=64, sampling_mode="uniform",
        distance=1.0, mlp_impl=mlp_impl,
    )


def check_k1(params, device) -> dict:
    from nerf_sampling_tpu_torch.core.rays import get_rays
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1

    H, W, K, c2w = view0_camera()
    ro, rd = get_rays(H, W, K, c2w, device)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    # 64 rays from the camera that miss the r=2 sphere: perpendicular to the origin
    g = torch.Generator().manual_seed(0)
    o = ro[:64]
    d = torch.cross(o, torch.randn(64, 3, generator=g).to(device), dim=1)
    ro, rd = torch.cat([ro, o]), torch.cat([rd, d / d.norm(dim=1, keepdim=True)])
    model, cfg = params.depth, params.depth.cfg
    packed = params.kernels.depth
    A, B = k1.depth_net_inputs(cfg, ro, rd, torch.bfloat16)
    got = k1.depth_net_kernel(packed, cfg, A, B)
    torch.cuda.synchronize()
    plain = k1.depth_net_plain(packed, cfg, A, B, torch.bfloat16)
    A32, B32 = k1.depth_net_inputs(cfg, ro, rd, torch.float32)
    ref32 = k1.depth_net_plain(k1.pack_depth_net(model, torch.float32), cfg, A32, B32, torch.float32)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(got), torch.isnan(plain)
    require(bool(torch.equal(nan_k, nan_p)), "K1: NaN mask differs from the plain version")
    require(bool(nan_k[-64:].all()) and not bool(nan_k[:-64].any()),
            "K1: NaN must mark exactly the 64 rays that miss the sphere")
    mean, mx = errors(got[:-64], plain[:-64])
    mean32, mx32 = errors(got[:-64], ref32[:-64])
    log(f"[K1] {got.numel()} rays: vs plain bf16 mean|d| {mean:.3e} max {mx:.3e} "
        f"(tol {K1_MEAN_TOL:g}/{K1_MAX_TOL:g}); vs plain fp32 mean {mean32:.3e} max {mx32:.3e}")
    require(mean <= K1_MEAN_TOL and mx <= K1_MAX_TOL, "K1 disagrees with its plain version")
    ms = cuda_ms(lambda: k1.depth_net_kernel(packed, cfg, A, B), 10)
    plain_ms = cuda_ms(lambda: k1.depth_net_plain(packed, cfg, A, B, torch.bfloat16), 5)
    log(f"[K1] {ms:.3f} ms per launch at {got.numel()} rays; plain bf16 version {plain_ms:.3f} ms")
    return {"name": "depth_net_kernel", "route": "cuda",
            "source": "nerf_sampling_tpu_torch/kernels/csrc/depth_net.cu",
            "replaces": "nerf_sampling_tpu/kernels/fused_depth_net.py:181",
            "max_abs_err": mx, "ms": ms, "plain_ms": plain_ms}


def check_k2(params, device) -> dict:
    """K2 over all 160,000 rays of view 0, one launch as the main path makes
    it, against its plain versions run over the same rays in chunks."""
    from nerf_sampling_tpu_torch.core.rays import get_rays
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_render as k2

    H, W, K, c2w = view0_camera()
    ro, rd = get_rays(H, W, K, c2w, device)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    n = ro.shape[0]
    # NaN depths, as a sphere miss gives, on 16 rays spread over the frame's tiles
    nan_idx = torch.linspace(0, n - 1, 16, device=device).long()
    depth[nan_idx] = float("nan")
    nan_rows = torch.zeros(n, dtype=torch.bool, device=device)
    nan_rows[nan_idx] = True
    cfg, packed = params.fine.cfg, params.kernels.nerf
    packed32 = k2.pack_nerf(params.fine, torch.float32)
    offsets = torch.from_numpy(k2.uniform_population_offsets(64, 1.0)).to(device)
    chunk = 16384

    def plain_frame(weights, dtype) -> dict[str, torch.Tensor]:
        parts = [k2.render_around_depth_plain(weights, cfg, ro[s:s + chunk], rd[s:s + chunk],
                                              depth[s:s + chunk], offsets, dtype=dtype)
                 for s in range(0, n, chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    got = k2.render_around_depth_kernel(packed, cfg, ro, rd, depth, offsets)
    torch.cuda.synchronize()
    plain = plain_frame(packed, torch.bfloat16)
    ref32 = plain_frame(packed32, torch.float32)
    torch.cuda.synchronize()
    worst = 0.0
    for name, scale in (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0), ("disp_map", 6.0)):
        a, b = got[name], plain[name]
        nan_a = torch.isnan(a).reshape(n, -1)
        require(bool(torch.equal(torch.isnan(a), torch.isnan(b))), f"K2 {name}: NaN mask differs")
        require(bool(nan_a[nan_rows].all()) and not bool(nan_a[~nan_rows].any()),
                f"K2 {name}: NaN must mark exactly the NaN-depth rays")
        mean, mx = errors(a, b)
        mean32, mx32 = errors(a, ref32[name])
        log(f"[K2] {name}: vs plain bf16 mean {mean:.3e} max {mx:.3e} (tol {K2_MEAN_TOL * scale:g}/"
            f"{K2_MAX_TOL * scale:g}); vs plain fp32 mean {mean32:.3e} max {mx32:.3e}")
        require(mean <= K2_MEAN_TOL * scale and mx <= K2_MAX_TOL * scale,
                f"K2 {name} disagrees with its plain version")
        if name == "rgb_map":
            worst = mx
    ms = cuda_ms(lambda: k2.render_around_depth_kernel(packed, cfg, ro, rd, depth, offsets), 5)
    plain_ms = cuda_ms(lambda: plain_frame(packed, torch.bfloat16), 2)
    log(f"[K2] {n} rays x 64 samples, {int(nan_rows.sum())} with NaN depth; {ms:.3f} ms per "
        f"launch; plain bf16 version {plain_ms:.3f} ms (in chunks of {chunk} rays)")
    return {"name": "render_around_depth_kernel", "route": "cuda",
            "source": "nerf_sampling_tpu_torch/kernels/csrc/render_around_depth.cu",
            "replaces": "nerf_sampling_tpu/kernels/fused_render.py:390",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def same_bits(a: dict, b: dict) -> bool:
    """Every map equal element for element, NaN where NaN."""
    return all(torch.equal(torch.isnan(a[k]), torch.isnan(b[k]))
               and torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k])) for k in a)


def quantile(x: torch.Tensor, q: float) -> float:
    x = x[~torch.isnan(x)].float()
    return float(torch.quantile(x, q)) if x.numel() <= 16_000_000 else float(x.max())


def check_k3(params, device) -> dict:
    """K3 over all 160,000 rays of view 0 in one launch, with injected
    noise and 16 NaN depths, against its plain versions; then its in-kernel
    Philox draws: bits per seed, and the mean rgb against torch draws."""
    from nerf_sampling_tpu_torch.core.rays import get_rays
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_render as k2
    from nerf_sampling_tpu_torch.kernels import philox

    H, W, K, c2w = view0_camera()
    ro, rd = get_rays(H, W, K, c2w, device)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    n, S, std = ro.shape[0], 64, 1.0
    nan_idx = torch.linspace(0, n - 1, 16, device=device).long()
    depth[nan_idx] = float("nan")
    nan_rows = torch.zeros(n, dtype=torch.bool, device=device)
    nan_rows[nan_idx] = True
    cfg, packed = params.fine.cfg, params.kernels.nerf
    packed32 = k2.pack_nerf(params.fine, torch.float32)
    g = torch.Generator(device=device).manual_seed(3)
    noise = torch.randn((n, S - 1), generator=g, device=device)
    chunk = 16384

    def plain_frame(weights, dtype, nz) -> dict[str, torch.Tensor]:
        parts = [k2.render_gaussian_plain(weights, cfg, ro[s:s + chunk], rd[s:s + chunk],
                                          depth[s:s + chunk], nz[s:s + chunk], std=std, dtype=dtype)
                 for s in range(0, n, chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def kernel(**kw):
        return k2.render_gaussian_kernel(packed, cfg, ro, rd, depth, n_samples=S, std=std, **kw)

    got = kernel(noise=noise)
    torch.cuda.synchronize()
    plain = plain_frame(packed, torch.bfloat16, noise)
    ref32 = plain_frame(packed32, torch.float32, noise)
    worst = 0.0
    for name, scale in (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0), ("disp_map", 6.0)):
        a, b = got[name], plain[name]
        nan_a = torch.isnan(a).reshape(n, -1)
        require(bool(torch.equal(torch.isnan(a), torch.isnan(b))), f"K3 {name}: NaN mask differs")
        require(bool(nan_a[nan_rows].all()) and not bool(nan_a[~nan_rows].any()),
                f"K3 {name}: NaN must mark exactly the NaN-depth rays")
        mean, mx = errors(a, b)
        mean32, mx32 = errors(a, ref32[name])
        log(f"[K3] {name}: vs plain bf16 mean {mean:.3e} max {mx:.3e} (tol {K2_MEAN_TOL * scale:g}/"
            f"{K2_MAX_TOL * scale:g}); vs plain fp32 mean {mean32:.3e} max {mx32:.3e}")
        require(mean <= K2_MEAN_TOL * scale and mx <= K2_MAX_TOL * scale,
                f"K3 {name} disagrees with its plain version")
        if name == "rgb_map":
            worst = mx

    # in-kernel draws: a seed fixes the bits, the next seed changes them, and
    # the kernel's Philox stream is the host's (kernels/philox.py)
    a, b, c = kernel(seed=7), kernel(seed=7), kernel(seed=8)
    torch.cuda.synchronize()
    require(same_bits(a, b), "K3: one seed gave two results")
    require(not same_bits({"d": a["depth_map"]}, {"d": c["depth_map"]}), "K3: seed+1 gave the same depths")
    host = plain_frame(packed, torch.bfloat16, philox.gaussian_noise(7, n, S - 1).to(device))
    p_mean, p_max = errors(a["rgb_map"], host["rgb_map"])
    torch_draws = plain_frame(packed, torch.bfloat16, torch.randn((n, S - 1), generator=g, device=device))
    ok = ~nan_rows
    delta = abs(float(a["rgb_map"][ok].mean()) - float(torch_draws["rgb_map"][ok].mean()))
    log(f"[K3] in-kernel draws: seed 7 twice bit-identical, seed 8 differs; vs plain bf16 on "
        f"philox.gaussian_noise(7) rgb mean {p_mean:.3e} max {p_max:.3e}; |mean rgb - mean rgb of "
        f"plain with torch draws| {delta:.3e} (tol {K3_MEAN_RGB_TOL:g})")
    require(p_mean <= K2_MEAN_TOL and p_max <= K2_MAX_TOL, "K3: in-kernel draws are not the host's")
    require(delta <= K3_MEAN_RGB_TOL, "K3: in-kernel draws shift the mean rgb")
    ms = cuda_ms(lambda: kernel(seed=7), 5)
    plain_ms = cuda_ms(lambda: plain_frame(packed, torch.bfloat16, noise), 2)
    log(f"[K3] {n} rays x {S} samples: {ms:.3f} ms per launch (in-kernel draws); plain bf16 "
        f"version {plain_ms:.3f} ms (in chunks of {chunk} rays)")
    return {"name": "render_gaussian_kernel", "route": "cuda",
            "source": "nerf_sampling_tpu_torch/kernels/csrc/render_around_depth.cu",
            "replaces": "nerf_sampling_tpu/kernels/fused_render.py:390",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_k6(params, device, batches: list[tuple[torch.Tensor, torch.Tensor]]) -> dict:
    """K6 against its plain version on 1024-ray train batches with injected
    draws (the first 8 batches), its in-kernel draws (bits per seed, mean
    rgb against torch draws over all batches) and its time per launch."""
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6

    packed = params.kernels.hier
    cfg_c, cfg_f = params.coarse.cfg, params.fine.cfg
    packed32 = k6.pack_hier(params.coarse, params.fine, torch.float32)
    Nc, Nf = 64, 128
    g = torch.Generator(device=device).manual_seed(5)

    def kernel(ro, rd, **kw):
        return k6.render_hier_kernel(packed, cfg_c, cfg_f, ro, rd, n_coarse=Nc, n_importance=Nf, **kw)

    def plain(ro, rd, draws, weights=packed, dtype=torch.bfloat16):
        return k6.render_hier_plain(weights, cfg_c, cfg_f, ro, rd, n_coarse=Nc, n_importance=Nf,
                                    t_rand=draws[:, :Nc], u=draws[:, Nc:], dtype=dtype)

    got, want, want32 = [], [], []
    for ro, rd in batches[:8]:
        draws = torch.rand((ro.shape[0], Nc + Nf), generator=g, device=device)
        got.append(kernel(ro, rd, draws=draws))
        want.append(plain(ro, rd, draws))
        want32.append(plain(ro, rd, draws, packed32, torch.float32))
    torch.cuda.synchronize()
    cat = {k: torch.cat([o[k] for o in got]) for k in got[0]}
    ref = {k: torch.cat([o[k] for o in want]) for k in want[0]}
    ref32 = {k: torch.cat([o[k] for o in want32]) for k in want32[0]}
    for k in cat:
        require(not bool(torch.isnan(cat[k]).any()), f"K6 {k}: NaN")
    worst = 0.0
    for name in ("rgb_map", "acc_map"):
        d = (cat[name] - ref[name]).abs()
        mean, p999 = float(d.mean()), quantile(d, 0.999)
        d32 = (cat[name] - ref32[name]).abs()
        log(f"[K6] {name}: vs plain bf16 mean {mean:.3e} p99.9 {p999:.3e} max {float(d.max()):.3e} "
            f"(tol {K6_MEAN_TOL:g}/{K6_P999_TOL:g}); vs plain fp32 mean {float(d32.mean()):.3e}")
        require(mean <= K6_MEAN_TOL and p999 <= K6_P999_TOL, f"K6 {name} disagrees with its plain version")
        worst = max(worst, float(d.max()))
    fg = ref["acc_map"] > 0.5
    dz = (cat["max_z"] - ref["max_z"]).abs()
    mean_z, p99_z = float(dz[fg].mean()), quantile(dz[fg], 0.99)
    log(f"[K6] max_z on {int(fg.sum())} rays with acc > 0.5: mean {mean_z:.3e} p99 {p99_z:.3e} "
        f"(tol {K6_Z_MEAN_TOL:g}/{K6_Z_P99_TOL:g}); background rays (argmax is noise there): "
        f"mean {float(dz[~fg].mean()) if bool((~fg).any()) else 0.0:.3e}")
    require(mean_z <= K6_Z_MEAN_TOL and p99_z <= K6_Z_P99_TOL, "K6 max_z disagrees with its plain version")

    ro0, rd0 = batches[0]
    a, b, c = kernel(ro0, rd0, seed=11), kernel(ro0, rd0, seed=11), kernel(ro0, rd0, seed=12)
    torch.cuda.synchronize()
    require(same_bits(a, b), "K6: one seed gave two results")
    require(not torch.equal(a["max_z"], c["max_z"]), "K6: seed+1 gave the same max_z")
    sum_k = sum_p = 0.0
    for i, (ro, rd) in enumerate(batches):
        sum_k += float(kernel(ro, rd, seed=1000 + i)["rgb_map"].mean())
        draws = torch.rand((ro.shape[0], Nc + Nf), generator=g, device=device)
        sum_p += float(plain(ro, rd, draws)["rgb_map"].mean())
    delta = abs(sum_k - sum_p) / len(batches)
    log(f"[K6] in-kernel draws: seed 11 twice bit-identical, seed 12 differs; over {len(batches)} "
        f"batches |mean rgb - mean rgb of plain with torch draws| {delta:.3e} (tol {K6_MEAN_RGB_TOL:g})")
    require(delta <= K6_MEAN_RGB_TOL, "K6: in-kernel draws shift the mean rgb")

    big_o = torch.cat([b[0] for b in batches[:16]])
    big_d = torch.cat([b[1] for b in batches[:16]])
    ms = cuda_ms(lambda: kernel(ro0, rd0, seed=1), 20)
    ms_big = cuda_ms(lambda: kernel(big_o, big_d, seed=1), 5)
    draws0 = torch.rand((ro0.shape[0], Nc + Nf), generator=g, device=device)
    plain_ms = cuda_ms(lambda: plain(ro0, rd0, draws0), 5)
    log(f"[K6] {ro0.shape[0]} rays x ({Nc} sigma-only + {Nc + Nf} full) samples: {ms:.3f} ms per "
        f"launch; {big_o.shape[0]} rays: {ms_big:.3f} ms; plain bf16 version at "
        f"{ro0.shape[0]} rays {plain_ms:.3f} ms")
    occ = k6.kernel_occupancy()
    slots = occ["blocks_per_sm"] * occ["sms"]
    for n in (ro0.shape[0], big_o.shape[0]):
        blocks = -(-n // occ["rays_per_block"])
        log(f"[K6] occupancy at {n} rays: {blocks} blocks of {occ['rays_per_block']} rays, "
            f"{occ['blocks_per_sm']} resident per SM x {occ['sms']} SMs = {slots} slots, "
            f"{blocks / slots:.2f} waves")
    return {"name": "render_hier_kernel", "route": "cuda",
            "source": "nerf_sampling_tpu_torch/kernels/csrc/render_hier.cu",
            "replaces": "nerf_sampling_tpu/kernels/fused_hier.py:255",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def run_slice(device, scene, K) -> dict[str, int]:
    """The render path: the committed checkpoint's 4 test views through
    render_path on K1 and K2; returns the launch counts of that run."""
    import dataclasses

    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_render as k2
    from nerf_sampling_tpu_torch.render import render_image, render_path
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    H, W, focal = scene.hwf
    pipe = production_pipeline("cuda")
    params = load_render_params(CKPT, pipe, device)
    test_poses = [scene.poses[i] for i in scene.i_test]
    gts = scene.images[scene.i_test]

    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(os.path.join(OUT_DIR, "psnr.txt")):  # render_path appends
        os.remove(os.path.join(OUT_DIR, "psnr.txt"))
    k1.launches = k2.launches = 0
    rgbs, _, avg = render_path(pipe, params, test_poses, (H, W, focal), K, device=device,
                               gt_imgs=gts, savedir=OUT_DIR, verbose=False)
    torch.cuda.synchronize()
    counts = {"depth_net_kernel": k1.launches, "render_around_depth_kernel": k2.launches}
    log(f"[slice] launches during render_path: {counts}")
    for name, count in counts.items():
        require(count > 0, f"{name} was not launched by the render path")
    require(rgbs.shape == (len(test_poses), H, W, 3) and bool(np.isfinite(rgbs).all()),
            "the render is not finite or has the wrong shape")
    psnrs = [float(-10 * np.log10(np.mean((r - g) ** 2))) for r, g in zip(rgbs, gts)]
    with open(EXPECTED) as fp:
        expected = json.load(fp)["example"]
    psnr0, std0 = psnrs[0], float(rgbs[0].std())
    log(f"[slice] per-view PSNR {['%.4f' % p for p in psnrs]} (avg {avg:.4f}); view 0 "
        f"{psnr0:.4f} dB (JAX fp32 reference {REFERENCE_PSNR_VIEW0} +- {PSNR_TOL}; "
        f"expected.json's TPU v5e record {expected['psnr_view0']}), std {std0:.5f} "
        f"(expected {expected['img_std']} +- {STD_TOL})")
    require(abs(psnr0 - REFERENCE_PSNR_VIEW0) <= PSNR_TOL, "view 0 PSNR off the JAX reference")
    require(abs(std0 - expected["img_std"]) <= STD_TOL, "view 0 image std off the recorded value")

    plain_pipe = dataclasses.replace(pipe, mlp_impl="plain")

    def render(p):
        return render_image(p, params, H, W, K, test_poses[0][:3, :4], device=device)

    img = render(plain_pipe)["depth_net_rgb_map"].float().cpu().numpy()
    psnr_plain = float(-10 * np.log10(np.mean((img - gts[0]) ** 2)))
    log(f"[slice] view 0 on the plain fp32 path: {psnr_plain:.4f} dB (kernel path {psnr0:.4f}, "
        f"|delta| {abs(psnr_plain - psnr0):.4f}, tol {PLAIN_PSNR_TOL})")
    require(abs(psnr_plain - psnr0) <= PLAIN_PSNR_TOL, "kernel and plain fp32 paths disagree")

    ms_kernel = frame_ms(lambda: render(pipe), 7)
    ms_plain = frame_ms(lambda: render(plain_pipe), 3)
    log(f"[slice] median per 400x400 frame, DEPTH_NET uniform/64: kernels {ms_kernel:.2f} ms "
        f"({H * W / ms_kernel * 1e3:.0f} rays/s), plain fp32 {ms_plain:.2f} ms "
        f"({H * W / ms_plain * 1e3:.0f} rays/s)")
    profile_frame(lambda: render(pipe))
    return counts


def profile_frame(fn, what: str = "one frame", top: int = 12):
    """Device time by kernel over one run of ``fn`` (torch.profiler);
    returns (wall ms, kernel rows)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernel rows only: an aten op's row repeats the time of its kernels
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # a record_function range shows on the device as a span over its kernels
    spans = [e for e in cuda if getattr(e, "is_user_annotation", False)]
    rows = [e for e in cuda if not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    log(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms, kernels {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of the wall time; device idle {100 - 100 * busy / wall_us:.1f}%)")
    for e in rows[:top]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    for e in spans:
        log(f"[profile] range {e.key}: {e.device_time_total / 1e3:.3f} ms on the device")
    return wall_us / 1e3, rows


def train_batches(scene, device, n: int, seed: int = 0):
    """n train batches of 1024 rays from the port's RaySampler, on ``device``."""
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig

    sampler = RaySampler(scene, SamplerConfig(N_rand=1024), seed=seed)
    out = []
    for i in range(1, n + 1):
        ro, rd, target = sampler.sample(i)
        out.append(tuple(torch.from_numpy(x).to(device) for x in (ro, rd, target)))
    return out


def write_nerf_only_checkpoint(path: str) -> None:
    """The committed checkpoint's NeRFs alone, as a JAX-layout .npz."""
    from nerf_sampling_tpu_torch.train import checkpoint as ck

    tree, _ = ck.read_npz_tree(CKPT)
    sds = ck.params_from_jax(tree["params"])
    sds.pop("depth")
    ck.save_checkpoint(path, {"params": ck.JaxNeRFParams(**ck.params_to_jax(sds))}, 0)


def run_training(device, scene, K) -> tuple[dict[str, int], object]:
    """The training slice through the CLI's main, in process: the recipe
    (recommended_depth_net_module with run.py's overrides) on the example
    scene, a fresh DepthNet against the committed NeRF, kernel path."""
    import shutil

    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6
    from nerf_sampling_tpu_torch.kernels import fused_render as k3
    from nerf_sampling_tpu_torch.render import pack_kernel_weights, render_path
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    ft_path = os.path.join(TRAIN_DIR, "nerf_only.npz")
    write_nerf_only_checkpoint(ft_path)
    argv = ["-d", "example", "-m", "recommended_depth_net_module", "--mlp_impl", "cuda",
            "--ft_path", ft_path, "--n_iters", str(TRAIN_ITERS), "-ip", str(TRAIN_PRINT), "--seed", "42",
            "--basedir", TRAIN_DIR, "--testskip", "1"]
    log(f"[train] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
    k1.launches = k3.gaussian_launches = k6.launches = 0
    t0 = time.perf_counter()
    trainer = run.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"depth_net_kernel": k1.launches, "render_gaussian_kernel": k3.gaussian_launches,
              "render_hier_kernel": k6.launches}
    log(f"[train] {trainer.global_step} steps in {wall:.1f} s (evals and checkpoints included); "
        f"launches during the run: {counts}")
    for name, count in counts.items():
        require(count > 0, f"{name} was not launched by the training run")
    with open(os.path.join(trainer.expdir, "psnr.txt")) as fp:
        lines = [ln for ln in fp if ln.startswith("Iter:")]
    losses = [float(ln.split("Depth Net Loss: ")[1].split(",")[0]) for ln in lines]
    log(f"[train] Depth Net Loss at step {lines[0].split()[1]}: {losses[0]:.6f}, at step "
        f"{lines[-1].split()[1]}: {losses[-1]:.6f}")
    require(losses[-1] < losses[0], "the depth-net loss did not fall")
    with open(os.path.join(trainer.expdir, "metrics.jsonl")) as fp:
        rates = [json.loads(ln) for ln in fp if '"steps_per_sec"' in ln]
    if rates:
        log(f"[train] steady-state rate at step {rates[-1]['step']}: {rates[-1]['steps_per_sec']:.1f} "
            f"steps/s ({rates[-1]['rays_per_sec']:.0f} rays/s), evals included")
    best = os.path.join(trainer.expdir, "best", f"depth_{EVAL_STEP:06d}.npz")
    require(os.path.exists(best), f"{best} was not written")

    # the committed DepthNet under the same eval, in the same run
    pipe = trainer.pipeline
    committed = pack_kernel_weights(load_render_params(CKPT, pipe, device))
    _, _, ref_avg = render_path(
        pipe, committed, scene.poses[scene.i_test], scene.hwf, K, device=device,
        gt_imgs=scene.images[scene.i_test], verbose=False,
        generator=torch.Generator(device=device).manual_seed(0),
    )
    trained = trainer._avg_eval_psnr
    log(f"[train] step-{EVAL_STEP} eval over {len(scene.i_test)} test views "
        f"({pipe.sampling_mode}/{pipe.n_depth_samples}/{pipe.distance}): trained DepthNet "
        f"{trained:.4f} dB, committed DepthNet {ref_avg:.4f} dB, gap {ref_avg - trained:+.4f} dB "
        f"(gate: at most {EVAL_GAP_TOL} dB below)")
    require(trained >= ref_avg - EVAL_GAP_TOL, "the trained DepthNet evaluates too far below the committed one")
    return counts, trainer


def check_train_step(trainer, scene, device) -> None:
    """One step on both paths from one state, batch and draws; the step's
    time on both paths; a profiled kernel-path step."""
    import copy
    import dataclasses

    from nerf_sampling_tpu_torch.render import make_ray_batch
    from nerf_sampling_tpu_torch.train.state import init_state
    from nerf_sampling_tpu_torch.train.steps import StepDraws, depth_net_loss, make_depth_net_train_step

    frozen = trainer.params
    pipes = {impl: dataclasses.replace(trainer.pipeline, mlp_impl=impl) for impl in ("cuda", "plain")}
    (ro, rd, target), = train_batches(scene, device, 1, seed=123)
    g = torch.Generator(device=device).manual_seed(9)
    p = trainer.pipeline
    draws = StepDraws(torch.rand((ro.shape[0], p.N_samples), generator=g, device=device),
                      torch.rand((ro.shape[0], p.N_importance), generator=g, device=device))
    res = {}
    for impl, pipe in pipes.items():
        depth = copy.deepcopy(frozen.depth)
        rays = make_ray_batch(pipe, ro, rd)
        loss, m = depth_net_loss(pipe, frozen, depth, rays, target, 0, draws)
        loss.backward()
        res[impl] = ({k: float(v) for k, v in m.items()},
                     torch.cat([q.grad.flatten() for q in depth.parameters()]))
    (mk, gk), (mp, gp) = res["cuda"], res["plain"]
    img_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    dep_rel = abs(mk["depth_net_loss"] - mp["depth_net_loss"]) / max(abs(mp["depth_net_loss"]), 1e-12)
    cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
    log(f"[step] one step from one state, batch and draws, cuda vs plain: img_loss {mk['loss']:.6e} vs "
        f"{mp['loss']:.6e} (rel {img_rel:.2e}, tol {STEP_IMG_TOL:g}); depth_net_loss "
        f"{mk['depth_net_loss']:.6e} vs {mp['depth_net_loss']:.6e} (rel {dep_rel:.2e}, tol "
        f"{STEP_DEPTH_TOL:g}); gradient cosine {cos:.6f} (tol {STEP_COS_TOL:g})")
    require(img_rel <= STEP_IMG_TOL and dep_rel <= STEP_DEPTH_TOL and cos >= STEP_COS_TOL,
            "the kernel and plain train steps disagree")

    batches = train_batches(scene, device, 12, seed=321)
    times = {}
    for impl, reps in (("cuda", 10), ("plain", 3)):
        state = init_state(copy.deepcopy(frozen.depth), trainer.cfg.depth_net_lr)
        step = make_depth_net_train_step(pipes[impl], frozen)

        def one(i, state=state, step=step):
            step(state, batches[i % len(batches)], 1000 + i)

        times[impl] = frame_ms(lambda it=iter(range(100)), one=one: one(next(it)), reps)
    log(f"[step] median ms per train step ({ro.shape[0]} rays, {p.N_samples}+{p.N_importance} "
        f"samples): kernel path {times['cuda']:.3f} ms, plain fp32 path {times['plain']:.3f} ms")

    state = init_state(copy.deepcopy(frozen.depth), trainer.cfg.depth_net_lr)
    step = make_depth_net_train_step(pipes["cuda"], frozen)
    step(state, batches[0], 7)
    wall, rows = profile_frame(lambda: step(state, batches[1], 8), "one kernel-path train step", top=8)
    k6_ms = sum(e.self_device_time_total for e in rows if "render_hier" in e.key) / 1e3
    log(f"[profile] K6 {k6_ms:.3f} ms: {100 * k6_ms / wall:.1f}% of the profiled {wall:.3f} ms step, "
        f"{100 * k6_ms / times['cuda']:.1f}% of the median unprofiled step ({times['cuda']:.3f} ms)")
    phase_times(state, frozen, pipes["cuda"], batches[2])


def phase_times(state, frozen, pipe, batch) -> None:
    """Device time of each phase of one kernel-path step (CUDA events):
    the K6 oracle, the DepthNet forward with the depth-point query, the
    backward and Adam."""
    from nerf_sampling_tpu_torch.core.compositing import raw2outputs
    from nerf_sampling_tpu_torch.core.metrics import img2mse
    from nerf_sampling_tpu_torch.core.sampling import z_to_points
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6
    from nerf_sampling_tpu_torch.render import make_ray_batch
    from nerf_sampling_tpu_torch.render.engine import _query_fine_or_coarse

    ro, rd, target = batch
    rays = make_ray_batch(pipe, ro, rd)
    reps = 10
    parts, walls = np.zeros(4), []
    for rep in range(reps + 1):  # the first is a warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        with torch.no_grad():
            hm = k6.render_hier_kernel(frozen.kernels.hier, frozen.coarse.cfg, frozen.fine.cfg, ro, rd,
                                       n_coarse=pipe.N_samples, n_importance=pipe.N_importance, seed=rep)
        ev[1].record()
        depth_z = state.model(ro, rd)
        raw = _query_fine_or_coarse(pipe, frozen, z_to_points(ro, rd, depth_z), rays)
        rgb = raw2outputs(raw, depth_z, rd, 0.0, pipe.white_bkgd).rgb_map
        loss = img2mse(rgb, target) + img2mse(depth_z, hm["max_z"][:, None])
        ev[2].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            walls.append((time.perf_counter() - t0) * 1e3)
            parts += [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    names = ("K6 oracle", "DepthNet forward + depth-point query + loss", "backward", "Adam")
    log(f"[phases] mean over {reps} steps, stream time between CUDA events (host gaps included): "
        + "; ".join(f"{n} {t / reps:.3f} ms" for n, t in zip(names, parts))
        + f"; host wall {np.mean(walls):.3f} ms")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nerf_sampling_tpu_torch.kernels import build
    from nerf_sampling_tpu_torch.render import pack_kernel_weights
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    build.load_library()
    info = build.build_info
    log(f"[build] {'built' if info['built'] else 'cached'} {info['path']} in {info['seconds']:.1f} s")
    if info["built"]:
        with open(info["log"]) as fp:
            for line in fp:
                if "registers" in line or "spill" in line or "smem" in line:
                    log("[build] " + line.rstrip())

    params = pack_kernel_weights(load_render_params(CKPT, production_pipeline("cuda"), device),
                                 with_hier=True)
    scene, K = load_example_scene()
    kernels = [check_k1(params, device), check_k2(params, device), check_k3(params, device),
               check_k6(params, device, [b[:2] for b in train_batches(scene, device, 64)])]
    torch.cuda.synchronize()
    render_counts = run_slice(device, scene, K)
    train_counts, trainer = run_training(device, scene, K)
    check_train_step(trainer, scene, device)
    torch.cuda.synchronize()
    for rec in kernels:  # the count of the path each kernel serves: K2 renders, the rest train
        rec["launches"] = train_counts.get(rec["name"], render_counts.get(rec["name"]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
