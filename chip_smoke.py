"""Drive the PyTorch port's render path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. Device: a CUDA device is required; prints nvidia-smi's name and power limit.
2. Build: compiles the hand-written kernels from ``nerf_sampling_tpu_torch/kernels/csrc``.
3. Kernel vs plain, on the committed checkpoint's weights:
   K1 (DepthNet) on the 160,000 rays of test view 0 plus 64 rays that miss
   the bounding sphere; K2 (populate-and-shade) on the same 160,000 rays in
   one launch at S=64, std=1.0, with 16 NaN depths spread among them. Each
   is held to its plain version at bf16 rounding, with the tolerances below.
4. The slice: generates the example scene, builds the production pipeline
   (lego.yaml's recommended_depth_net_module with run.py's overrides,
   uniform/64/distance 1.0), loads evidence/ckpt/example_depth.npz through
   the weight converter, renders the 4 test views with ``render_path`` on
   the kernels (both launch counters must move), checks view 0 against the
   JAX package's fp32 render of it (REFERENCE_PSNR_VIEW0), the image std in
   evidence/ckpt/expected.json, and the port's plain fp32 path, times a
   400x400 frame on both paths and profiles one kernel-path frame.

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

# kernel vs its plain version at bf16 rounding (same inputs, same weights):
# the two differ only in fp32 summation order and the few bf16 roundings
# that order flips
K1_MEAN_TOL, K1_MAX_TOL = 1e-3, 5e-2  # |depth| on rays that hit, depth in [2, 6]
K2_MEAN_TOL, K2_MAX_TOL = 1e-3, 2e-2  # |rgb|, |acc| in [0, 1]; depth and disp scaled by 6
PSNR_TOL, STD_TOL, PLAIN_PSNR_TOL = 0.10, 0.003, 0.05
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


def run_slice(device, kernels: list[dict]) -> None:
    import dataclasses

    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_render as k2
    from nerf_sampling_tpu_torch.render import render_image, render_path
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    scene, K = load_example_scene()
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
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
        require(rec["launches"] > 0, f"{rec['name']} was not launched by the main path")
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


def profile_frame(fn) -> None:
    """Device time by kernel over one kernel-path frame (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernel rows only: an aten op's row repeats the time of its kernels
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    log(f"[profile] one frame: wall {wall_us / 1e3:.2f} ms, kernels {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of the wall time)")
    for e in rows[:12]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nerf_sampling_tpu_torch.kernels import build
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

    params = load_render_params(CKPT, production_pipeline("cuda"), device)
    kernels = [check_k1(params, device), check_k2(params, device)]
    torch.cuda.synchronize()
    run_slice(device, kernels)
    torch.cuda.synchronize()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
