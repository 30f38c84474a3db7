"""Time the render and point-query kernels on two checkouts in turns on one GPU: the other tree, this one, this one, the other.

    python3 ab_render_times.py OTHER_TREE

OTHER_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists). Each turn is a process of its own that builds the tree's kernels
and times, with CUDA events after a warm-up, K6 (the seeded hierarchical
pass, 1024 rays of test view 0, 64 + 128 samples, 50 launches), K3 (the
gaussian population over view 0's 160,000 rays at 64 samples, 10
launches), K2 (the same rays around the DepthNet's depths, uniform at 64
samples, std 1, 10 launches) and K7 (the deterministic hierarchical pass
over the 160,000 rays, 64 + 128, 5 launches) on the committed
checkpoint, then, on its fine NeRF, K4 on a NeRF step's coarse (1024 rays
of view 0 x 64 points) and fine (x 192) queries (20 launches each) and
K5's three passes on each with a seeded cotangent (want_dx off; CUDA
events around each pass, mean of 10 launches), through the wrappers both
trees have. Prints one ``TIMES`` JSON line per turn, then the card's name
and power limit, and exits non-zero when a turn fails. ``python3
ab_render_times.py --time TREE`` times one tree alone.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def time_tree(root: str) -> dict:
    """K6, K3, K2, K7 and K4 times and K5's pass times (ms per launch) of the tree at ``root``, in this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6
    from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
    from nerf_sampling_tpu_torch.kernels import fused_nerf_vjp as k5
    from nerf_sampling_tpu_torch.kernels import fused_render as k3
    from nerf_sampling_tpu_torch.render import pack_kernel_weights
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    device = torch.device("cuda", 0)
    params = pack_kernel_weights(load_render_params(cs.CKPT, cs.production_pipeline("cuda"), device),
                                 with_hier=True)
    ro, rd = cs.view0_rays(device)
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    hier, cfg_c, cfg_f = params.kernels.hier, params.coarse.cfg, params.fine.cfg
    b_o, b_d = ro[::156][:1024].contiguous(), rd[::156][:1024].contiguous()
    k6_ms = cs.cuda_ms(lambda: k6.render_hier_kernel(hier, cfg_c, cfg_f, b_o, b_d, n_coarse=64, n_importance=128,
                                                      seed=1), 50)
    k3_ms = cs.cuda_ms(lambda: k3.render_gaussian_kernel(params.kernels.nerf, params.fine.cfg, ro, rd, depth,
                                                          n_samples=64, std=1.0, seed=7), 10)
    offsets = torch.from_numpy(k3.uniform_population_offsets(64, 1.0)).to(device)
    k2_ms = cs.cuda_ms(lambda: k3.render_around_depth_kernel(params.kernels.nerf, params.fine.cfg, ro, rd, depth,
                                                              offsets), 10)
    k7_ms = cs.cuda_ms(lambda: k6.render_hier_kernel(hier, cfg_c, cfg_f, ro, rd, n_coarse=64, n_importance=128), 5)
    times = {"k6_ms": k6_ms, "k3_ms": k3_ms, "k2_ms": k2_ms, "k7_ms": k7_ms}
    g = torch.Generator(device=device).manual_seed(3)
    z = (2.0 + 4.0 * torch.rand((1024, 192), generator=g, device=device)).sort(dim=-1).values
    dirs = torch.nn.functional.normalize(b_d, dim=-1).contiguous()
    packed = k3.pack_nerf(params.fine)
    sl = k3.pack_slices(packed)
    for name, zz in (("coarse", z[:, ::3]), ("fine", z)):
        pts = (b_o[:, None] + b_d[:, None] * zz[..., None]).reshape(-1, 3).contiguous()
        times[f"k4_{name}_ms"] = cs.cuda_ms(lambda: k4.nerf_points_kernel(packed, cfg_f, pts, dirs, slices=sl), 20)
        cot = torch.randn(pts.shape[0], 4, generator=g, device=device) * 1e-3
        k5.nerf_points_bwd_kernel(packed, cfg_f, pts, dirs, cot, want_dx=False, fwd_slices=sl)  # warm-up
        passes = [0.0, 0.0, 0.0]
        for _ in range(10):
            events = []
            k5.nerf_points_bwd_kernel(packed, cfg_f, pts, dirs, cot, want_dx=False, fwd_slices=sl, events=events)
            torch.cuda.synchronize()
            for k in range(3):
                passes[k] += events[k].elapsed_time(events[k + 1]) / 10
        for k, part in enumerate(("rows", "wgrad", "reduce")):
            times[f"k5_{name}_{part}_ms"] = passes[k]
    return times


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print("TIMES " + json.dumps({"tree": sys.argv[2], **time_tree(os.path.abspath(sys.argv[2]))}), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", tree], capture_output=True,
                              text=True, timeout=600)
        print("\n".join(ln for ln in proc.stdout.splitlines() if ln.startswith("TIMES")), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
