"""Compare the render and point-query kernels' outputs on two checkouts bit for bit on one GPU.

    python3 ab_render_bits.py OTHER_TREE

OTHER_TREE is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists). In each tree a process of its own builds the kernels and runs,
through the wrappers both trees have, every kernel of the two render
sources in bf16 and in int8 on the same seeded inputs: K2 (uniform around
a depth, NaN depths among them), K3 (gaussian, Philox draws), K8 (the
linspace grid at 64 and 192 samples), K9 (the caller's z, sorted and
unsorted), K6 (seeded, 1024 rays) and K7 (deterministic, 64 + 128); and
K8, K9 and K7 in fp32 (the COMPARE mode's kernels). The NeRFs are two
random 8x256 nets with a skip at layer 5, made from a seed and calibrated
on the seeded rays; 16,384 rays. Then the point-query kernels on the fine
net: K4's raw on a NeRF step's coarse (1024 rays x 64 points) and fine (x
192) queries and on 20,001 points with a direction each (S = 1), and K5's
weight and bias grads with want_dx off and on (and then its dL/dx) on both
step queries with a seeded cotangent. Then K1's depths in bf16 and fp32
from a random 10x256 DepthNet over the same rays (sphere misses among
them), and K11's maps from a random mip-NeRF (8x256, 128 + 128 intervals)
over them with seeded radii. Prints, for
each output, how many of its fp32 words differ between the trees (NaN
compared by its bits), the card's name and power limit, and exits
non-zero when any differs or a run fails.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "logs", "ab_render_bits")

RUN = r"""
import sys
import numpy as np
import torch
from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
from nerf_sampling_tpu_torch.kernels import fused_hier as fh
from nerf_sampling_tpu_torch.kernels import fused_mip as k11
from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
from nerf_sampling_tpu_torch.kernels import fused_nerf_vjp as k5
from nerf_sampling_tpu_torch.kernels import fused_render as fr
from nerf_sampling_tpu_torch.kernels import quant
from nerf_sampling_tpu_torch.models.depth_net import DepthNet, DepthNetConfig
from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig

dev = torch.device("cuda", 0)

def seeded(m, seed, std=0.08):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, std, tuple(p.shape)).astype(np.float32)))
    return m

def nerf(seed):
    return seeded(NeRF(NeRFConfig(D=8, W=256, input_ch=63, input_ch_views=27, skips=(4,), use_viewdirs=True)), seed)

n = 16384
rng = np.random.default_rng(0)
ro = torch.from_numpy((rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, 4.0]).astype(np.float32))
rd = torch.from_numpy((rng.normal(size=(n, 3)) * 0.2).astype(np.float32))
rd[:, 2] = -1.0
depth = torch.from_numpy(rng.uniform(2.5, 5.5, n).astype(np.float32))
depth[::1000] = float("nan")  # sphere misses
z_in = torch.from_numpy(rng.uniform(2.0, 6.0, (n, 64)).astype(np.float32))
coarse, fine = nerf(1), nerf(2)
calib = tuple(quant.calibrate_nerf_quant(m, ro, rd) for m in (coarse, fine))
coarse, fine = coarse.to(dev), fine.to(dev)
ro, rd, depth, z_in = ro.to(dev), rd.to(dev), depth.to(dev), z_in.to(dev)
z_sorted = z_in.sort(dim=-1).values
offsets = torch.from_numpy(fr.uniform_population_offsets(64, 1.0)).to(dev)
packs = {"bf16": (fr.pack_nerf(fine), fh.pack_hier(coarse, fine)),
         "int8": (quant.qpack_nerf(fine, calib[1]), fh.qpack_hier(coarse, fine, calib)),
         "fp32": (fr.pack_nerf(fine, torch.float32), fh.pack_hier(coarse, fine, torch.float32))}
out = {}
rays_k4 = torch.from_numpy(rng.uniform(2.0, 6.0, (1024, 192)).astype(np.float32)).to(dev).sort(dim=-1).values
dirs_k4 = torch.nn.functional.normalize(rd[:1024], dim=-1).contiguous()
queries = {"coarse": (ro[:1024, None] + rd[:1024, None] * rays_k4[:, ::3, None]).reshape(-1, 3).contiguous(),
           "fine": (ro[:1024, None] + rd[:1024, None] * rays_k4[..., None]).reshape(-1, 3).contiguous()}
pts_s1 = torch.from_numpy(rng.uniform(-6.0, 6.0, (20001, 3)).astype(np.float32)).to(dev)
dirs_s1 = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(20001, 3)).astype(np.float32)), dim=-1).to(dev)
pk, sl = fr.pack_nerf(fine), fr.pack_slices(fr.pack_nerf(fine))
for q, pts in queries.items():
    out[f"K4_{q}.raw"] = k4.nerf_points_kernel(pk, fine.cfg, pts, dirs_k4, slices=sl).float().cpu()
    g = torch.from_numpy(rng.normal(0, 1e-3, (pts.shape[0], 4)).astype(np.float32)).to(dev)
    for want_dx in (False, True):
        d, dpts, ddirs = k5.nerf_points_bwd_kernel(pk, fine.cfg, pts, dirs_k4, g, want_dx=want_dx, fwd_slices=sl)
        tag = f"K5_{q}_dx{int(want_dx)}"
        for i, t in enumerate(k5.grads_to_params(fine, d)):
            out[f"{tag}.grad{i:02d}"] = t.detach().float().cpu().contiguous()
        if want_dx:
            out[f"{tag}.dpts"], out[f"{tag}.ddirs"] = dpts.float().cpu(), ddirs.float().cpu()
out["K4_s1.raw"] = k4.nerf_points_kernel(pk, fine.cfg, pts_s1, dirs_s1, slices=sl).float().cpu()
for name, (pk, hpk) in packs.items():
    dt = torch.float32 if name == "fp32" else torch.bfloat16
    runs = {
        "K2": lambda: fr.render_around_depth_kernel(pk, fine.cfg, ro, rd, depth, offsets),
        "K3": lambda: fr.render_gaussian_kernel(pk, fine.cfg, ro, rd, depth, n_samples=64, std=1.0, seed=7),
        "K8_64": lambda: fr.fused_render(pk, fine.cfg, ro, rd, n_samples=64, dtype=dt),
        "K8_192": lambda: fr.fused_render(pk, fine.cfg, ro, rd, n_samples=192, dtype=dt),
        "K9_sorted": lambda: fr.fused_shade(pk, fine.cfg, ro, rd, z_sorted, dtype=dt),
        "K9_unsorted": lambda: fr.fused_shade(pk, fine.cfg, ro, rd, z_in, assume_sorted=False, dtype=dt),
        "K6": lambda: fh.render_hier_kernel(hpk, coarse.cfg, fine.cfg, ro[:1024], rd[:1024], seed=5),
        "K7": lambda: fh.render_hier_kernel(hpk, coarse.cfg, fine.cfg, ro, rd, dtype=dt),
    }
    if name == "fp32":  # K2, K3 and K6 run bf16 and int8 only
        runs = {k: v for k, v in runs.items() if k.startswith(("K7", "K8", "K9"))}
    for kernel, run in runs.items():
        for key, t in run().items():
            out[f"{kernel}_{name}.{key}"] = t.detach().float().cpu().contiguous()
sizes = (256,) * 10
depth_net = seeded(DepthNet(DepthNetConfig(hidden_sizes=sizes, cat_hidden_sizes=sizes)), 3, 0.05).to(dev)
for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
    pk = k1.pack_depth_net(depth_net, dt)
    out[f"K1_{name}.depth"] = k1.fused_depth_net_apply(pk, depth_net.cfg, ro, rd, dt).float().cpu()
mip_cfg = MipNeRFConfig()
mip = seeded(MipNeRF(mip_cfg), 4, 0.05).to(dev)
radii = torch.from_numpy(rng.uniform(1e-3, 3e-3, n).astype(np.float32)).to(dev)
for key, t in k11.render_mip_kernel(k11.pack_mip(mip), mip_cfg, ro, rd, radii).items():
    out[f"K11_bf16.{key}"] = t.detach().float().cpu().contiguous()
torch.cuda.synchronize()
torch.save(out, sys.argv[1])
"""


def run_tree(root: str, path: str) -> None:
    proc = subprocess.run([sys.executable, "-c", RUN, path], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"the run in {root} exited with code {proc.returncode}")


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_render_bits: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    paths = {"other": os.path.join(OUT, "other.pt"), "this": os.path.join(OUT, "this.pt")}
    run_tree(os.path.abspath(sys.argv[1]), paths["other"])
    run_tree(HERE, paths["this"])
    other, this = (torch.load(paths[k]) for k in ("other", "this"))
    differ = 0
    for key in sorted(set(other) | set(this)):
        if key not in other or key not in this or other[key].shape != this[key].shape:
            print(f"[bits] {key}: missing or reshaped in one tree")
            differ += 1
            continue
        bad = int((other[key].view(torch.int32) != this[key].view(torch.int32)).sum())
        nan = int(torch.isnan(this[key]).sum())
        print(f"[bits] {key}: {bad} of {this[key].numel()} words differ ({nan} NaN)")
        differ += bad > 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[bits] {smi}: {differ} of {len(this)} outputs differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
