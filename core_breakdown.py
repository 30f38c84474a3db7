"""Time K6 and K2 with one piece of the wgmma core cut out at a time, to see where their time goes.

    python3 core_breakdown.py [CUT ...]   # on a machine with a CUDA card, from the repo root

K6 (kernels/csrc/render_hier.cu, the depth step's frozen-NeRF oracle) runs
one block of 8 rays on each SM, and one block alone takes about as long as
a whole 1024-ray launch (chip_smoke.py [K6] and [k10]): its time is the
chain of work inside one block. K2 (kernels/csrc/render_around_depth.cu,
the DEPTH_NET frame's shading) runs 160,000 rays x 64 samples around a
depth, as chip_smoke.py [K2], about 50 waves of one block per SM: its time
is the card's throughput. This script times K6 and K2 in bf16 and in int8
on the checkout and on copies (fault_check.make_copy, under
logs/fault_check/) that each cut one piece out of
kernels/csrc/mlp_wgmma.cuh; a copy's time subtracted from the checkout's is
what the piece costs. The copies compute wrong values: only their times
are read. The NeRFs are two random 8x256 nets with a skip at layer 5, made
from a seed and calibrated on seeded rays; K6 runs 1024 rays at 64 + 128
samples, timed by CUDA events over 20 launches after a warm-up, and one
block (8 rays) the same way; K2 the fine net over 160,000 seeded rays and
depths, 10 launches. The CUT arguments pick cuts by name (all of them by
default). Prints the card's name and power limit and, last, one JSON
object {variant: times in ms}.
"""

from __future__ import annotations

import json
import subprocess
import sys

from fault_check import HERE, make_copy

# name: (the text of mlp_wgmma.cuh it replaces, what replaces it), or several such pairs
CUTS = {
    # the int layers store their sums' low bytes: the integer requant gone
    "no_requant": ("put(out, last, r, col, (j >> 1) & 1, requant_int(a0 < 0 ? 0 : a0, p, q, m, 0),\n"
                   "            requant_int(a1 < 0 ? 0 : a1, p, q, m, 0));",
                   "put(out, last, r, col, (j >> 1) & 1, a0, a1);"),
    # the int layers' whole epilogue gone (bias, requant, store)
    "no_int_epilogue": ("        const int2 b2 = __ldg(reinterpret_cast<const int2*>(bz + col));\n"
                        "        const int a0 = acc[h][j] + b2.x, a1 = acc[h][j + 1] + b2.y;\n"
                        "        put(out, last, r, col, (j >> 1) & 1, requant_int(a0 < 0 ? 0 : a0, p, q, m, 0),\n"
                        "            requant_int(a1 < 0 ? 0 : a1, p, q, m, 0));",
                        "        if (acc[h][j] == 12345678) out[0] = 1;"),
    # the s8 products gone; the ring and its barriers stay
    "no_s8_mma": ("            mma_m64n128k32_s8(acc[h], sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));",
                  "            ;"),
    # the PE fill without its sines and cosines: each sincosf gives its
    # argument instead, and the view embedding zeros; the rows' points,
    # the loops, the packing and the stores stay (bf16 and int8 alike). A
    # cut that makes the whole fill constant lets the compiler re-plan the
    # kernel's registers (552 bytes of spills in bf16 K2, 2.6x its time),
    # so it would time that and not the fill.
    "no_pe": (("for (int k = 0; k < 3; ++k) sincosf(u[k] * (float)(1 << (5 * h + j)), &sn[j][k], &cs[j][k]);",
               "for (int k = 0; k < 3; ++k) sn[j][k] = cs[j][k] = u[k] * (float)(1 << (5 * h + j));"),
              ("    if (col < kViewCh) {\n      const float* q = ray + 8 * r;\n      float u[3];",
               "    if (col < 0) {\n      const float* q = ray + 8 * r;\n      float u[3];")),
}

RUN = r"""
import json
import numpy as np
import torch
from nerf_sampling_tpu_torch.kernels import build, quant
from nerf_sampling_tpu_torch.kernels import fused_hier as k67
from nerf_sampling_tpu_torch.kernels import fused_render as k2
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig

build.load_library()
dev = torch.device("cuda", 0)

def nerf(seed):
    m = NeRF(NeRFConfig(D=8, W=256, input_ch=63, input_ch_views=27, skips=(4,), use_viewdirs=True))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.08, tuple(p.shape)).astype(np.float32)))
    return m

rng = np.random.default_rng(0)
ro = torch.tensor([[0.0, 0.0, 4.0]]).repeat(1024, 1)
rd = torch.from_numpy((rng.normal(size=(1024, 3)) * 0.2).astype(np.float32))
rd[:, 2] = -1.0
n2 = 160000  # K2: the rays of a 400x400 frame around their depths, as chip_smoke.py [K2]
ro2 = torch.tensor([[0.0, 0.0, 4.0]], device=dev).repeat(n2, 1)
rd2 = torch.from_numpy((rng.normal(size=(n2, 3)) * 0.2).astype(np.float32)).to(dev)
rd2[:, 2] = -1.0
depth2 = torch.from_numpy(rng.uniform(3.0, 5.0, n2).astype(np.float32)).to(dev)
offsets = torch.from_numpy(k2.uniform_population_offsets(64, 1.0)).to(dev)
coarse, fine = nerf(1), nerf(2)
calib = tuple(quant.calibrate_nerf_quant(m, ro, rd) for m in (coarse, fine))
packs = {"int8": k67.qpack_hier(coarse.to(dev), fine.to(dev), calib), "bf16": k67.pack_hier(coarse, fine)}
ro, rd = ro.to(dev), rd.to(dev)

def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

out = {}
for name, pk in packs.items():
    out[name] = ms(lambda: k67.render_hier_kernel(pk, coarse.cfg, fine.cfg, ro, rd, seed=1))
    out[name + "_one_block"] = ms(lambda: k67.render_hier_kernel(pk, coarse.cfg, fine.cfg, ro[:8], rd[:8], seed=1))
    out["k2_" + name] = ms(lambda: k2.render_around_depth_kernel(pk["fine"], fine.cfg, ro2, rd2, depth2, offsets), 10)
print("TIMES " + json.dumps(out), flush=True)
"""


def times(cwd: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=cwd, capture_output=True, text=True)
    found = [line for line in proc.stdout.splitlines() if line.startswith("TIMES ")]
    if proc.returncode != 0 or not found:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"the timing run in {cwd} exited with code {proc.returncode}")
    return json.loads(found[0][len("TIMES "):])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("core_breakdown: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[core_breakdown] {smi}", flush=True)
    cuts = sys.argv[1:] or list(CUTS)
    unknown = sorted(set(cuts) - set(CUTS))
    if unknown:
        print(f"core_breakdown: no cut named {', '.join(unknown)}; the cuts: {', '.join(CUTS)}", file=sys.stderr)
        return 2
    result = {"checkout": times(HERE)}
    print(f"[core_breakdown] checkout: {json.dumps(result['checkout'])}", flush=True)
    for name in cuts:
        edits = CUTS[name] if isinstance(CUTS[name][0], tuple) else (CUTS[name],)
        root = make_copy(f"breakdown_{name}", "mlp_wgmma.cuh", *(tuple(e) for e in zip(*edits)))
        result[name] = times(root)
        cost = {k: result["checkout"][k] - v for k, v in result[name].items()}
        print(f"[core_breakdown] {name}: {json.dumps(result[name])}; the piece costs {json.dumps(cost)} ms",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
