"""Plant faults in copies of the MLP cores and run chip_smoke.py's gates on each.

    python3 fault_check.py [FAULT ...]   # on a machine with a CUDA card, from the repo root

Four sets of gates must pass on the sound source and fail on a wrong one:
- "k10", the int8 kernels' (chip_smoke.py [k10]: K10_MEAN_TOL / K10_P999_TOL
  on the maps of K2, K3, K8, K9 and K6/K7 in int8, K10_Z_MEAN_TOL /
  K10_Z_P99_TOL on K6/K7's max_z and depth_map, K6-int8's max_z against
  bf16 K6), against faults in kernels/csrc/nerf_mlp.cuh's requants, which
  the wgmma core's s8 forward calls for every int8 kernel (K2/K3/K8/K9 and
  K6/K7 in int8);
- "core", the wgmma core's first check ([core]: one bf16 layer at
  CORE_ULP_TOL, one s8 layer exact, one fp32 (3xTF32) layer within
  CORE32_TOL of strict fp32's error, the render kernels' PE fill and the
  point-query kernels' (K4, K5) equal to the per-column formula byte for
  byte);
- "wgmma", the bf16 kernels on the core ([K1], [K6], [k4], [k5], [K2], [K3]
  and the render path: K1 against its plain version, the K6 map, max_z and
  draw gates, K4 against its plain version, K5_REL_TOL, K5_COS_TOL and the
  bits across launches, K2's and K3's map and draw gates, view 0's PSNR
  against the JAX reference and the plain fp32 path);
- "fp32", the COMPARE mode's kernels ([k9]: K9 at bf16 and fp32 against
  its plain versions; [fp32]: K1 and K7 fp32 against their plain fp32
  versions; [modes]: COMPARE_NERF and NERF_MAX over view 0, kernels
  against the plain fp32 path);
against faults in the requants, in kernels/csrc/mlp_wgmma.cuh's producer,
which every kernel shares (all of them run on the core: the production
render's K1 and K2, K4, K6, and K1, K7 and K9 in fp32 among them), in its
int8 tile swizzle, which [core]'s s8 layer and every int8 kernel (K2/K3/
K8/K9 and K6/K7) share, and in its 3xTF32 product, which [core]'s fp32
layer and K1, K7 and K9 in fp32 share: its two corrections dropped, or its
sums in one chain (the run says which of [k9], [fp32] and [modes] see
each); and in the PE fills of the render and point-query kernels, which
[core] holds to the per-column formula: their sines and cosines on the
fast hardware path.
This runs the gates first on the checkout as it is, then on one copy per
fault below (the port with its experiment configs, chip_smoke.py and the
checkpoint, under logs/fault_check/, with the fault's edits to the copy's
source); faults named on the command line run alone, the checkout with
only their gate sets. The gates are logged instead of raised; it prints
each run's readings and the gates it failed. The last line is a JSON
object {variant: [failed gates]}. Exits 0 when the sound source fails no
gate and every fault fails at least one.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "logs", "fault_check")
CSRC = os.path.join("nerf_sampling_tpu_torch", "kernels", "csrc")

# name: (source in CSRC, its text, the faulty replacement, the gate sets that
# must catch it); a fault of several edits gives tuples of texts and replacements
FAULTS = {
    # the integer requant's round bit dropped: every shift truncates
    "round_bit": ("nerf_mlp.cuh", "if (p > 0) a = (a >> p) + ((a >> (p - 1)) & 1);", "if (p > 0) a = a >> p;",
                  ("k10",)),
    # h*inv + 0.5 contracted into one rounding (an FMA) at the fp32 requants
    "fma": ("nerf_mlp.cuh", "const float x = __fadd_rn(__fmul_rn(h, inv), 0.5f);",
            "const float x = fmaf(h, inv, 0.5f);", ("k10",)),
    # the +-2^15 clamp before the multiply dropped: t*m may wrap in int32
    "no_clamp": ("nerf_mlp.cuh", "a = min(max(a, -(1 << 15)), (1 << 15) - 1) * m;", "a = a * m;", ("k10",)),
    # the producer hands the consumers a stale slice, the one two back, for
    # slices 2-9 of every 16 of every tile's stream (the NeRF's trunk layers,
    # every layer of the DepthNet's towers and trunk, or the [core]
    # product): in bf16 and int8 the previous half's or panel's, in fp32 the
    # previous (hi, lo) pair's. (One back, an fp32 stream's hi slot gets a
    # lo image and its lo slot the right hi image, which 3xTF32 sums to
    # within about 2^-11 of the product: K1 fp32's gate does not see that.
    # Slices 2-9 of a tile alone touch only the DepthNet's origin tower,
    # which bf16 K1's gate over view 0, whose rays share one origin, does
    # not see.)
    "stale_slice": ("mlp_wgmma.cuh", "const bf16* src = segs[g].slices + (size_t)s * (kSliceBytes / 2);",
                    "const bf16* src = segs[g].slices + (size_t)(s % 16 >= 2 && s % 16 < 10 ? s - 2 : s) * "
                    "(kSliceBytes / 2);",
                    ("core", "wgmma", "fp32")),
    # the int8 tiles written unswizzled while wgmma reads them swizzled: every
    # int8 activation the s8 products read lands in the wrong 16-byte chunk
    "int8_swizzle": ("mlp_wgmma.cuh", "((((col & 127) >> 4) ^ (row & 7)) << 4)", "(((col & 127) >> 4) << 4)",
                     ("core", "k10")),
    # 3xTF32 without its two correction products: every fp32 product on the
    # tensor cores keeps tf32's 10 mantissa bits
    "tf32_single": ("mlp_wgmma.cuh",
                    "for (int kk = 0; kk < 4; ++kk) mma_tf32_corrections(part, hi[kk], lo[kk], sw128_desc(b[0] + 32 * kk), "
                    "sw128_desc(b[1] + 32 * kk));", "", ("core", "fp32")),
    # the 3xTF32 sums in one chain of tensor-core accumulations: no panel
    # sums joined in rounded fp32 ([core]'s fp32 layer reads how much
    # further from fp64 that is; the fp32 set, whether the kernels' gates do)
    "tf32_chain": ("mlp_wgmma.cuh",
                   "for (int i = 0; i < 64; ++i) part[i] = 0.f;\n"
                   "        auto join = [](float sum, float p) { return __fadd_rn(sum, p); };",
                   "for (int i = 0; i < 64; ++i) part[i] = acc[h][i];\n"
                   "        auto join = [](float, float p) { return p; };", ("core", "fp32")),
    # the PE fills of the render kernels and of the point-query kernels (K4,
    # K5) on the fast hardware sine and cosine (__sincosf), which the
    # argument's 2^9 |u| defeats: [core]'s PE fill gates must see their
    # bytes differ from the per-column formula's
    "pe_fast_trig": ("mlp_wgmma.cuh",
                     ("for (int k = 0; k < 3; ++k) sincosf(u[k]", "for (int k = 0; k < 3; ++k) sincosf(x[k]",
                      "      sincosf(xk * "),
                     ("for (int k = 0; k < 3; ++k) __sincosf(u[k]", "for (int k = 0; k < 3; ++k) __sincosf(x[k]",
                      "      __sincosf(xk * "),
                     ("core",)),
}

# run in the checkout or copy: chip_smoke's checks of the named gate sets, gates recorded
RUN = r"""
import json, sys, traceback
import torch
import chip_smoke as c

failed = []

def require(cond, msg):
    if not cond:
        failed.append(msg)
        print("[fault_check] gate failed: " + msg, flush=True)

c.require = require
from nerf_sampling_tpu_torch.render import pack_kernel_weights
from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

device = torch.device("cuda", 0)
params = pack_kernel_weights(load_render_params(c.CKPT, c.production_pipeline("cuda"), device), with_hier=True)
scene, K = c.load_example_scene()
batches = [b[:2] for b in c.train_batches(scene, device, 8)]
queries = []  # the step's queries, made once for K4 and K5
checks = {
    "core": [lambda: c.check_core(device)],
    "k10": [lambda: c.check_k10(params, scene, K, device, batches)],
    "wgmma": [lambda: c.check_k1(params, device), lambda: c.check_k6(params, device, batches),
              lambda: queries.append(c.step_queries(params, scene, device)),
              lambda: c.check_k4(params, queries[0]), lambda: c.check_k5(params, queries[0]),
              lambda: c.check_k2(params, device), lambda: c.check_k3(params, device),
              lambda: c.run_slice(device, scene, K)],
    "fp32": [lambda: c.check_k9(params, device), lambda: c.check_fp32(params, device),
             lambda: c.check_modes(params, scene, K, device)],
}
for name in sys.argv[1:]:
    for check in checks[name]:
        try:
            check()
        except Exception:
            traceback.print_exc()
            failed.append("raised")
print("FAILED " + json.dumps(failed), flush=True)
"""


def make_copy(name: str, source: str, old: str | tuple, new: str | tuple) -> str:
    """The files the checks read, copied under OUT/name, with old -> new in
    CSRC/source (each text of a tuple to its replacement)."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    shutil.copytree(os.path.join(HERE, "nerf_sampling_tpu_torch"), os.path.join(root, "nerf_sampling_tpu_torch"),
                    ignore=ignore)
    shutil.copytree(os.path.join(HERE, "evidence", "ckpt"), os.path.join(root, "evidence", "ckpt"))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), root)
    path = os.path.join(root, CSRC, source)
    with open(path) as fp:
        text = fp.read()
    for a, b in zip(*((old, new) if isinstance(old, tuple) else ((old,), (new,)))):
        if text.count(a) != 1:
            raise RuntimeError(f"fault {name}: the line to replace is not in {source} exactly once")
        text = text.replace(a, b)
    with open(path, "w") as fp:
        fp.write(text)
    return root


def run_checks(cwd: str, gates: list[str]) -> list[str]:
    """chip_smoke's checks of ``gates`` in ``cwd``; their output passes
    through, and the gates they failed come back."""
    proc = subprocess.run([sys.executable, "-c", RUN, *gates], cwd=cwd, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(("[k10]", "[core]", "[K1]", "[K6]", "[k4]", "[k5]", "[K2]", "[K3]", "[slice]", "[k9]", "[fp32]",
                            "[modes]", "[build]", "[fault_check]")):
            print(line, flush=True)
    if proc.returncode != 0 or not proc.stdout.rstrip().splitlines()[-1].startswith("FAILED "):
        print(proc.stderr[-4000:], file=sys.stderr)
        return ["exited with code %d" % proc.returncode]
    return json.loads(proc.stdout.rstrip().splitlines()[-1][len("FAILED "):])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fault_check: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    faults = {n: FAULTS[n] for n in sys.argv[1:]} or FAULTS
    os.makedirs(OUT, exist_ok=True)
    result = {}
    print("[fault_check] sound source", flush=True)
    # generates the example scene the copies take along
    result["sound"] = run_checks(HERE, sorted({g for *_, gates in faults.values() for g in gates}))
    for name, (source, old, new, gates) in faults.items():
        print(f"[fault_check] fault {name} in {source}: {old!r} -> {new!r}, gates {', '.join(gates)}", flush=True)
        result[name] = run_checks(make_copy(name, source, old, new), list(gates))
        print(f"[fault_check] fault {name}: {len(result[name])} gates failed", flush=True)
    print(json.dumps(result))
    return 0 if not result["sound"] and all(result[n] for n in faults) else 1


if __name__ == "__main__":
    sys.exit(main())
