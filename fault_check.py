"""Plant faults in copies of the int8 MLP core and run chip_smoke.py's [k10] gates on each.

    python3 fault_check.py        # on a machine with a CUDA card, from the repo root

The gates that hold the int8 kernels to their plain int8 versions
(chip_smoke.py: K10_MEAN_TOL / K10_P999_TOL on the maps, K10_Z_MEAN_TOL /
K10_Z_P99_TOL on K6/K7's max_z and depth_map) must pass on the sound source
and fail on a wrong one. This runs ``chip_smoke.check_k10`` first on the
checkout as it is, then on one copy per fault below (the port, chip_smoke.py,
the checkpoint and the experiment configs, under logs/fault_check/, with one
edit to the copy's kernels/csrc/nerf_mlp.cuh), with the gates logged instead
of raised, and prints each run's [k10] readings and the gates it failed.
The last line is a JSON object {variant: [failed gates]}. Exits 0 when the
sound source fails no gate and every fault fails at least one.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "logs", "fault_check")
SOURCE = os.path.join("nerf_sampling_tpu_torch", "kernels", "csrc", "nerf_mlp.cuh")

# name: (text of nerf_mlp.cuh, its faulty replacement)
FAULTS = {
    # the integer requant's round bit dropped: every shift truncates
    "round_bit": ("if (p > 0) a = (a >> p) + ((a >> (p - 1)) & 1);", "if (p > 0) a = a >> p;"),
    # h*inv + 0.5 contracted into one rounding (an FMA) at the fp32 requants
    "fma": ("const float x = __fadd_rn(__fmul_rn(h, inv), 0.5f);", "const float x = fmaf(h, inv, 0.5f);"),
    # the +-2^15 clamp before the multiply dropped: t*m may wrap in int32
    "no_clamp": ("a = min(max(a, -(1 << 15)), (1 << 15) - 1) * m;", "a = a * m;"),
}

# run in the checkout or copy: chip_smoke's [k10] with its gates recorded
RUN_K10 = r"""
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
try:
    c.check_k10(params, scene, K, device, [b[:2] for b in c.train_batches(scene, device, 8)])
except Exception:
    traceback.print_exc()
    failed.append("raised")
print("FAILED " + json.dumps(failed), flush=True)
"""


def make_copy(name: str, old: str, new: str) -> str:
    """The files [k10] reads, copied under OUT/name, with old -> new in nerf_mlp.cuh."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    shutil.copytree(os.path.join(HERE, "nerf_sampling_tpu_torch"), os.path.join(root, "nerf_sampling_tpu_torch"),
                    ignore=ignore)
    shutil.copytree(os.path.join(HERE, "evidence", "ckpt"), os.path.join(root, "evidence", "ckpt"))
    configs = os.path.join("nerf_sampling_tpu", "experiments", "configs")
    shutil.copytree(os.path.join(HERE, configs), os.path.join(root, configs))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), root)
    path = os.path.join(root, SOURCE)
    with open(path) as fp:
        text = fp.read()
    if text.count(old) != 1:
        raise RuntimeError(f"fault {name}: the line to replace is not in {SOURCE} exactly once")
    with open(path, "w") as fp:
        fp.write(text.replace(old, new))
    return root


def run_k10(cwd: str) -> list[str]:
    """chip_smoke.check_k10 in ``cwd``; its output passes through, and the
    gates it failed come back."""
    proc = subprocess.run([sys.executable, "-c", RUN_K10], cwd=cwd, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(("[k10]", "[build]", "[fault_check]")):
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
    os.makedirs(OUT, exist_ok=True)
    result = {}
    print("[fault_check] sound source", flush=True)
    result["sound"] = run_k10(HERE)  # generates the example scene the copies take along
    for name, (old, new) in FAULTS.items():
        print(f"[fault_check] fault {name}: {old!r} -> {new!r}", flush=True)
        result[name] = run_k10(make_copy(name, old, new))
        print(f"[fault_check] fault {name}: {len(result[name])} gates failed", flush=True)
    print(json.dumps(result))
    return 0 if not result["sound"] and all(result[n] for n in FAULTS) else 1


if __name__ == "__main__":
    sys.exit(main())
