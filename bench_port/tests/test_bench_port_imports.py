"""No module of JAX or of the JAX package in a run, and none of the program in the reference.

Each check runs in a fresh interpreter, so that what this test process
imported does not count.
"""

import json
import os
import subprocess
import sys

from bench_port.harness import FORBIDDEN, HERE, ROOT

PROBE = """
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
import bench_port.run, bench_port.readings, bench_port.faults, bench_port.look_grads
from bench_port import harness
for kind in ("drivers", "work"):
    for path in sorted(glob.glob(os.path.join({here!r}, kind, "*.py"))):
        importlib.import_module(f"bench_port.{{kind}}.{{os.path.basename(path)[:-3]}}")
for path in sorted(glob.glob(os.path.join({here!r}, "metrics", "*.py"))):
    harness.load_file_module("metrics", os.path.basename(path)[:-3])
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def probe(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    got = probe(PROBE.format(root=ROOT, here=HERE))
    assert got["forbidden"] == []
    assert "nerf_sampling_tpu_torch" in got["top"]  # the program is there; its name begins with the JAX package's
    assert not set(FORBIDDEN) & set(got["top"])


def test_the_check_compares_whole_top_level_names():
    code = (f"import sys, json; sys.path.insert(0, {ROOT!r}); import types\n"
            "from bench_port import harness\n"
            "sys.modules['nerf_sampling_tpu_torch_extra'] = types.ModuleType('x')\n"
            "a = harness.forbidden_modules()\n"
            "sys.modules['nerf_sampling_tpu.core'] = types.ModuleType('y')\n"
            "print(json.dumps({'forbidden': [a, harness.forbidden_modules()], 'top': []}))")
    before, after = probe(code)["forbidden"]
    assert before == [] and after == ["nerf_sampling_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {ROOT!r})\n"
            "import bench_port.reference.model, bench_port.reference.train, bench_port.reference.philox, "
            "bench_port.reference.weights\n"
            "print(json.dumps({'forbidden': [], 'top': sorted({m.split('.')[0] for m in sys.modules})}))")
    top = probe(code)["top"]
    assert "nerf_sampling_tpu_torch" not in top and not set(FORBIDDEN) & set(top)
