"""A run with the timed path broken underneath comes out not correct.

Each cell runs on the CPU at a small size (the kernels' plain versions, a
few rays), with the look for a card skipped, once as it is and once with
each fault the cell can have (``bench_port/faults.py``): the fault must
push one compared number over its limit and well above the sound run's.
"""

import contextlib

import pytest
import torch

from bench_port import faults
from bench_port.harness import load_json
from bench_port.run import run_cell

SMALL = {
    "render_depthnet": ({"size": 8, "check_frames": 2, "n_poses": 4}, {}),
    "render_full": ({"size": 8, "check_frames": 2, "check_rays": 32, "n_poses": 4}, {}),
    "train_depthnet": ({"size": 8, "n_train": 2, "steps_per_dispatch": 2}, {"N_rand": 32}),
    "train_nerf": ({"size": 8, "n_train": 2, "steps_per_dispatch": 2}, {"N_rand": 32}),
}
CASES = [(cell, f) for cell in SMALL for f in faults.NAMES
         if not (f == "unchanged" and load_json("workloads", cell)["driver"] == "render_frames")]
_SOUND: dict = {}


def run(cell: str, fault: str | None):
    torch.manual_seed(0)
    wl, cfg = SMALL[cell]
    kind = load_json("workloads", cell)["driver"]
    with faults.plant(fault, kind) if fault else contextlib.nullcontext():
        out = run_cell(cell, 2**31 + 11, 0.0, False, require_card=False, device="cpu",
                       workload_overrides=wl, config_overrides=cfg)
    return {c.name: c for c in out["checks"]}, out["correct"]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_fault_makes_the_run_not_correct(cell, fault):
    if cell not in _SOUND:
        _SOUND[cell] = run(cell, None)[0]
    sound = _SOUND[cell]
    checks, correct = run(cell, fault)
    assert not correct
    caught = [n for n, c in checks.items() if not c.ok and c.value > 3 * sound[n].value]
    assert caught, {n: (c.value, c.limit, sound[n].value) for n, c in checks.items()}
