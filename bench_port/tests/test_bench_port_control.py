"""The controls come out not correct, on the card, at each cell's own size.

A control puts a lower precision in the program's place (the program's own
path where it has one: int8 in the renders and in the depth step's oracle,
TF32 for the depth step's float32 products; else the reference with fp8
operands), runs what a run compares, and must fail one of the cell's
numbers on every seed.
The card's runs of these readings set the upper readings of the limits
(``bench_port/readings.py``); here three seeds per cell.
"""

import pytest
import torch

from bench_port.harness import load_json
from bench_port.readings import readings

CONTROLS = [("render_depthnet", "control"), ("render_full", "control"), ("train_depthnet", "control"),
            ("train_depthnet", "control_tf32"), ("train_nerf", "control_fp8")]


@pytest.mark.card
@pytest.mark.parametrize("cell, control", CONTROLS)
def test_the_control_is_not_correct(cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' own sizes")
    limits = load_json("workloads", cell)["limits"]
    for seed in (101, 2**31 + 3, 3_000_000_019):
        got = readings(cell, seed, control)
        assert any(got[n] > lim for n, lim in limits.items()), (seed, got, limits)
