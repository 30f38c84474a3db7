"""The mip-NeRF cell and the batched-views cell.

On the CPU at small sizes (the kernels' plain versions, a few rays), each
runs through ``run_cell`` and comes out correct, and each fault of
``faults.py`` that applies to a render makes it not correct; the mip-NeRF
reference loads nothing of the program, of JAX or of the JAX package; the
work counts are mip-NeRF's at the published widths; the readers of K11's
device time and roofline read a hand-filled table and return None on a
program without it. On the card (``card``), the controls and the
``no_integration`` fault come out not correct at the cells' own sizes.
"""

import contextlib

import pytest
import torch

from bench_port import faults
from bench_port.harness import load_file_module, load_json
from bench_port.readings import readings
from bench_port.run import run_cell
from bench_port.tests.test_bench_port_imports import probe
from bench_port.harness import FORBIDDEN, ROOT
from bench_port.work import mipnerf_density, mipnerf_query
from nerf_sampling_tpu_torch.utils import profiling

NET = dict(load_json("configs", "blender_mipnerf")["mipnerf"], net_width=32, net_width_condition=16, num_samples=8)
SMALL = {
    "render_mipnerf": ({"size": 8, "check_frames": 2, "check_rays": 32, "n_poses": 4}, {"mipnerf": NET}),
    "render_depthnet_batch4": ({"size": 8, "check_calls": 1, "n_poses": 8}, {}),
}
ROWS = {"calls": 2, "total": 2 * 640000 * 128}  # two frames' intervals at each level
TABLE = {"nst.mip.kernel_ms": {"calls": 2, "total": 1400.0}, "nst.mip.coarse_rows": ROWS, "nst.mip.fine_rows": ROWS}


def run(cell: str, fault: str | None = None, trace: bool = False):
    torch.manual_seed(0)
    wl, cfg = SMALL[cell]
    if trace:
        wl = {**wl, "trace_frames": [0, 1]}
    with faults.plant(fault, "render_frames") if fault else contextlib.nullcontext():
        return run_cell(cell, 2**31 + 13, 0.0, trace, require_card=False, device="cpu", workload_overrides=wl,
                        config_overrides=cfg)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_small_run_on_the_cpu_is_correct(cell):
    out = run(cell)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert {"render_rays_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_cpu_run_reports_the_render_metrics(cell):
    """The render metrics the cells joined; K11's own need its device
    time, which a CPU run does not count."""
    out = run(cell, trace=True)
    assert out["correct"] and {"engine_ms.render", "idle_pct.render", "mfu.render"} <= set(out["metrics"])
    assert not {"mip_kernel_ms.render", "roofline.mip_kernel"} & set(out["metrics"])


@pytest.mark.parametrize("cell, fault", [(c, f) for c in sorted(SMALL) for f in ("half", "altered")])
def test_a_fault_makes_the_run_not_correct(cell, fault):
    sound = {c.name: c for c in run(cell)["checks"]}
    out = run(cell, fault)
    assert not out["correct"]
    assert any(not c.ok and c.value > 3 * sound[c.name].value for c in out["checks"])


def test_the_mip_reference_imports_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {ROOT!r})\n"
            "import bench_port.reference.mipnerf\n"
            "print(json.dumps({'forbidden': [], 'top': sorted({m.split('.')[0] for m in sys.modules})}))")
    top = probe(code)["top"]
    assert "nerf_sampling_tpu_torch" not in top and not set(FORBIDDEN) & set(top)


def test_the_work_counts_are_mip_nerfs():
    net = load_json("configs", "blender_mipnerf")["mipnerf"]
    assert mipnerf_density.macs(net) == 508_160 == 96 * 256 + 6 * 256**2 + 352 * 256 + 256
    assert mipnerf_query.macs(net) == 610_304 == 508_160 + 256**2 + 283 * 128 + 128 * 3
    flops = 2 * 128 * (mipnerf_density.macs(net) + mipnerf_query.macs(net))
    assert flops == pytest.approx(286.3e6, rel=1e-3)


def test_the_k11_readers(monkeypatch):
    ms = load_file_module("metrics", "mip_kernel_ms.render").read
    roof = load_file_module("metrics", "roofline.mip_kernel").read
    run = {"mipnerf": load_json("configs", "blender_mipnerf")["mipnerf"]}
    monkeypatch.setattr(profiling, "recorded", lambda: {})
    assert ms(run) is None and roof(run) is None
    monkeypatch.setattr(profiling, "recorded", lambda: TABLE)
    assert ms(run) == pytest.approx(700.0)
    flops = 2 * 640000 * 128 * 2 * (508_160 + 610_304)
    assert roof(run) == pytest.approx(100 * flops / 989e12 / 1.4, rel=1e-6)
    narrow = dict(run["mipnerf"], net_width=128, net_width_condition=64)  # the run's own widths count
    assert roof({"mipnerf": narrow}) < roof(run) / 3
    assert roof({}) is None  # a run that names no mip-NeRF widths
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert ms(run) is None and roof(run) is None


@pytest.mark.card
@pytest.mark.parametrize("cell, variant", [("render_mipnerf", "control_fp8"), ("render_mipnerf", "no_integration"),
                                           ("render_depthnet_batch4", "control")])
def test_the_control_and_the_fault_are_not_correct(cell, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' own sizes")
    limits = load_json("workloads", cell)["limits"]
    for seed in (101, 2**31 + 3):
        got = readings(cell, seed, variant)
        assert any(got[n] > lim for n, lim in limits.items()), (seed, got, limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["render_mipnerf", "render_depthnet_batch4"])
def test_the_program_is_correct_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")
    limits = load_json("workloads", cell)["limits"]
    got = readings(cell, 2**31 + 7)
    assert all(got[n] <= lim for n, lim in limits.items()), (got, limits)
