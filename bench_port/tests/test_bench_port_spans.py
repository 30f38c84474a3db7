"""The readers of the program's phase times (``nerf_sampling_tpu_torch.utils.profiling``).

Each returns None on an empty table and on a program without the recorder,
and the right value on a hand-filled table; ``oracle_ms.train`` is reported
by the depth cell alone; a traced run on the CPU, where no step is captured
and no phase is timed on a device, reports none of them.
"""

import pytest

from bench_port.harness import benchmark, load_file_module
from bench_port.run import cell_metrics, run_cell
from bench_port.tests.test_bench_port_faults import SMALL
from nerf_sampling_tpu_torch.utils import profiling

NEW = ["oracle_ms.train", "forward_ms.train", "backward_ms.train", "adam_ms.train"]
TABLE = {
    "nst.dispatch.run": {"calls": 2, "seconds": 0.6, "child_seconds": 0.5},
    "nst.dispatch.launch": {"calls": 198, "seconds": 0.495, "child_seconds": 0.0},
    "nst.dispatch.replays": {"calls": 2, "total": 198},
    "nst.dispatch.queued_steps": {"calls": 2, "total": 7},
    "nst.step.oracle": {"calls": 2, "total": 2.8},
    "nst.step.forward": {"calls": 2, "total": 0.9},
    "nst.step.backward": {"calls": 2, "total": 2.2},
    "nst.step.adam": {"calls": 2, "total": 0.5},
    "nst.step.total": {"calls": 2, "total": 6.4},
}
WANT = {"oracle_ms.train": 1.4, "forward_ms.train": 0.45, "backward_ms.train": 1.1, "adam_ms.train": 0.25}


@pytest.mark.parametrize("metric", NEW)
def test_reader(monkeypatch, metric):
    read = load_file_module("metrics", metric).read
    monkeypatch.setattr(profiling, "recorded", lambda: {})
    assert read({}) is None
    monkeypatch.setattr(profiling, "recorded", lambda: TABLE)
    assert read({}) == pytest.approx(WANT[metric])
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert read({}) is None


@pytest.mark.parametrize("metric", ["forward_ms.train", "adam_ms.train"])
def test_a_host_span_of_a_phase_is_no_device_time(monkeypatch, metric):
    """On the CPU a phase marker is a host span; its seconds are not device ms."""
    span = {"calls": 3, "seconds": 0.01, "child_seconds": 0.0, "self_seconds": 0.01}
    monkeypatch.setattr(profiling, "recorded", lambda: {f"nst.step.{metric.split('_')[0]}": span})
    assert load_file_module("metrics", metric).read({}) is None


def test_the_oracle_is_the_depth_cells_alone():
    bench = benchmark()
    by_cell = {w["name"]: {m["name"] for m in cell_metrics(bench, w["name"], "per_layer")} for w in bench["workloads"]}
    assert "oracle_ms.train" in by_cell["train_depthnet"]
    assert [c for c, names in by_cell.items() if "oracle_ms.train" in names] == ["train_depthnet"]
    assert set(NEW) <= by_cell["train_depthnet"] and set(NEW) - {"oracle_ms.train"} <= by_cell["train_nerf"]
    assert not set(NEW) & (by_cell["render_depthnet"] | by_cell["render_full"])


@pytest.mark.parametrize("cell", ["train_nerf", "render_depthnet"])
def test_a_traced_cpu_run_reports_none_of_them(cell):
    wl, cfg = SMALL[cell]
    wl = {**wl, "trace_chunks": [0, 1]} if cell.startswith("train") else {**wl, "trace_frames": [0, 1]}
    profiling.reset()
    out = run_cell(cell, 2**31 + 5, 0.0, True, require_card=False, device="cpu", workload_overrides=wl,
                   config_overrides=cfg)
    assert out["correct"] and not set(NEW) & set(out["metrics"])
    if cell == "train_nerf":  # the slice's chunk was recorded, as host spans
        assert profiling.recorded()["nst.dispatch.run"]["calls"] == 1
