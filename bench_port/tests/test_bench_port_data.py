"""Every data file the harness finds by name loads, and BENCHMARK.json keeps to its contract's shape."""

import os
import re

import pytest

from bench_port import harness
from bench_port.harness import HERE, ROOT, benchmark, checkpoint, load_file_module, load_json
from bench_port.reference.weights import read_params

BENCH = benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHECKS = {"render_frames": {"rgb_mse", "depth_gap", "acc_gap"},
          "train_chunks": {"loss_gap", "loss1_gap", "img_loss1_gap", "grad_gap", "grad_median_gap", "change_gap",
                           "change_median_gap", "targets_apart"}}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"] and BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"} and NAME.match(entry["name"])
    assert entry["file"] == f"bench_port/configs/{entry['name']}.json"
    cfg = load_json("configs", entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert checkpoint(cfg)["fine"]["pts_linears"][0]["weight"].shape == (63, 256)


def test_a_checkpoint_that_is_not_the_named_one_is_refused(tmp_path):
    cfg = load_json("configs", "lego_nerf")
    copy = tmp_path / "ckpt.npz"
    data = bytearray(open(os.path.join(ROOT, cfg["checkpoint"]), "rb").read())
    data[-1] ^= 1
    copy.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="sha256"):
        read_params(str(copy), cfg["checkpoint_sha256"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    wl = load_json("workloads", entry["traffic"])
    assert wl["config"] == entry["config"]
    assert os.path.exists(os.path.join(HERE, "drivers", f"{wl['driver']}.py"))
    assert set(wl["limits"]) <= CHECKS[wl["driver"]]
    for part, net, *_ in wl["work"]:
        assert os.path.exists(os.path.join(HERE, "work", f"{part}.py"))
        assert net is None or net in load_json("configs", wl["config"])
    reported = [m for m in BENCH["end_to_end"] if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metrics(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert callable(load_file_module("metrics", metric["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "moves" in metric:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    else:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25


def test_every_cell_reports_a_per_layer_metric():
    for w in BENCH["workloads"]:
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_the_harness_reads_every_metric_it_lists():
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics")) if f.endswith(".py")}
    assert listed == files
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "nerf_sampling_tpu")
