"""Run one cell of the port's benchmark and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s entry of that name; its data file
``bench_port/workloads/<cell>.json`` names the configuration and the
driver. The run sets up the system under test (``nerf_sampling_tpu_torch``)
from the seed, measures ``--seconds`` of its work (with ``--trace 1``, a
slice of it under the profiler), checks what the window produced against
the plain reference, and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; the compared numbers beside their
limits last, there and on standard error.

It exits non-zero with no result when no CUDA card (or fewer than the cell
asks for) is visible, and when a module of JAX or of the JAX package is
loaded in this process once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# every build and kernel cache at a fixed path inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(_ROOT, ".bench_cache", _dir))
os.environ.setdefault("USE_FLAX", "0")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell`` reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reported(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        return kind == "end_to_end" or reported(e2e[m["moves"]])

    return [m for m in bench[kind] if reported(m)]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, require_card: bool = True,
             device: str | None = None, workload_overrides: dict | None = None,
             config_overrides: dict | None = None) -> dict | None:
    """One run of cell ``name``: the result dict (and its checks), or None
    (after saying why on standard error) when it cannot run here.
    ``require_card=False``, a ``device`` and the overrides (merged into its
    traffic and its configuration) are for the tests, which drive it on the
    CPU at small sizes."""
    from bench_port import harness
    from bench_port.harness import Spans, device_info, emit, forbidden_modules, load_file_module, load_json, work
    from bench_port.trace import Tracer

    t_start = harness.process_start()
    import torch

    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        print(f"no cell {name!r} in BENCHMARK.json", file=sys.stderr)
        return None
    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {name!r} needs {entry['chips']} CUDA card(s); {n} visible", file=sys.stderr)
        return None
    dev = torch.device(device or "cuda")
    wl = load_json("workloads", name)
    if workload_overrides:
        wl = {**wl, "traffic": {**wl["traffic"], **workload_overrides}}
    cfg = {**load_json("configs", wl["config"]), **(config_overrides or {})}
    driver = importlib.import_module(f"bench_port.drivers.{wl['driver']}")

    t_imported = time.time()
    torch.empty(0, device=dev)  # the device's context
    t_context = time.time()
    spans = Spans()
    cell = driver.Cell(wl, cfg, seed, dev, spans)
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t_start
    print(f"set-up {setup_s:.3f} s: to the driver imported {t_imported - t_start:.3f}, device context "
          f"{t_context - t_imported:.3f}, cell {setup_s - (t_context - t_start):.3f}", file=sys.stderr)
    spans.seconds.clear()
    tracer = Tracer(trace, dev)
    stats = cell.window(seconds, tracer)
    device = device_info(dev)
    cell.release()
    checks = cell.check()

    unit_flops, unit_bytes = work(wl["work"], cfg, stats["rays"] / stats["units"])
    run = {**stats, "setup_s": setup_s, "spans": spans, "trace": tracer.result,
           "unit_flops": unit_flops, "unit_bytes": unit_bytes}
    metrics = {}
    for m in cell_metrics(bench, name, "per_layer" if trace else "end_to_end"):
        value = load_file_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return None
    result = {"correct": all(c.ok for c in checks), "attempted": stats["attempted"], "failed": stats["failed"],
              "metrics": metrics, "device": device}
    if trace and tracer.result is not None:
        result["device"] = {**device, "busy_s": tracer.result["busy_s"], "window_s": tracer.result["window_s"]}
        result["breakdown"] = {"device_ops": tracer.result["device_ops"], "idle_gaps": tracer.result["idle_gaps"]}
    emit(result, checks)
    return dict(result, checks=checks)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    return 0 if out is not None else 1


if __name__ == "__main__":
    sys.exit(main())
