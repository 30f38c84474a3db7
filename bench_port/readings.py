"""The readings that each limit of ``correct`` is set from, in one process.

    python3 bench_port/readings.py <cell> --seeds 1,2,3 [--variants program,control] [--faults half,altered]

For every seed and variant (the program as the configuration states it,
or a control: a lower precision in its place) and every planted fault
(``faults.py``), the cell is set up from the seed as a run sets it up, does
as much as a run compares (a render cell renders its sampled frames; a
train cell's set-up runs the steps the reference follows), and the numbers
of its check are printed, one JSON line each, then the largest of each
number over the program's seeds (the lower reading) and the smallest over
each control's and fault's (the upper readings). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(name: str, seed: int, variant: str = "program", fault: str | None = None, device: str = "cuda",
             workload_overrides: dict | None = None, config_overrides: dict | None = None) -> dict[str, float]:
    """The check's numbers of one setting (and the seconds its check took under ``check_s``)."""
    import torch

    from bench_port import faults
    from bench_port.harness import Spans, load_json

    wl = load_json("workloads", name)
    if workload_overrides:
        wl = {**wl, "traffic": {**wl["traffic"], **workload_overrides}}
    cfg = {**load_json("configs", wl["config"]), **(config_overrides or {})}
    driver = importlib.import_module(f"bench_port.drivers.{wl['driver']}")
    dev = torch.device(device)
    with faults.plant(fault, wl["driver"]) if fault else contextlib.nullcontext():
        cell = driver.Cell(wl, cfg, seed, dev, Spans(), variant)
        cell.setup()
        if wl["driver"] == "render_frames":
            cell.run_frames(wl["traffic"]["check_frames"])
        cell.release()
    t0 = time.perf_counter()
    out = cell.gaps()
    out["check_s"] = time.perf_counter() - t0
    return {**out, **getattr(cell, "detail", {})}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    settings = [(v, None) for v in args.variants.split(",") if v] + [("program", f) for f in args.faults.split(",") if f]
    table: dict[str, list[dict]] = {}
    for variant, fault in settings:
        key = variant if fault is None else f"fault:{fault}"
        for seed in seeds:
            r = readings(args.cell, seed, variant, fault)
            table.setdefault(key, []).append(r)
            print(json.dumps({"cell": args.cell, "setting": key, "seed": seed, **r}), flush=True)
    for key, rows in table.items():
        names = [k for k, v in rows[0].items() if k != "check_s" and isinstance(v, float)]
        agg = max if key == "program" else min
        print(json.dumps({"cell": args.cell, "setting": key, "reading": "max" if key == "program" else "min",
                          **{n: agg(r[n] for r in rows) for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
