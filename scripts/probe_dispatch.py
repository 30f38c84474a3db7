"""Where a train chunk's host time goes, from the port's own recorder, with and without CUPTI.

    python3 scripts/probe_dispatch.py CELL SEED [--chunks N] [--out FILE]

CELL is a train cell of ``BENCHMARK.json`` (``train_depthnet``, ``train_nerf``): the cell is set
up as the benchmark sets it up (``bench_port/drivers/train_chunks.py``), warmed for a few chunks,
then run N chunks at a time, the next chunk sampled while the device runs the last, in three
ways:

- ``none``: no profiler, the recorder off; the wall clock alone;
- ``host``: torch.profiler of the host alone (no CUDA activity, so no CUPTI callback on the
  launches): the recorder on, its launch times and launch queue as with no profiler;
- ``card``: torch.profiler of the host and the card, as the benchmark's traced slice runs.

For each it prints the wall ms a step and, where the recorder is on, the host ms a step in
``StepDispatcher.run`` (``nst.dispatch.run``), the host ms a replay inside ``graph.replay()``
(``nst.dispatch.launch`` over ``nst.dispatch.replays``), the steps still queued on the device
when ``run`` returns (``nst.dispatch.queued_steps``, the mean over the chunks) and the device ms
of each phase of the chunks' last steps (``nst.step.<phase>``). Last, it times the captured step
on the device, back to back, as replayed with no profiler and as the recorder's timed copy with
its phase events (the device cost of the events while the recorder is on). It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def chunks(cell, n: int) -> float:
    """Runs n chunks; their wall ms a step."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        cell._run(*cell.chunk, overlap=cell._next_chunk)
    return 1e3 * (time.perf_counter() - t0) / (n * cell.K)


def recorder_numbers(n: int, K: int) -> dict:
    from nerf_sampling_tpu_torch.utils import profiling

    t = profiling.recorded()
    out = {"run_ms_a_step": 1e3 * t["nst.dispatch.run"]["seconds"] / (n * K),
           "launch_ms": 1e3 * t["nst.dispatch.launch"]["seconds"] / t["nst.dispatch.replays"]["total"],
           "queued_steps": t["nst.dispatch.queued_steps"]["total"] / t["nst.dispatch.queued_steps"]["calls"]}
    for name, e in t.items():
        if name.startswith("nst.step.") and "total" in e:
            out[name[len("nst.step."):] + "_ms"] = e["total"] / e["calls"]
    return out


def replay_ms(g, timed: bool, n: int) -> float:
    """Device ms a replay of the step's graph, n replays back to back."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    graph = g.timed if timed else g.graph
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()

    import bench_port.run  # noqa: F401  (its build caches inside the checkout)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_port.drivers import train_chunks
    from bench_port.harness import Spans, load_json
    from nerf_sampling_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    wl = load_json("workloads", args.cell)
    cell = train_chunks.Cell(wl, load_json("configs", wl["config"]), args.seed, dev, Spans())
    cell.setup()
    chunks(cell, 4)  # the sampler's first visits
    n, K = args.chunks, cell.K
    result = {"cell": args.cell, "seed": args.seed, "chunks": n, "K": K,
              "device": torch.cuda.get_device_name(dev), "torch": torch.__version__,
              "memory_reserved_bytes": torch.cuda.max_memory_reserved(dev)}
    modes = {"none": contextlib.nullcontext,
             "host": lambda: profile(activities=[ProfilerActivity.CPU]),
             "card": lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])}
    for mode, window in modes.items():
        profiling.reset()
        with window():
            wall = chunks(cell, n)
        row = {"wall_ms_a_step": wall, **(recorder_numbers(n, K) if mode != "none" else {})}
        result[mode] = row
        print(f"## {args.cell} {mode}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    g = next(iter(cell.dispatcher._graphs.values()))
    rounds = {"plain": [], "timed": []}
    for _ in range(8):
        for name in rounds:
            rounds[name].append(replay_ms(g, name == "timed", 50))
    plain, timed = (statistics.median(rounds[k][2:]) for k in ("plain", "timed"))  # the clocks settle first
    result["replay_ms"] = {"plain": plain, "timed": timed, "rounds": rounds}
    print(f"## {args.cell} replay, device ms: plain {plain:.4f}, timed {timed:.4f} "
          f"({1e3 * (timed - plain):+.2f} us, {100 * (timed / plain - 1):+.3f}%); "
          f"memory reserved {result['memory_reserved_bytes'] / 2**30:.2f} GiB", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(result, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
