"""Two checkouts' train step time on one card, in interleaved windows of one long-lived process each.

    python3 scripts/ab_train_windows.py CELL SEED ROOT_A ROOT_B [--pairs 10] [--seconds 8] [--out FILE]

Each checkout's process sets the train cell up once, as ``bench_port/run.py`` does (the same
seed on both sides), then waits. The two then run ``--pairs`` pairs of windows of ``--seconds``
each through the benchmark's own window (``Cell.window``, no trace), one process at a time, the
order turned at every pair (A B, B A, ...), so that both see the same card, clocks and power.
A window's ``train_step_ms`` is the benchmark's: its wall ms over the steps it completed. Prints
each pair and the medians; each process ends with the benchmark's checks (``correct``). Set-up
costs once a side, so many pairs are cheap next to as many runs of ``bench_port/run.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TAG = "AB "


def worker(root: str, cell_name: str, seed: int) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import bench_port.run  # noqa: F401  (its build caches inside the checkout)
    import torch

    from bench_port.harness import Spans, load_json
    from bench_port.trace import Tracer
    from bench_port.drivers import train_chunks

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    wl = load_json("workloads", cell_name)
    cell = train_chunks.Cell(wl, load_json("configs", wl["config"]), seed, dev, Spans())
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(TAG + json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        words = line.split()
        if words[0] == "window":
            stats = cell.window(float(words[1]), Tracer(False, dev))
            print(TAG + json.dumps({"train_step_ms": 1e3 * stats["window_s"] / stats["units"],
                                    "failed": stats["failed"]}), flush=True)
        else:
            break
    cell.release()
    checks = cell.check()
    print(TAG + json.dumps({"correct": all(c.ok for c in checks)}), flush=True)


def reply(p: subprocess.Popen) -> dict:
    for line in p.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
    raise RuntimeError(f"the process in {p.args[-3]} ended with no reply (rc {p.wait()})")


def quartile_spread(xs: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / q2


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3], int(sys.argv[4]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    roots = {"A": os.path.abspath(args.root_a), "B": os.path.abspath(args.root_b)}
    procs = {k: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", r, args.cell, str(args.seed)],
                                 cwd=r, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
             for k, r in roots.items()}
    try:
        for p in procs.values():
            reply(p)
        ms: dict[str, list[float]] = {"A": [], "B": []}
        failed = 0
        for i in range(args.pairs):
            for k in ("A", "B") if i % 2 == 0 else ("B", "A"):
                procs[k].stdin.write(f"window {args.seconds}\n")
                procs[k].stdin.flush()
                r = reply(procs[k])
                ms[k].append(r["train_step_ms"])
                failed += r["failed"]
            print(f"pair {i}: A {ms['A'][-1]:.4f} B {ms['B'][-1]:.4f} ms a step, B/A {ms['B'][-1] / ms['A'][-1] - 1:+.4%}",
                  flush=True)
        correct = {}
        for k, p in procs.items():
            p.stdin.write("quit\n")
            p.stdin.flush()
            correct[k] = reply(p)["correct"]
            p.wait()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ratios = [b / a - 1 for a, b in zip(ms["A"], ms["B"])]
    out = {"cell": args.cell, "seed": args.seed, "seconds": args.seconds, "roots": roots, "ms": ms,
           "median": {k: statistics.median(v) for k, v in ms.items()},
           "spread": {k: quartile_spread(v) for k, v in ms.items()} if args.pairs >= 2 else None,
           "pair_ratios": ratios, "median_pair_ratio": statistics.median(ratios), "failed": failed,
           "correct": correct}
    print(f"## {args.cell}: median A {out['median']['A']:.4f} B {out['median']['B']:.4f} ms a step; "
          f"median pair B/A {out['median_pair_ratio']:+.4%}, pairs {min(ratios):+.4%} to {max(ratios):+.4%}; "
          f"spread {out['spread']}; failed {failed}; correct {correct}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(out, fp, indent=1)
    return 0 if all(correct.values()) and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
