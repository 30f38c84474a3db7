"""Where a DepthNet run's peak device memory goes, eval by eval: the probe
that attributed gate (b)'s peak growth in ``scripts/torch_r5.py gate``'s
A4 and A5 LINEMOD runs.

    python3 scripts/torch_r5_memory.py

Trains A5's LINEMOD NeRF for 2,500 steps and its DepthNet against that
checkpoint for 7,500 (the arm's own commands, with the counts replaced,
under ``logs/torch_r5_memory/``). Around every eval and checkpoint of the
DepthNet run it prints the peak device memory of the phase before it and
within it, the memory allocated at its start and end, and the device
memory that ``Trainer.eval_params`` (the last eval's packs) holds; after
the first eval, the allocations that eval made and kept, grouped by the
Python stack that made them (``torch.cuda.memory``'s allocation history).
Needs the card.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_r5  # noqa: E402

MB = 2**20
BASEDIR = "logs/torch_r5_memory"


def held_mib(params) -> float:
    """Device memory of the tensors in ``params.kernels`` (each storage once)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.is_cuda and x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    if params is not None and params.kernels is not None:
        walk(tuple(params.kernels))
    return total / MB


def kept(snapshot: dict, top: int = 12) -> None:
    """Print the traced allocations not freed by the snapshot, by stack."""
    live = {}
    for e in snapshot["device_traces"][0]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    groups = collections.Counter()
    for e in live.values():
        frames = [f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}" for f in e.get("frames", [])
                  if f["filename"].endswith(".py")][:5]
        groups[" < ".join(frames) or "(no Python frame)"] += e["size"]
    print(f"[memory] the first eval kept {sum(groups.values()) / MB:.2f} MiB in {len(live)} blocks")
    for stack, size in groups.most_common(top):
        print(f"[memory]   {size / MB:9.2f} MiB  {stack}")


@contextlib.contextmanager
def probe(trainer_cls):
    """The Trainer's eval and checkpoint wrapped with the per-phase readings
    while the block runs."""
    evals = {"n": 0}

    def around(name, fn):
        def wrapped(self, *a, **k):
            before_peak, at_start = torch.cuda.max_memory_allocated() / MB, torch.cuda.memory_allocated() / MB
            torch.cuda.reset_peak_memory_stats()
            held = held_mib(self.eval_params)
            first = name == "eval" and evals["n"] == 0
            if first:
                torch.cuda.memory._record_memory_history(max_entries=500000)
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            if name == "eval":
                evals["n"] += 1
            print(f"[memory] {name} at step {self.global_step}: peak before {before_peak:.2f} MiB, in it "
                  f"{torch.cuda.max_memory_allocated() / MB:.2f}; allocated {at_start:.2f} -> "
                  f"{torch.cuda.memory_allocated() / MB:.2f}; eval_params holds {held:.2f}", flush=True)
            if first:
                kept(torch.cuda.memory._snapshot())
                torch.cuda.memory._record_memory_history(enabled=None)
            torch.cuda.reset_peak_memory_stats()
            return out
        return wrapped

    eval_testset, save_checkpoint = trainer_cls.eval_testset, trainer_cls.save_checkpoint
    trainer_cls.eval_testset = around("eval", eval_testset)
    trainer_cls.save_checkpoint = around("save", save_checkpoint)
    try:
        yield
    finally:
        trainer_cls.eval_testset, trainer_cls.save_checkpoint = eval_testset, save_checkpoint


def main() -> int:
    if not torch.cuda.is_available():
        print("[memory] needs a CUDA device", file=sys.stderr)
        return 2
    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.train import trainer

    os.chdir(torch_r5.REPO)
    steps = {s.name: s for s in torch_r5.arms()["A5"].steps}

    def command(name: str, n_iters: int, ft_path: str | None = None) -> list[str]:
        argv = list(steps["linemod_" + name].argv)
        for flag, value in (("--basedir", BASEDIR), ("--n_iters", str(n_iters)), ("--ft_path", ft_path)):
            if value is not None:
                argv[argv.index(flag) + 1] = value
        return argv

    nerf = run.main(command("nerf", 2500))
    ckpt = sorted(glob.glob(os.path.join(nerf.expdir, "[0-9]*.npz")))[-1]  # its newest checkpoint
    del nerf
    with probe(trainer.Trainer):
        torch.cuda.reset_peak_memory_stats()
        run.main(command("depth", 7500, ckpt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
