"""The round-5 horizon and format runs on the port: the recipes of
``scripts/r5_*.sh`` driven through ``nerf_sampling_tpu_torch``.

    python3 scripts/torch_r5.py list              # the arms and their commands
    python3 scripts/torch_r5.py run A1            # train and render one arm (on the card)
    python3 scripts/torch_r5.py gate A1           # its cells on the plain fp32 path; gates (a) and (b)
    python3 scripts/torch_r5.py summary           # evidence/torch_r5/summary.json

An arm is a list of commands of ``python -m
nerf_sampling_tpu_torch.experiments.run`` and ``... .render``, each with
the flags and values of its line in the JAX script it comes from
(``Step.source``). ``--mlp_impl pallas`` becomes ``cuda``, and a JAX path
``logs/<p>`` becomes ``logs/torch_r5/<p>``: a JAX line without
``--basedir`` (whose logs went to ``./logs``) gets ``--basedir
logs/torch_r5``. The commands run in this process, one after another, so
the kernels build once; each one's record (wall time, steps, the
Trainer's resolved ``steps_per_dispatch`` and captured graph count, the
peak device memory, every step's loss checked finite) goes to
``logs/torch_r5/steps/<arm>/<step>.json``, and its small outputs (records,
``args.txt``, ``psnr.txt``, ``metrics.jsonl``, every ``testset_*/psnr.txt``
and each render's ``psnr.txt``; no checkpoint, no image) to
``evidence/torch_r5/<arm>/<step>/``. ``run`` skips a step whose record
exists, so an arm split across calls picks up where it stopped; a train
run cut in the middle resumes from its newest checkpoint (the Trainer's
resume scan), and its record says so (``start``).

``gate ARM`` reads the arm's evidence and holds (a) every render cell's
kernel PSNR within 0.05 dB of the plain fp32 path's (``--mlp_impl plain``,
rendered once from the same checkpoints and views by the command the
cell's record holds, where its ``psnr_plain.txt`` is not there yet); and
(b) every train run sound: every step's loss and every eval finite, the
run at its count (or its recipe's early stop), on the card K = 100 with
at least one captured graph, each ``best/`` checkpoint the step of the
first best eval, and from the first eval to the last no growth of the
device memory the run holds after an eval nor of its peak (the Trainer's
eval line). A check whose numbers a run did not log is listed under
``not_checked``. It exits 1 when a gate fails. ``summary`` reads
``evidence/torch_r5/`` and the JAX runs' committed evidence (``Step.tpu``,
shown beside, not a target) into ``evidence/torch_r5/summary.json``.

No JAX: the trajectory summary of ``scripts/r5_traj_summary.py`` (best, its
step, final, drift = final - best) is computed here from the
``testset_*/psnr.txt`` files.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import glob
import json
import math
import os
import re
import shlex
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

LOGS = "logs/torch_r5"  # relative to the working directory (the repo root from the command line)
EVIDENCE = "evidence/torch_r5"
GATE_DB = 0.05  # gate (a): kernels against the plain fp32 path (PERF.md section 2)
TPU_GAP_DB = 0.5  # a cell further below its recorded TPU cell is a suspected fault (Queue 3)
EXPECTED_K = 100  # auto steps_per_dispatch at every recipe's cadences (gcd 500-2500)
STEP_MS = {"nerf": 6.989, "depth_net": 4.536, "joint": 10.321}  # captured ms a step (PERF.md section 5)
MODULES = {"run": "nerf_sampling_tpu_torch.experiments.run",
           "render": "nerf_sampling_tpu_torch.experiments.render"}
DENSE_DEEPVOXELS = "example_deepvoxels_dense"  # A7's 100-view scene, beside the one -d example_deepvoxels reads


@dataclasses.dataclass(frozen=True)
class Step:
    """One command of an arm. In ``argv``, ``@ARM/STEP`` stands for the
    checkpoint that run left (``keep``: its newest, or its ``best/`` one
    where there is one, as the JAX script picks it)."""

    name: str
    cli: str  # "run" or "render"
    argv: tuple[str, ...]
    source: tuple[str, int, dict]  # (JAX script, index of its python line, shell values of that line)
    tpu: str | None = None  # the JAX run's committed evidence: an experiment dir or a render's basedir
    keep: str = "best"


@dataclasses.dataclass(frozen=True)
class Arm:
    name: str
    title: str
    steps: tuple[Step, ...]
    optional: bool = False  # run only if chip time remains


def _blender_pretrain(ds: str) -> Step:
    return Step("nerf", "run", (
        "-d", ds, "--mode", "nerf", "--n_iters", "20000", "--mlp_impl", "cuda", "--precision", "high",
        "--seed", "0", "-ip", "2000", "--testskip", "1", "--basedir", LOGS),
        ("scripts/r5_100k.sh", 0, {"DS": ds}), keep="latest")


def _blender_renders(arm: str, ds: str, which: str, nerf: str, depth: str, tpu: bool) -> list[Step]:
    """The three render cells of r5_100k.sh for ``which`` (depth | joint)."""
    steps = []
    for mode, n in (("uniform", "64"), ("uniform", "128")):
        base = f"r5/render_100k_{which}_{ds}_{mode}_{n}"
        steps.append(Step(f"render_{which}_{mode}_{n}", "render", (
            "-d", ds, "-rt", "--testskip", "1", "--ft_path", nerf, "--depth_net_path", depth,
            "--basedir", f"{LOGS}/{base}", "--n_samples", n, "--distance", "1.0", "--sampling_mode", mode,
            "--mlp_impl", "cuda"),
            ("scripts/r5_100k.sh", 3, {"DS": ds, "ARM": which, "1": mode, "2": n}),
            tpu=f"evidence/{base}" if tpu else None))
    base = f"r5/render_100k_{which}_{ds}_full"
    steps.append(Step(f"render_{which}_full", "render", (
        "-d", ds, "-rt", "-nf", "--testskip", "1", "--ft_path", nerf, "--depth_net_path", depth,
        "--basedir", f"{LOGS}/{base}", "--mlp_impl", "cuda"),
        ("scripts/r5_100k.sh", 4, {"DS": ds, "ARM": which}), tpu=f"evidence/{base}" if tpu else None))
    return steps


def _arm_a(arm: str, ds: str, tpu_runs: bool, tpu_renders: bool) -> list[Step]:
    """r5_100k.sh's arm A: the 20k NeRF pretrain, the 100k DepthNet against
    it frozen, and the renders of its best checkpoint."""
    base = f"r5_100k_depth_{ds}"
    depth = Step("depth", "run", (
        "-d", ds, "--mode", "depth_net", "-m", "recommended_depth_net_module", "--n_iters", "100000",
        "--mlp_impl", "cuda", "--ft_path", f"@{arm}/nerf", "--seed", "0", "--basedir", f"{LOGS}/{base}",
        "-ip", "5000", "--i_testset", "5000", "--testskip", "1"),
        ("scripts/r5_100k.sh", 1, {"DS": ds}), tpu=f"evidence/{base}/{ds}_depth_net" if tpu_runs else None)
    return [_blender_pretrain(ds), depth] + _blender_renders(arm, ds, "depth", f"@{arm}/nerf", f"@{arm}/depth", tpu_renders)


def _arm_b(arm: str, ds: str, tpu_runs: bool, tpu_renders: bool) -> list[Step]:
    """r5_100k.sh's arm B: warm-joint 100k from scratch and its renders."""
    base = f"r5_100k_joint_{ds}"
    joint = Step("joint", "run", (
        "-d", ds, "--mode", "joint", "-m", "recommended_depth_net_module", "--n_iters", "100000",
        "--mlp_impl", "cuda", "--precision", "high", "--seed", "0", "--basedir", f"{LOGS}/{base}",
        "-ip", "5000", "--i_testset", "5000", "--testskip", "1", "--joint_depth_warmup", "2000"),
        ("scripts/r5_100k.sh", 2, {"DS": ds}), tpu=f"evidence/{base}/{ds}_nerf" if tpu_runs else None)
    return [joint] + _blender_renders(arm, ds, "joint", f"@{arm}/joint", f"@{arm}/joint", tpu_renders)


def _format_arm(arm: str, script: str, ds: str, module: str, nerf_extra: tuple, depth_ip: str,
                cells: tuple, distance: str, data: tuple | None = None, tag: str | None = None,
                prefix: str = "") -> list[Step]:
    """The NeRF pretrain (20k), the DepthNet (10k) against its best
    checkpoint, and the three renders of r5_llff.sh, r5_other_formats.sh
    and r5_deepvoxels_dense.sh (``data``: ``-dp DIR`` in place of ``-d``)."""
    data = data or ("-d", ds)
    tag = tag or ds
    base = {"scripts/r5_llff.sh": "r5_llff", "scripts/r5_other_formats.sh": f"r5_{ds}",
            "scripts/r5_deepvoxels_dense.sh": "r5_deepvoxels100"}[script]
    shell = {"DS": ds, "M": module} if script == "scripts/r5_other_formats.sh" else {"DS": ds}  # run_fmt's arguments
    expname = "custom" if data[0] == "-dp" else ds
    tpu = script != "scripts/r5_deepvoxels_dense.sh"
    steps = [
        Step(f"{prefix}nerf", "run", (
            *data, "--mode", "nerf", "-m", module, "--n_iters", "20000", "--mlp_impl", "cuda",
            "--precision", "high", "--seed", "0", "--basedir", f"{LOGS}/{base}", "-ip", "2000", *nerf_extra),
            (script, 0, shell), tpu=f"evidence/{base}/{expname}_nerf" if tpu else None),
        Step(f"{prefix}depth", "run", (
            *data, "--mode", "depth_net", "-m", module, "--n_iters", "10000", "--mlp_impl", "cuda",
            "--ft_path", f"@{arm}/{prefix}nerf", "--seed", "0", "--basedir", f"{LOGS}/{base}", "-ip", depth_ip),
            (script, 1, shell), tpu=f"evidence/{base}/{expname}_depth_net" if tpu else None),
    ]
    refs = ("--ft_path", f"@{arm}/{prefix}nerf", "--depth_net_path", f"@{arm}/{prefix}depth")
    for mode, n in cells:
        cell = f"r5/render_{tag}_{mode}_{n}"
        steps.append(Step(f"{prefix}render_{mode}_{n}", "render", (
            *data, "-rt", "-m", module, *refs, "--basedir", f"{LOGS}/{cell}", "--n_samples", n,
            "--distance", distance, "--sampling_mode", mode, "--mlp_impl", "cuda"),
            (script, 2, {**shell, "1": mode, "2": n}), tpu=f"evidence/{cell}" if tpu else None))
    cell = f"r5/render_{tag}_full"
    steps.append(Step(f"{prefix}render_full", "render", (
        *data, "-rt", "-nf", "-m", module, *refs, "--basedir", f"{LOGS}/{cell}", "--mlp_impl", "cuda"),
        (script, 3, shell), tpu=f"evidence/{cell}" if tpu else None))
    return steps


def dense_deepvoxels_dir() -> str:
    """A7's scene directory, relative to the repo root like every path here."""
    from nerf_sampling_tpu_torch.definitions import DATASET_DIR

    return os.path.relpath(os.path.join(DATASET_DIR, DENSE_DEEPVOXELS), REPO)


def arms() -> dict[str, Arm]:
    """The arms in their order: A1-A5, then A6 and A7 if chip time remains."""
    uniform = (("uniform", "64"), ("uniform", "128"))
    other = "scripts/r5_other_formats.sh"
    return {a.name: a for a in (
        Arm("A1", "example: NeRF 20k, DepthNet 100k (arm A), renders", tuple(_arm_a("A1", "example", True, True))),
        Arm("A2", "example: warm-joint 100k from scratch (arm B), renders", tuple(_arm_b("A2", "example", True, True))),
        Arm("A3", "example_hard: arms A and B, renders",
            tuple(_arm_a("A3", "example_hard", True, False) + _arm_b("A3", "example_hard", False, False))),
        Arm("A4", "example_llff (NDC): NeRF 20k, DepthNet 10k, renders", tuple(_format_arm(
            "A4", "scripts/r5_llff.sh", "example_llff", "llff_depth_net_module", ("--i_testset", "2500"), "1000",
            (("gaussian", "64"), ("gaussian", "128")), "0.25", tag="llff"))),
        Arm("A5", "example_linemod and example_deepvoxels: NeRF 20k, DepthNet 10k, renders each", tuple(
            _format_arm("A5", other, "example_linemod", "linemod_depth_net_module", ("--i_testset", "5000"), "1000",
                        uniform, "1.0", tag="example_linemod", prefix="linemod_")
            + _format_arm("A5", other, "example_deepvoxels", "deepvoxels_depth_net_module",
                          ("--i_testset", "5000"), "1000", uniform, "1.0", tag="example_deepvoxels",
                          prefix="deepvoxels_"))),
        Arm("A6", "parity objective: DepthNet 100k on A1's and A3's pretrains", tuple(
            Step(f"parity_{ds}", "run", (
                "-d", ds, "--mode", "depth_net", "-m", "parity_horizon_module", "--n_iters", "100000",
                "--mlp_impl", "cuda", "--ft_path", f"@{pre}/nerf", "--seed", "0",
                "--basedir", f"{LOGS}/r5_100k_parity_{ds}", "-ip", "5000", "--testskip", "1"),
                ("scripts/r5_100k_parity.sh", 0, {"DS": ds}))
            for ds, pre in (("example", "A1"), ("example_hard", "A3"))), optional=True),
        Arm("A7", "example_deepvoxels at 100 views: NeRF 20k, DepthNet 10k, renders", tuple(_format_arm(
            "A7", "scripts/r5_deepvoxels_dense.sh", "example_deepvoxels", "deepvoxels_depth_net_module",
            ("--i_testset", "5000"), "1000", uniform, "1.0", data=("-dp", dense_deepvoxels_dir()),
            tag="deepvoxels100")), optional=True),
    )}


# ---------------------------------------------------------------- reading runs


def flag(argv, name: str, default=None):
    """The value after ``name`` in ``argv`` (the last one), else ``default``."""
    argv = list(argv)
    idx = [i for i, a in enumerate(argv) if a == name]
    return argv[idx[-1] + 1] if idx else default


def run_expdir(argv) -> str:
    """The experiment directory of a ``run`` command (run.py's naming)."""
    name = flag(argv, "-d")
    mode = flag(argv, "--mode", "depth_net")
    return os.path.join(flag(argv, "--basedir", "./logs"),
                        f"{name or 'custom'}_{'depth_net' if mode == 'depth_net' else 'nerf'}")


def avg_psnr(path: str) -> float | None:
    """The average of a ``psnr.txt`` that render_path wrote ("Avg of N
    images:" then "PSNR: x"), or None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if line.startswith("Avg of") and i + 1 < len(lines) and lines[i + 1].startswith("PSNR:"):
            return float(lines[i + 1].split(":", 1)[1])
    return None


def trajectory(expdir: str) -> dict | None:
    """Each eval's average PSNR from ``testset_*/psnr.txt``, with best (the
    first maximum), its step, final and drift = final - best
    (scripts/r5_traj_summary.py's table), or None without evals."""
    evals = []
    for d in sorted(glob.glob(os.path.join(expdir, "testset_*"))):
        p = avg_psnr(os.path.join(d, "psnr.txt"))
        if p is not None:
            evals.append((int(os.path.basename(d).split("_")[1]), p))
    if not evals:
        return None
    best_step, best = max(evals, key=lambda e: e[1])  # max keeps the first of equal values
    final = evals[-1][1]
    return {"evals": evals, "best": best, "best_step": best_step, "final": final, "final_step": evals[-1][0],
            "drift": final - best}


def render_psnr(basedir: str) -> float | None:
    """The average PSNR of the render under ``basedir``."""
    found = sorted(glob.glob(os.path.join(basedir, "*", "renderonly_test_*", "psnr.txt")))
    return avg_psnr(found[-1]) if found else None


def checkpoint(arm: str, step_name: str, table: dict[str, Arm] | None = None) -> str:
    """The checkpoint run ``arm/step_name`` left, picked as its JAX script
    picks it: the newest, or with keep="best" the newest under ``best/``
    where there is one."""
    step = {s.name: s for s in (table or arms())[arm].steps}[step_name]
    expdir = run_expdir(step.argv)
    pattern = "depth_*.npz" if flag(step.argv, "--mode") == "depth_net" else "[0-9]*.npz"
    found = []
    if step.keep == "best":
        found = sorted(glob.glob(os.path.join(expdir, "best", pattern)))
    found = found or sorted(glob.glob(os.path.join(expdir, pattern)))
    if not found:
        raise FileNotFoundError(f"no checkpoint of {arm}/{step_name} under {expdir}: run {arm} first")
    return found[-1]


def resolve(argv, table: dict[str, Arm], n_iters: int | None = None, device: str = "cuda") -> list[str]:
    """``argv`` with each ``@ARM/STEP`` replaced by that run's checkpoint,
    ``--n_iters`` by ``n_iters`` where given, and ``--device`` added off the card."""
    out = []
    for a in argv:
        if a.startswith("@"):
            arm, name = a[1:].split("/")
            a = checkpoint(arm, name, table)
        out.append(a)
    if n_iters is not None and "--n_iters" in out:
        out[out.index("--n_iters") + 1] = str(n_iters)
    if device != "cuda":
        out += ["--device", device]
    return out


def command_line(cli: str, argv) -> str:
    return f"python -m {MODULES[cli]} {shlex.join(argv)}"


def card() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def record_path(arm: str, name: str) -> str:
    return os.path.join(LOGS, "steps", arm, f"{name}.json")


def evidence_dir(arm: str, name: str) -> str:
    return os.path.join(EVIDENCE, arm, name)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


# ---------------------------------------------------------------- running


@contextlib.contextmanager
def watch_steps():
    """Counts every logged train step and the ones whose loss is not
    finite (the Trainer's ``log`` sees each step's metrics)."""
    from nerf_sampling_tpu_torch.train import trainer as trainer_mod

    seen = {"steps": 0, "nonfinite_losses": 0, "first_nonfinite": None}
    log = trainer_mod.Trainer.log

    def counted(self, i, metrics, timer=None):
        seen["steps"] += 1
        if not math.isfinite(float(metrics["loss"])):
            seen["nonfinite_losses"] += 1
            seen["first_nonfinite"] = seen["first_nonfinite"] or i
        return log(self, i, metrics, timer)

    trainer_mod.Trainer.log = counted
    try:
        yield seen
    finally:
        trainer_mod.Trainer.log = log


def launch_counts() -> dict[str, int]:
    """The kernels' launch counts (``kernels.build.launches``), keyed
    "<kernel>.<precision>"."""
    from nerf_sampling_tpu_torch.kernels import build

    return {f"{k}.{p}": v for (k, p), v in build.launches.items()}


def execute(cli: str, argv: list[str]) -> dict:
    """Run one command in this process; its record."""
    import torch

    from nerf_sampling_tpu_torch.experiments import render, run

    on_card = torch.cuda.is_available() and flag(argv, "--device", "cuda") == "cuda"
    print(f"[torch_r5] {command_line(cli, argv)}", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    counts = launch_counts()
    t0 = time.perf_counter()
    with watch_steps() as seen:
        trainer = (run if cli == "run" else render).main(argv)
    if on_card:
        torch.cuda.synchronize()
    rec = {"command": command_line(cli, argv), "wall_s": time.perf_counter() - t0, "card": card(),
           "torch": torch.__version__, "start": trainer.start, "global_step": trainer.global_step,
           "steps_run": seen["steps"], "nonfinite_losses": seen["nonfinite_losses"],
           "first_nonfinite": seen["first_nonfinite"], "steps_per_dispatch": trainer.steps_per_dispatch,
           "captured_graphs": trainer.captured_graphs, "early_stop": trainer._stop_early,
           "max_memory_allocated_mib": torch.cuda.max_memory_allocated() / 2**20 if on_card else None,
           "expdir": os.path.relpath(trainer.expdir),
           "launches": {k: v - counts.get(k, 0) for k, v in launch_counts().items() if v != counts.get(k, 0)}}
    if cli == "run":
        rec["n_iters"] = int(flag(argv, "--n_iters"))
        rec["mode"] = flag(argv, "--mode")
        rec["best_checkpoints"] = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(trainer.expdir, "best", "*.npz")))
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    print(f"[torch_r5] done in {rec['wall_s']:.1f} s: steps {rec['start']} -> {rec['global_step']}, "
          f"steps_per_dispatch {rec['steps_per_dispatch']}, captured graphs {rec['captured_graphs']}, "
          f"peak memory {rec['max_memory_allocated_mib']} MiB, non-finite losses {rec['nonfinite_losses']}",
          flush=True)
    return rec


def _relative_text(path: str) -> str:
    """A copied text file with the working directory's absolute path made relative."""
    with open(path) as f:
        return f.read().replace(os.getcwd() + os.sep, "")


def collect(arm: str, step: Step, argv: list[str], rec: dict, suffix: str = "") -> None:
    """The step's record and small outputs into ``evidence/torch_r5/<arm>/<step>/``."""
    out = evidence_dir(arm, step.name)
    os.makedirs(out, exist_ok=True)
    if step.cli == "run":
        expdir = run_expdir(argv)
        for name in ("args.txt", "psnr.txt", "metrics.jsonl"):
            if os.path.exists(os.path.join(expdir, name)):
                with open(os.path.join(out, name), "w") as f:
                    f.write(_relative_text(os.path.join(expdir, name)))
        for p in sorted(glob.glob(os.path.join(expdir, "testset_*", "psnr.txt"))):
            dst = os.path.join(out, os.path.basename(os.path.dirname(p)))
            os.makedirs(dst, exist_ok=True)
            shutil.copy(p, os.path.join(dst, "psnr.txt"))
    else:
        found = sorted(glob.glob(os.path.join(flag(argv, "--basedir"), "*", "renderonly_test_*", "psnr.txt")))
        if not suffix:  # a new kernel render: the plain one of the old checkpoint no longer pairs with it
            for old in ("psnr_plain.txt", "step_plain.json"):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(os.path.join(out, old))
        if found:
            shutil.copy(found[-1], os.path.join(out, f"psnr{suffix}.txt"))
    write_json(os.path.join(out, f"step{suffix}.json"), rec)


def run_arm(name: str, n_iters: int | None = None, device: str = "cuda") -> None:
    """Run arm ``name``'s commands in order, skipping those already done;
    ``n_iters`` replaces every run's count (a rehearsal off the card)."""
    table = arms()
    if name == "A7" and not os.path.exists(dense_deepvoxels_dir()):
        from nerf_sampling_tpu_torch.data.example import generate_example_deepvoxels_dataset

        generate_example_deepvoxels_dataset(dense_deepvoxels_dir(), n_train=100)
    for step in table[name].steps:
        path = record_path(name, step.name)
        if os.path.exists(path):
            print(f"[torch_r5] {name}/{step.name}: done before ({path}), skipped")
            continue
        argv = resolve(step.argv, table, n_iters, device)
        rec = {"arm": name, "step": step.name, **execute(step.cli, argv)}
        write_json(path, rec)
        collect(name, step, argv, rec)


# ---------------------------------------------------------------- gates


def plain_argv(argv: list[str]) -> list[str]:
    """A render command on the plain fp32 path, into its own basedir."""
    out = list(argv)
    out[out.index("--mlp_impl") + 1] = "plain"
    i = out.index("--basedir") + 1
    out[i] = out[i].replace(f"{LOGS}/r5/", f"{LOGS}/r5_plain/", 1)
    return out


def memory_at_evals(evidence: str) -> dict | None:
    """The device memory on the Trainer's eval lines (``metrics.jsonl``) at
    the first and the last eval: what the run holds after the eval (live,
    where it was logged) and the peak, or None off the card."""
    path = os.path.join(evidence, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [r for r in map(json.loads, f) if "max_memory_allocated_mib" in r]
    if not rows:
        return None
    first, last = rows[0], rows[-1]
    out = {"evals": [first["step"], last["step"]],
           "peak_mib": [first["max_memory_allocated_mib"], last["max_memory_allocated_mib"]],
           "reserved_mib": [first.get("memory_reserved_mib"), last.get("memory_reserved_mib")]}
    out["peak_growth_mib"] = out["peak_mib"][1] - out["peak_mib"][0]
    if "memory_allocated_mib" in first and "memory_allocated_mib" in last:
        out["live_mib"] = [first["memory_allocated_mib"], last["memory_allocated_mib"]]
        out["live_growth_mib"] = out["live_mib"][1] - out["live_mib"][0]
    return out


def check_run(rec: dict, evidence: str) -> dict:
    """Gate (b) for one train run, from its record and its evidence."""
    traj = trajectory(evidence)
    evals = traj["evals"] if traj else []
    best = rec.get("best_checkpoints", [])
    checks = {
        "losses_finite": rec["nonfinite_losses"] == 0,
        "evals_finite": all(math.isfinite(p) for _, p in evals),
        "reached_count": rec["global_step"] == rec["n_iters"] or rec["early_stop"],
    }
    not_checked = []
    if traj is not None and best:
        checks["best_is_first_best_eval"] = int(re.findall(r"\d+", best[-1])[-1]) == traj["best_step"]
    memory = memory_at_evals(evidence)
    if rec["max_memory_allocated_mib"] is not None:  # a run on the card
        checks["captured"] = rec["steps_per_dispatch"] == EXPECTED_K and rec["captured_graphs"] >= 1
        if memory is not None and len(evals) > 1:
            checks["no_peak_growth"] = memory["peak_growth_mib"] <= 0
            if "live_growth_mib" in memory:
                checks["no_live_growth"] = memory["live_growth_mib"] <= 0
            else:
                not_checked.append("no_live_growth: the run's eval lines hold no live memory")
    return {"ok": all(checks.values()), "checks": checks, "not_checked": not_checked,
            "steps": f"{rec['start']} -> {rec['global_step']}", "steps_per_dispatch": rec["steps_per_dispatch"],
            "captured_graphs": rec["captured_graphs"], "memory": memory, "early_stop": rec["early_stop"]}


def gate_arm(name: str) -> bool:
    """Gates (a) and (b) of arm ``name`` from its evidence; writes
    evidence/torch_r5/<arm>/gate.json."""
    results = {}
    for step in arms()[name].steps:
        gate = "b" if step.cli == "run" else "a"
        d = evidence_dir(name, step.name)
        if not os.path.exists(os.path.join(d, "step.json")):
            results[step.name] = {"gate": gate, "ok": False, "why": "not run"}
            continue
        rec = read_json(os.path.join(d, "step.json"))
        if step.cli == "run":
            results[step.name] = {"gate": gate, **check_run(rec, d)}
            continue
        if not os.path.exists(os.path.join(d, "psnr_plain.txt")):
            plain = plain_argv(shlex.split(rec["command"])[3:])  # the command that ran, on the plain path
            prec = {"arm": name, "step": step.name + "_plain", **execute("render", plain)}
            write_json(record_path(name, step.name + "_plain"), prec)
            collect(name, step, plain, prec, suffix="_plain")
        kern, ref = avg_psnr(os.path.join(d, "psnr.txt")), avg_psnr(os.path.join(d, "psnr_plain.txt"))
        ok = kern is not None and ref is not None and abs(kern - ref) <= GATE_DB
        results[step.name] = {"gate": gate, "ok": ok, "cuda": kern, "plain": ref,
                              "delta": None if kern is None or ref is None else kern - ref}
    for step_name, r in results.items():
        print(f"[torch_r5] gate ({r['gate']}) {name}/{step_name}: {'PASS' if r['ok'] else 'FAIL'} "
              + json.dumps({k: v for k, v in r.items() if k not in ('gate', 'ok')}))
    write_json(os.path.join(EVIDENCE, name, "gate.json"), results)
    return all(r["ok"] for r in results.values())


# ---------------------------------------------------------------- summary


def _estimate_s(rec: dict) -> float | None:
    ms = STEP_MS.get(rec.get("mode"))
    return None if ms is None else (rec["global_step"] - rec["start"]) * ms / 1e3


def summary() -> dict:
    """Every cell of the arms that ran, beside its recorded TPU cell."""
    table = arms()
    evidence = EVIDENCE
    out = {"gate_db": GATE_DB, "tpu_gap_db": TPU_GAP_DB,
           "note": "TPU values are the JAX package's recorded round-5 cells (TPU v5e), shown beside, not targets",
           "arms": {}}
    for name, arm in table.items():
        if not os.path.isdir(os.path.join(evidence, name)):
            continue
        gate_path = os.path.join(evidence, name, "gate.json")
        gates = read_json(gate_path) if os.path.exists(gate_path) else {}
        entry = {"title": arm.title, "runs": {}, "cells": {}}
        for step in arm.steps:
            d = os.path.join(evidence, name, step.name)
            if not os.path.exists(os.path.join(d, "step.json")):
                (entry["runs"] if step.cli == "run" else entry["cells"])[step.name] = {"status": "not run"}
                continue
            rec = read_json(os.path.join(d, "step.json"))
            common = {"card": rec["card"], "wall_s": rec["wall_s"], "command": rec["command"]}
            if step.cli == "run":
                port = trajectory(d)
                tpu = trajectory(os.path.join(REPO, step.tpu)) if step.tpu else None
                entry["runs"][step.name] = {
                    **common, "steps_run": rec["global_step"] - rec["start"], "start": rec["start"],
                    "n_iters": rec["n_iters"], "early_stop": rec["early_stop"],
                    "steps_per_dispatch": rec["steps_per_dispatch"], "captured_graphs": rec["captured_graphs"],
                    "estimate_s": _estimate_s(rec), "nonfinite_losses": rec["nonfinite_losses"],
                    "max_memory_allocated_mib": rec["max_memory_allocated_mib"],
                    "memory_at_evals": gates.get(step.name, {}).get("memory"),
                    "port": {k: v for k, v in port.items() if k != "evals"} if port else None,
                    "port_evals": port["evals"] if port else None,
                    "tpu": {k: v for k, v in tpu.items() if k != "evals"} if tpu else None,
                    "gate_b": gates.get(step.name, {}).get("ok")}
                continue
            port = avg_psnr(os.path.join(d, "psnr.txt"))
            plain = avg_psnr(os.path.join(d, "psnr_plain.txt"))
            tpu = render_psnr(os.path.join(REPO, step.tpu)) if step.tpu else None
            trained = {}  # the runs whose checkpoints the cell renders
            for ref in dict.fromkeys(a[1:] for a in step.argv if a.startswith("@")):
                trec_path = os.path.join(evidence, ref, "step.json")
                trec = read_json(trec_path) if os.path.exists(trec_path) else None
                trained[ref] = trec and {"steps_run": trec["global_step"] - trec["start"],
                                         "steps_per_dispatch": trec["steps_per_dispatch"],
                                         "captured_graphs": trec["captured_graphs"], "wall_s": trec["wall_s"]}
            entry["cells"][step.name] = {
                **common, "port": port, "plain": plain,
                "kernel_minus_plain": None if port is None or plain is None else port - plain,
                "gate_a": gates.get(step.name, {}).get("ok"), "tpu": tpu,
                "port_minus_tpu": None if port is None or tpu is None else port - tpu,
                "more_than_gap_below_tpu": None if port is None or tpu is None else port < tpu - TPU_GAP_DB,
                "trained_by": trained}
        out["arms"][name] = entry
    write_json(os.path.join(evidence, "summary.json"), out)
    return out


# ---------------------------------------------------------------- CLI


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="print the arms and their commands")
    for cmd in ("run", "gate"):
        sub.add_parser(cmd).add_argument("arm", choices=list(arms()))
    sub.add_parser("summary", help="write evidence/torch_r5/summary.json")
    args = ap.parse_args(argv)
    os.chdir(REPO)
    if args.cmd == "list":
        for arm in arms().values():
            print(f"{arm.name}{' (if chip time remains)' if arm.optional else ''}: {arm.title}")
            for step in arm.steps:
                print(f"  {step.name}: {command_line(step.cli, step.argv)}")
        return 0
    if args.cmd == "run":
        run_arm(args.arm)
        return 0
    if args.cmd == "gate":
        return 0 if gate_arm(args.arm) else 1
    out = summary()
    print(json.dumps({a: {"runs": {k: (v.get("port") or {}).get("best") for k, v in e["runs"].items()},
                          "cells": {k: v.get("port") for k, v in e["cells"].items()}}
                      for a, e in out["arms"].items()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
