"""scripts/torch_r5.py, the port's round-5 runs: its recipes against the
JAX scripts' lines, its trajectory summary on the JAX runs' recorded
files, and one arm end to end on the CPU at a few steps."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_r5.py")

_spec = importlib.util.spec_from_file_location("torch_r5", SCRIPT)
torch_r5 = sys.modules["torch_r5"] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_r5)

from nerf_sampling_tpu_torch.data.example import generate_example_dataset  # noqa: E402
from nerf_sampling_tpu_torch.experiments import render as render_cli  # noqa: E402
from nerf_sampling_tpu_torch.experiments import run as run_cli  # noqa: E402
from nerf_sampling_tpu_torch.utils import config as tconfig  # noqa: E402

JAX_SCRIPTS = ("scripts/r5_100k.sh", "scripts/r5_llff.sh", "scripts/r5_other_formats.sh",
               "scripts/r5_100k_parity.sh", "scripts/r5_deepvoxels_dense.sh")
PATH_FLAGS = ("--basedir", "--ft_path", "--depth_net_path")
ARMS = torch_r5.arms()
STEPS = [(arm.name, step) for arm in ARMS.values() for step in arm.steps]


def jax_lines(script: str) -> list[str]:
    """The ``python -m nerf_sampling_tpu.experiments.*`` commands of a JAX
    script, continuation lines joined, in order."""
    text = re.sub(r"\\\n\s*", " ", open(os.path.join(REPO, script)).read())
    return [ln[ln.index("python -m"):] for ln in text.splitlines()
            if "python -m nerf_sampling_tpu.experiments." in ln]


def flags(tokens) -> dict:
    """{flag: value, or True for a switch} of a command's arguments."""
    out, tokens = {}, list(tokens)
    for i, t in enumerate(tokens):
        if t.startswith("-"):
            nxt = tokens[i + 1] if i + 1 < len(tokens) else None
            out[t] = nxt if nxt is not None and not nxt.startswith("-") else True
    return out


def jax_command(source) -> tuple[str, dict]:
    """(cli, flags) of the JAX line ``source`` names, its shell variables
    replaced by the values of that line (``source``'s loop and function
    arguments, then the script's first plain assignment of each name;
    checkpoints found with ``$(ls ...)`` stay ``$NAME``)."""
    script, index, values = source
    text = open(os.path.join(REPO, script)).read()
    assigned = {}
    for name, value in re.findall(r"(?:^|\s)(\w+)=(\"[^\"]*\"|[^\s;\"$(][^\s;]*|\$\{?\w+\}?[^\s;]*)", text):
        assigned.setdefault(name, value.strip('"'))
    env = {**assigned, **values}
    line = jax_lines(script)[index]
    for _ in range(4):  # assignments that name other variables
        line = re.sub(r"\$(\d|[A-Za-z_]\w*|\{\w+\})", lambda m: env.get(m.group(1).strip("{}"), m.group(0)), line)
    tokens = shlex.split(line)
    return tokens[2].rsplit(".", 1)[1], flags(tokens[3:])


@pytest.mark.parametrize("arm,step", STEPS, ids=[f"{a}-{s.name}" for a, s in STEPS])
def test_recipe_is_the_jax_scripts_line(arm, step):
    """Every flag and value of the JAX line, but --mlp_impl pallas -> cuda
    and the paths: logs/<p> -> logs/torch_r5/<p> (./logs -> logs/torch_r5
    where the JAX line gives no --basedir), checkpoints as @ARM/STEP
    references, and A7's regenerated scene as a directory of its own (-dp)."""
    cli, want = jax_command(step.source)
    got = flags(step.argv)
    assert cli == step.cli
    assert want.pop("--mlp_impl") == "pallas" and got.pop("--mlp_impl") == "cuda"
    if "-dp" in got:
        assert want.pop("-d") == "example_deepvoxels" and arm == "A7"
        assert got.pop("-dp") == torch_r5.dense_deepvoxels_dir()
    for f in PATH_FLAGS:
        jv, gv = want.pop(f, None), got.pop(f, None)
        if f == "--basedir":
            assert gv == (torch_r5.LOGS if jv is None else jv.replace("logs/", torch_r5.LOGS + "/", 1))
        else:
            assert (jv is None) == (gv is None) and (gv is None or gv.startswith("@"))
    assert got == want
    # the port's parser takes the command (a checkpoint reference as a path)
    argv = [torch_r5.REPO if a.startswith("@") else a for a in step.argv]
    parser = (run_cli if step.cli == "run" else render_cli).build_parser()
    kw = vars(parser.parse_args(argv))
    assert kw["mlp_impl"] == "cuda" and kw["device"] == "cuda"


def test_every_jax_line_has_its_step():
    covered = {(s.source[0], s.source[1]) for _, s in STEPS}
    for script in JAX_SCRIPTS:
        assert {(script, i) for i in range(len(jax_lines(script)))} <= covered, script
    assert [a.name for a in ARMS.values() if not a.optional] == ["A1", "A2", "A3", "A4", "A5"]


@pytest.mark.parametrize("expdir,want", [
    ("evidence/r5_100k_depth_example/example_depth_net", (30.25, 65000, 30.21, -0.04)),
    ("evidence/r5_100k_joint_example/example_nerf", (30.86, 45000, 30.17, -0.69)),
])
def test_trajectory_summary_on_recorded_runs(expdir, want):
    """RESULTS.md's 100k table from the JAX runs' testset_*/psnr.txt."""
    t = torch_r5.trajectory(os.path.join(REPO, expdir))
    assert len(t["evals"]) == 20 and t["final_step"] == 100000
    assert (round(t["best"], 2), t["best_step"], round(t["final"], 2), round(t["drift"], 2)) == want


def test_render_psnr_of_a_recorded_cell():
    base = os.path.join(REPO, "evidence", "r5", "render_100k_depth_example_uniform_64")
    assert round(torch_r5.render_psnr(base), 2) == 30.80
    assert torch_r5.render_psnr(os.path.join(REPO, "evidence", "r5", "render_100k_joint_example_full")) is None


@pytest.fixture
def tiny_runs(tmp_path, monkeypatch):
    """A 12x12 example scene and 2x32 NeRFs (8 + 8 samples, 16 rays a
    step at 12x12, a checkpoint and an eval every 2 steps) under tmp_path."""
    datasets = tmp_path / "dataset"
    generate_example_dataset(str(datasets / "example"), H=12, W=12, n_train=2, n_val=1, n_test=1)
    load = tconfig.load_trainer_config

    def tiny(path, key=None):
        cfg = load(path, key)
        return dataclasses.replace(cfg, netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, N_samples=8,
                                   N_importance=8, N_rand=16, half_res=False, i_weights=2, i_testset=2, chunk=4096,
                                   netchunk=8192)

    for mod in (run_cli, render_cli):
        monkeypatch.setattr(mod, "load_trainer_config", tiny)
        monkeypatch.setattr(mod, "DATASET_DIR", str(datasets))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_arm_a1_end_to_end_on_cpu(tiny_runs):
    """run A1 at 4 steps a run, then its gates and the summary: every
    command runs, leaves its record and evidence, and is skipped when run
    again."""
    torch_r5.run_arm("A1", n_iters=4, device="cpu")
    steps = [s.name for s in ARMS["A1"].steps]
    for name in steps:
        rec = json.load(open(os.path.join(torch_r5.EVIDENCE, "A1", name, "step.json")))
        assert rec["command"].startswith("python -m nerf_sampling_tpu_torch.experiments.")
        assert rec["nonfinite_losses"] == 0 and rec["steps_per_dispatch"] == 1 and rec["captured_graphs"] == 0
        assert rec["launches"] == {}  # on CPU tensors the wrappers run their plain versions
        if name in ("nerf", "depth"):
            assert (rec["start"], rec["global_step"], rec["steps_run"]) == (0, 4, 4)
            assert os.path.exists(os.path.join(torch_r5.EVIDENCE, "A1", name, "args.txt"))
    nerf = torch_r5.trajectory(os.path.join(torch_r5.EVIDENCE, "A1", "nerf"))
    assert [s for s, _ in nerf["evals"]] == [2, 4]  # the nerf run's own cadence (no --i_testset on its line)
    assert torch_r5.checkpoint("A1", "nerf").endswith("000004.npz")
    depth_ckpt = torch_r5.checkpoint("A1", "depth")
    assert depth_ckpt.endswith("depth_000004.npz")
    for name in steps[2:]:
        assert np.isfinite(torch_r5.avg_psnr(os.path.join(torch_r5.EVIDENCE, "A1", name, "psnr.txt")))

    torch_r5.run_arm("A1", n_iters=4, device="cpu")  # every step done: nothing runs
    assert torch_r5.checkpoint("A1", "depth") == depth_ckpt

    torch_r5.gate_arm("A1")  # the plain renders, from the commands the records hold
    gate = json.load(open(os.path.join(torch_r5.EVIDENCE, "A1", "gate.json")))
    assert gate["nerf"]["ok"] and gate["depth"]["ok"]  # (b): finite, at the count, best/ the first best eval
    assert "captured" not in gate["depth"]["checks"] and gate["depth"]["memory"] is None  # off the card
    for name in steps[2:]:
        assert gate[name]["gate"] == "a" and np.isfinite(gate[name]["delta"])
        assert os.path.exists(os.path.join(torch_r5.EVIDENCE, "A1", name, "psnr_plain.txt"))

    plain_mtime = os.path.getmtime(os.path.join(torch_r5.EVIDENCE, "A1", "render_depth_full", "psnr_plain.txt"))
    torch_r5.gate_arm("A1")  # again: the stored plain renders are read, none is made anew
    assert os.path.getmtime(os.path.join(torch_r5.EVIDENCE, "A1", "render_depth_full", "psnr_plain.txt")) == plain_mtime

    out = torch_r5.summary()
    cells = out["arms"]["A1"]["cells"]
    assert round(cells["render_depth_uniform_64"]["tpu"], 2) == 30.80  # the recorded TPU cell beside
    assert cells["render_depth_full"]["kernel_minus_plain"] == pytest.approx(gate["render_depth_full"]["delta"])
    run = out["arms"]["A1"]["runs"]["depth"]
    assert run["steps_run"] == 4 and run["tpu"]["best_step"] == 65000
    assert "A2" not in out["arms"]


def test_plain_argv_renders_into_its_own_basedir():
    argv = list(ARMS["A4"].steps[2].argv)
    plain = torch_r5.plain_argv(argv)
    assert torch_r5.flag(plain, "--mlp_impl") == "plain"
    assert torch_r5.flag(plain, "--basedir") == f"{torch_r5.LOGS}/r5_plain/render_llff_gaussian_64"
    assert [a for a in plain if a not in ("plain", torch_r5.flag(plain, "--basedir"))] == \
        [a for a in argv if a not in ("cuda", torch_r5.flag(argv, "--basedir"))]


def test_script_imports_without_jax():
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        f"spec = importlib.util.spec_from_file_location('torch_r5', {SCRIPT!r})\n"
        "m = sys.modules['torch_r5'] = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "m.arms(); m.main(['list'])\n"
        "import nerf_sampling_tpu_torch.experiments.run, nerf_sampling_tpu_torch.experiments.render\n"
        "bad = sorted(k for k in sys.modules if k == 'nerf_sampling_tpu' or k.startswith(('jax.', "
        "'nerf_sampling_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr


def _card_run(tmp_path, rows: list[dict]) -> tuple[dict, str]:
    """A 100k run's record as the card leaves it, with eval lines ``rows``."""
    d = tmp_path / "depth"
    for r in rows:
        (d / f"testset_{r['step']:06d}").mkdir(parents=True)
        (d / f"testset_{r['step']:06d}" / "psnr.txt").write_text(f"Avg of 4 images:\nPSNR: {r['test_psnr']}\n")
    (d / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    rec = {"nonfinite_losses": 0, "global_step": 100000, "n_iters": 100000, "early_stop": False, "start": 0,
           "best_checkpoints": ["depth_100000.npz"], "steps_per_dispatch": 100, "captured_graphs": 1,
           "max_memory_allocated_mib": 512.0}
    return rec, str(d)


@pytest.mark.parametrize("live,peak,ok,not_checked", [
    ((228.0, 228.0), (512.0, 512.0), True, []),
    ((228.0, 330.0), (512.0, 512.0), False, []),  # live growth under a peak that cannot move
    ((228.0, 228.0), (444.0, 512.0), False, []),
    (None, (512.0, 512.0), True, ["no_live_growth"]),  # eval lines from before the live figure
])
def test_gate_b_holds_live_and_peak_memory_flat(tmp_path, live, peak, ok, not_checked):
    rows = []
    for j, step in enumerate((5000, 100000)):
        row = {"step": step, "test_psnr": 30.0 + j, "max_memory_allocated_mib": peak[j], "memory_reserved_mib": 824.0}
        if live is not None:
            row["memory_allocated_mib"] = live[j]
        rows.append(row)
    rec, d = _card_run(tmp_path, rows)
    got = torch_r5.check_run(rec, d)
    assert got["ok"] is ok and [c.split(":")[0] for c in got["not_checked"]] == not_checked
    assert got["checks"]["captured"] and got["checks"]["best_is_first_best_eval"]
    assert got["memory"]["evals"] == [5000, 100000] and got["memory"]["peak_growth_mib"] == peak[1] - peak[0]
    assert ("no_live_growth" in got["checks"]) is (live is not None)


def test_cli_has_no_device_option():
    with pytest.raises(SystemExit):
        torch_r5.main(["run", "A1", "--device", "cpu"])


def _memory_probe():
    spec = importlib.util.spec_from_file_location("torch_r5_memory", os.path.join(REPO, "scripts", "torch_r5_memory.py"))
    probe = sys.modules["torch_r5_memory"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def test_memory_probe_reads_the_allocation_history(capsys):
    """scripts/torch_r5_memory.py's reading of a snapshot: the blocks still
    allocated, grouped by their Python stack (the card's run prints it)."""
    probe = _memory_probe()
    frame = {"filename": "/x/engine.py", "line": 7, "name": "render"}
    trace = [{"action": "alloc", "addr": 1, "size": 2**20, "frames": [frame]},
             {"action": "alloc", "addr": 2, "size": 3 * 2**20, "frames": [frame]},
             {"action": "alloc", "addr": 3, "size": 2**20, "frames": []},
             {"action": "free_requested", "addr": 2, "size": 3 * 2**20},
             {"action": "free_completed", "addr": 2, "size": 3 * 2**20}]
    probe.kept({"device_traces": [trace]})
    out = capsys.readouterr().out
    assert "kept 2.00 MiB in 2 blocks" in out and "1.00 MiB  engine.py:7:render" in out
    assert probe.held_mib(None) == 0


def test_memory_probe_restores_the_trainer():
    from nerf_sampling_tpu_torch.train import trainer

    probe = _memory_probe()
    methods = trainer.Trainer.eval_testset, trainer.Trainer.save_checkpoint
    with pytest.raises(RuntimeError), probe.probe(trainer.Trainer):
        assert trainer.Trainer.eval_testset is not methods[0]
        raise RuntimeError("the run failed")
    assert (trainer.Trainer.eval_testset, trainer.Trainer.save_checkpoint) == methods
