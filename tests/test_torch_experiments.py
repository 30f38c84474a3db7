"""The port's legacy, study and plot entry points and its config loaders on
CPU, against the JAX package.

- ``load_legacy_txt_config`` on each of the 16 legacy configs (the port's
  copies, byte for byte the JAX package's) to the JAX TrainerConfig, field
  by field: only ``mlp_impl`` differs (the port's "plain" is "xla").
- ``legacy_run.build_config``: the file and the flags merged as the JAX
  CLI merges them; ``legacy_run.main`` trains a tiny blender scene and,
  from the llff config ``fern.txt``, a generated forward-facing one (NDC).
- ``study``: optuna's branch with a stub module (tests/test_study_optuna.py's
  pattern), one trial pruned through the Trainer's hook, and the seeded
  random search without optuna.
- ``plot`` on a small ``scene_data.npz``.
- ``load_obj_from_config``.
"""

import dataclasses
import filecmp
import glob
import os
import sys

import numpy as np
import pytest
from test_study_optuna import TINY_YAML, _make_optuna_stub

from nerf_sampling_tpu.experiments import legacy_run as jlegacy
from nerf_sampling_tpu.utils import config as jconfig
from nerf_sampling_tpu_torch.data.example import generate_example_dataset, generate_example_llff_dataset
from nerf_sampling_tpu_torch.definitions import ROOT_DIR
from nerf_sampling_tpu_torch.experiments import legacy_run, plot, study
from nerf_sampling_tpu_torch.train.trainer import TrialPruned
from nerf_sampling_tpu_torch.utils import config as tconfig

LEGACY = sorted(glob.glob(os.path.join(ROOT_DIR, "experiments", "configs", "legacy", "*.txt")))
JAX_LEGACY = os.path.join(os.path.dirname(jconfig.__file__), "..", "experiments", "configs", "legacy")


def differing(jcfg, tcfg) -> set:
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert set(jd) == set(td)
    return {k for k in jd if jd[k] != td[k]}


def test_the_legacy_configs_are_the_jax_packages():
    assert [os.path.basename(p) for p in LEGACY] == sorted(os.listdir(JAX_LEGACY)) and len(LEGACY) == 16
    for path in LEGACY:
        assert filecmp.cmp(path, os.path.join(JAX_LEGACY, os.path.basename(path)), shallow=False), path


@pytest.mark.parametrize("path", LEGACY, ids=os.path.basename)
def test_load_legacy_txt_config_matches_jax(path):
    tcfg = tconfig.load_legacy_txt_config(path)
    jcfg = jconfig.load_legacy_txt_config(path)
    assert differing(jcfg, tcfg) == {"mlp_impl"}
    assert tcfg.explicit_keys == jcfg.explicit_keys and len(tcfg.explicit_keys) > 5


@pytest.mark.parametrize("argv", [
    ["--config_path", "{lego}"],
    ["--config_path", "{fern}", "--N_rand", "7", "--netdepth", "3", "--no_ndc", "--expname", "x"],
    ["--config_path", "{lego}", "--mlp_impl", "cuda", "--i_testset", "50000", "--datadir", "/data/lego"],
    ["--dataset_type", "blender", "--white_bkgd", "--half_res"],
])
def test_legacy_build_config_matches_jax(argv):
    paths = {k: os.path.join(ROOT_DIR, "experiments", "configs", "legacy", f"{k}.txt") for k in ("lego", "fern")}
    argv = [a.format(**paths) for a in argv]
    port_only = ("--mlp_impl", "cuda")
    jargv = [a for a in argv if a not in port_only]
    tcfg = legacy_run.build_config(legacy_run.config_parser().parse_args(argv + ["--device", "cpu"]))
    jcfg = jlegacy.build_config(jlegacy.config_parser().parse_args(jargv))
    assert differing(jcfg, tcfg) == {"mlp_impl"}
    assert tcfg.mlp_impl == ("cuda" if "cuda" in argv else "plain") and tcfg.train_mode == "nerf"
    assert tcfg.device == jcfg.device  # --device is the Trainer's, not the config's


def test_legacy_run_trains_a_blender_scene(tmp_path):
    datadir = str(tmp_path / "scene")
    generate_example_dataset(datadir, H=16, W=16, n_train=2, n_val=1, n_test=1)
    lego = os.path.join(ROOT_DIR, "experiments", "configs", "legacy", "lego.txt")
    tiny = ["--netdepth", "2", "--netwidth", "16", "--netdepth_fine", "2", "--netwidth_fine", "16",
            "--N_samples", "4", "--N_importance", "4", "--N_rand", "16", "--n_iters", "2", "--i_print", "1",
            "--basedir", str(tmp_path / "logs"), "--device", "cpu"]
    psnr = legacy_run.main(["--config_path", lego, "--datadir", datadir, "--expname", "lego"] + tiny)
    assert np.isfinite(psnr)
    lines = (tmp_path / "logs" / "lego" / "psnr.txt").read_text().splitlines()
    assert [ln.split()[1] for ln in lines] == ["1", "2"]
    # an llff config (NDC) on a generated forward-facing scene
    llff = generate_example_llff_dataset(str(tmp_path / "llff"), H=16, W=24, n_images=9)
    fern = os.path.join(ROOT_DIR, "experiments", "configs", "legacy", "fern.txt")
    psnr = legacy_run.main(["--config_path", fern, "--datadir", llff, "--expname", "fern", "--factor", "1"] + tiny)
    assert np.isfinite(psnr)
    assert len((tmp_path / "logs" / "fern" / "psnr.txt").read_text().splitlines()) == 2


@pytest.fixture
def study_setup(tmp_path, monkeypatch):
    dataset_dir = tmp_path / "dataset"
    generate_example_dataset(str(dataset_dir / "example"), H=12, W=12, n_train=2, n_val=1, n_test=1)
    monkeypatch.setattr(study, "DATASET_DIR", str(dataset_dir))
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.replace("nerf_sampling_tpu.", "nerf_sampling_tpu_torch."))
    return ["-c", str(cfg_path), "-m", "tiny_module", "-d", "example", "--n_trials", "2", "--n_iters", "4",
            "--basedir", str(tmp_path / "study_logs"), "-ip", "2", "--device", "cpu"]


def test_study_optuna_branch(study_setup, monkeypatch):
    """The optuna branch with a stub: trial 0 runs to its end; trial 1 is
    pruned at its first report (step 2), through the Trainer's hook."""
    stub = _make_optuna_stub(suggested_lrs=[1e-3, 1e-4])
    for name, mod in (("optuna", stub), ("optuna.pruners", stub.pruners), ("optuna.trial", stub.trial),
                      ("optuna.exceptions", stub.exceptions)):
        monkeypatch.setitem(sys.modules, name, mod)
    lr, psnr = study.main(study_setup)
    kw = stub.create_study.kwargs
    assert kw["storage"].endswith("study_logs/study.db") and kw["study_name"] == "depth_net_lr"
    assert kw["pruner"] == "median-pruner" and kw["load_if_exists"]
    trials = stub.create_study.study.trials
    assert [[s for _, s in t.reports] for t in trials] == [[2, 4], [2]]
    assert lr == 1e-3 and psnr == trials[0].reports[-1][0]


def test_study_random_search_and_the_prune_fallback(study_setup, monkeypatch, tmp_path):
    """Without optuna: the seeded log-uniform search, ranked in
    study_results.txt; the Trainer's hook raises its own TrialPruned."""
    monkeypatch.setitem(sys.modules, "optuna", None)
    lr, psnr = study.main(study_setup)
    want = [float(10 ** u) for u in np.random.default_rng(0).uniform(-6, -2, size=2)]
    assert lr in want and np.isfinite(psnr)
    lines = (tmp_path / "study_logs" / "study_results.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith(f"PSNR {psnr:.4f}")

    class Prune:
        def report(self, value, step):
            pass

        def should_prune(self):
            return True

    cfg = study._build_cfg({**vars(study.build_parser().parse_args(study_setup)),
                            "datadir": os.path.join(study.DATASET_DIR, "example")}, 1e-4)
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    with pytest.raises(TrialPruned):
        Trainer(cfg, device="cpu", trial=Prune()).train(N_iters=3)


def test_plot_scene_points(tmp_path):
    rng = np.random.default_rng(0)
    pts, weights = rng.standard_normal((500, 3)).astype(np.float32), rng.random(500).astype(np.float32)
    np.savez(tmp_path / "scene_data.npz", all_pts=pts, all_weights=weights)
    out = tmp_path / "points.png"
    got = plot.main(["-f", str(tmp_path / "scene_data.npz"), "-t", "0.3", "-n", "100", "-o", str(out)])
    kept = pts[weights >= 0.3]
    want = kept[np.random.default_rng(0).choice(len(kept), 100, replace=False)]
    np.testing.assert_array_equal(got, want)
    assert out.stat().st_size > 0
    got = plot.main(["-f", str(tmp_path / "scene_data.npz"), "-t", "0.9", "-o", str(out)])
    np.testing.assert_array_equal(got, pts[weights >= 0.9])


def test_load_obj_from_config_matches_jax():
    kwargs = {"expname": "obj", "N_rand": 7, "netdepth": 3}
    tobj = tconfig.load_obj_from_config({"module": "nerf_sampling_tpu_torch.utils.config.TrainerConfig",
                                         "kwargs": kwargs})
    jobj = jconfig.load_obj_from_config({"module": "nerf_sampling_tpu.utils.config.TrainerConfig",
                                         "kwargs": kwargs})
    assert isinstance(tobj, tconfig.TrainerConfig) and differing(jobj, tobj) == {"mlp_impl"}
    with pytest.raises(AttributeError):
        tconfig.load_obj_from_config({"module": "nerf_sampling_tpu_torch.utils.config.Missing", "kwargs": {}})
