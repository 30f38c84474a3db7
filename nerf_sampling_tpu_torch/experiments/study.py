"""A hyperparameter study of depth_net_lr (nerf_sampling_tpu/experiments/study.py).

    python3 -m nerf_sampling_tpu_torch.experiments.study -d example -m recommended_depth_net_module \\
        --n_trials 20 --n_iters 2000

The reference's experiments/study.py: an optuna study that maximizes the
final train PSNR (MedianPruner, sqlite storage under ``--basedir``, 500
trials by default), each trial a depth-net run at run.py's hard overrides
with a log-uniform depth_net_lr in [1e-6, 1e-2], pruned from the PSNR the
Trainer reports every ``-ip`` steps. optuna is imported where it is used;
without it a seeded log-uniform random search runs instead, with the same
objective, and ranks its trials in ``study_results.txt``. ``-d`` names a
directory under the dataset root; ``example`` is generated there on first
use at 100x100, as in the JAX study; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nerf_sampling_tpu_torch.definitions import DATASET_DIR, REFERENCE_CONFIG
from nerf_sampling_tpu_torch.utils.config import load_trainer_config, override_config


def _build_cfg(kw: dict, depth_net_lr: float):
    cfg = load_trainer_config(kw["config"], kw["model"])
    override_config(cfg.__dict__, {
        "depth_net_lr": depth_net_lr,
        "n_layers": 10,
        "layer_width": 256,
        "train_depth_net_only": True,
        "sphere_radius": 2,
    })
    cfg.datadir = kw["datadir"]
    cfg.basedir = kw["basedir"]
    cfg.expname = f"study_lr_{depth_net_lr:.2e}"
    cfg.i_print = kw["i_print"]
    cfg.i_testset = 10**9  # the objective is the train PSNR: no periodic eval
    cfg.i_video = 10**9
    return cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Sweep depth_net_lr, maximizing PSNR.")
    ap.add_argument("-c", "--config", default=REFERENCE_CONFIG)
    ap.add_argument("-m", "--model", default="lego_depth_net_module")
    ap.add_argument("-d", "--dataset", default="example")
    ap.add_argument("--n_trials", type=int, default=500)
    ap.add_argument("--n_iters", type=int, default=2000, help="Train iterations per trial.")
    ap.add_argument("--basedir", default="./logs/study")
    ap.add_argument("-ip", "--i_print", type=int, default=500)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="Where the trials run: the card (default) or the CPU.")
    return ap


def main(argv: list[str] | None = None) -> tuple[float, float]:
    """Run the study; returns the best (depth_net_lr, PSNR)."""
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    kw = vars(build_parser().parse_args(argv))
    datadir = os.path.join(DATASET_DIR, kw["dataset"])
    if not os.path.exists(datadir):
        if kw["dataset"] != "example":
            raise FileNotFoundError(f"-d {kw['dataset']}: no dataset at {datadir} (a study generates only 'example')")
        from nerf_sampling_tpu_torch.data.example import generate_example_dataset

        generate_example_dataset(datadir)
    kw["datadir"] = datadir
    os.makedirs(kw["basedir"], exist_ok=True)

    def run_trial(lr: float, trial=None) -> float:
        return Trainer(_build_cfg(kw, lr), device=kw["device"], trial=trial).train(N_iters=kw["n_iters"] + 1)

    try:
        import optuna
    except ImportError:
        optuna = None
    if optuna is not None:
        def objective(trial) -> float:
            return run_trial(trial.suggest_float("depth_net_lr", 1e-6, 1e-2, log=True), trial)

        study = optuna.create_study(
            direction="maximize",
            pruner=optuna.pruners.MedianPruner(),
            storage=f"sqlite:///{kw['basedir']}/study.db",
            study_name="depth_net_lr",
            load_if_exists=True,
        )
        study.optimize(objective, n_trials=kw["n_trials"])
        print(f"Best: {study.best_params} -> PSNR {study.best_value:.3f}")
        return study.best_params["depth_net_lr"], study.best_value

    print("[study] optuna not installed; running log-uniform random search")
    rng = np.random.default_rng(0)
    results = []
    for t in range(kw["n_trials"]):
        lr = float(10 ** rng.uniform(-6, -2))
        psnr = run_trial(lr)
        results.append((psnr, lr))
        results.sort(reverse=True)
        with open(os.path.join(kw["basedir"], "study_results.txt"), "w") as f:
            for p, l in results:
                f.write(f"PSNR {p:.4f}  depth_net_lr {l:.3e}\n")
        print(f"trial {t}: lr={lr:.3e} psnr={psnr:.3f} (best {results[0]})")
    print(f"Best: depth_net_lr={results[0][1]:.3e} -> PSNR {results[0][0]:.3f}")
    return results[0][1], results[0][0]


if __name__ == "__main__":
    main()
