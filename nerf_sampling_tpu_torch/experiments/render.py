"""Render and evaluate DepthNet results from the command line (nerf_sampling_tpu/experiments/render.py).

    python3 -m nerf_sampling_tpu_torch.experiments.render -d example --ft_path CKPT.npz \\
        --n_samples 64 --distance 1.0        # DEPTH_NET: K1, then K2 (uniform) or K3 (gaussian)
    ... -nc                                  # COMPARE_NERF: K7, K1 and K9 in fp32, MSE in psnr.txt
    ... -nm                                  # NERF_MAX: K7's argmax sample
    ... -nf                                  # FULL_NERF: K7 (K8 when N_importance is 0)
    ... -e --testskip 4                      # the sweep grid -> experiments/experiments_results.txt
    ... --device cpu --mlp_impl plain        # on the CPU
    python3 -m nerf_sampling_tpu_torch.experiments.render -d example_llff -m llff_depth_net_module -rt \\
        --ft_path NERF.npz --depth_net_path DEPTH.npz --n_samples 64 --distance 0.25 \\
        --sampling_mode gaussian             # NDC: K1, then K4 on the population (the composable route)

The JAX CLI's flags and defaults, with argparse in place of click (-c -dp
-d -m -w -si -sr -rt -ssd -nc -nm -nf -e -tmp -ip --basedir --mlp_impl
--testskip --ft_path --depth_net_path --n_samples --distance
--sampling_mode; the manual defaults n_samples 2, distance 0.01, uniform,
reference render.py:208-212), and ``--device`` (the card unless ``cpu``).
``-d <name>`` generates a built-in scene on first use (run.py's list).
It renders the test views through the Trainer's ``render_only`` path, so
a checkpoint may be the JAX package's ``.npz`` or the reference's ``.tar``
(``pretrained/nerf/<ds>/200000.tar`` and ``pretrained/depth_net/<ds>/
files/sampler_experiment/200000.tar`` under the package, where they exist).
``--mlp_impl`` defaults to ``cuda``, the hand-written kernels, as the JAX
CLI defaults to its Pallas kernels; ``cuda_int8`` (or ``pallas_int8``) runs
DEPTH_NET, FULL_NERF and NERF_MAX through their int8 (W8A8) kernels,
calibrated on the loaded NeRFs (COMPARE_NERF stays fp32).
The ``-e`` grid renders n_samples [2, 32, 64, 128] x distance [0.1, 0.3,
0.5, 1] x [uniform, gaussian] with one Trainer each, in one process: the
kernel library builds once, the NeRF packs are made once per Trainer.
"""

from __future__ import annotations

import argparse
import os

from nerf_sampling_tpu_torch.data.example import maybe_generate_example_dataset
from nerf_sampling_tpu_torch.definitions import DATASET_DIR, REFERENCE_CONFIG, ROOT_DIR
from nerf_sampling_tpu_torch.utils.config import INT8_HELP, load_trainer_config, override_config

N_SAMPLES_GRID = (2, 32, 64, 128)
DISTANCE_GRID = (0.1, 0.3, 0.5, 1)
SAMPLING_MODES = ("uniform", "gaussian")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Render depth-net results with the provided configuration.")
    ap.add_argument("-c", "--config", default=REFERENCE_CONFIG)
    ap.add_argument("-dp", "--dataset_path")
    ap.add_argument("-d", "--dataset", help="Name of the dataset to render.")
    ap.add_argument("-m", "--model", default="lego_depth_net_module")
    ap.add_argument("-w", "--wandb", dest="wandb_mode", default="disabled",
                    choices=["online", "offline", "disabled"])
    ap.add_argument("-si", "--single_image", action="store_true")
    ap.add_argument("-sr", "--single_ray", action="store_true")
    ap.add_argument("-rt", "--render_test", action="store_true",
                    help="Render the test set (the default: the CLI always renders it).")
    ap.add_argument("-ssd", "--save_scene_data", action="store_true")
    ap.add_argument("-nc", "--nerf_compare", action="store_true",
                    help="Compare depth net predictions to NeRF argmax samples.")
    ap.add_argument("-nm", "--nerf_max", action="store_true", help="Use nerf max points to render.")
    ap.add_argument("-nf", "--nerf_full", action="store_true", help="Use full nerf to render.")
    ap.add_argument("-e", "--experiments", action="store_true", help="Run the automatic sweep grid.")
    ap.add_argument("-tmp", "--temporary", action="store_true", help="Use temporary folder for experiment.")
    ap.add_argument("-ip", "--i_print", type=int, default=1000)
    ap.add_argument("--basedir", default=None, help="Override output dir.")
    ap.add_argument("--mlp_impl", choices=["plain", "cuda", "cuda_int8", "xla", "pallas", "pallas_int8"],
                    default="cuda",
                    help="cuda: the hand-written kernels; plain: the fp32 PyTorch path; " + INT8_HELP
                         + " The JAX names xla, pallas and pallas_int8 map onto them.")
    ap.add_argument("--testskip", type=int, default=None, help="Load every Nth test/val image.")
    ap.add_argument("--ft_path", default=None, help="Explicit NeRF checkpoint (.tar or .npz) to load.")
    ap.add_argument("--depth_net_path", default=None, help="Explicit DepthNet checkpoint (.tar or .npz) to load.")
    ap.add_argument("--n_samples", type=int, default=2)
    ap.add_argument("--distance", type=float, default=0.01)
    ap.add_argument("--sampling_mode", default="uniform", choices=["uniform", "gaussian", "depth_only"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="Where the renders run: the card (default) or the CPU.")
    return ap


def main(argv: list[str] | None = None):
    """Parse ``argv`` and render; returns the (last) Trainer, or None
    without a dataset."""
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    kw = vars(build_parser().parse_args(argv))
    cfg = load_trainer_config(kw["config"], kw["model"])
    cfg.single_image = kw["single_image"]
    cfg.single_ray = kw["single_ray"]
    cfg.save_scene_data = kw["save_scene_data"]
    cfg.i_print = kw["i_print"]
    cfg.wandb_mode = kw["wandb_mode"]
    cfg.compare_nerf = kw["nerf_compare"]
    cfg.use_nerf_max_pts = kw["nerf_max"]
    cfg.use_full_nerf = kw["nerf_full"]
    cfg.render_only = True
    cfg.render_test = True
    cfg.mlp_impl = kw["mlp_impl"]
    if kw["testskip"] is not None:
        cfg.testskip = kw["testskip"]

    datadir = kw["dataset_path"]
    ft_path = depth_net_path = None
    name = kw["dataset"]
    if name is not None:
        datadir = os.path.join(DATASET_DIR, name)
        maybe_generate_example_dataset(name, datadir)
        ft_path = os.path.join(ROOT_DIR, "pretrained", "nerf", name, "200000.tar")
        depth_net_path = os.path.join(ROOT_DIR, "pretrained", "depth_net", name, "files",
                                      "sampler_experiment", "200000.tar")
        print(f"dataset_name={name!r}")
    if datadir is None:
        print("Please specify the name of the dataset or provide the path to the folder")
        return None
    basedir = kw["basedir"] or f"./logs/{name}"

    # the JAX CLI's hard overrides (nerf_sampling_tpu/experiments/render.py:112-119)
    override_config(cfg.__dict__, {
        "depth_net_lr": 1e-4,
        "n_layers": 10,
        "layer_width": 256,
        "train_depth_net_only": True,
        "sphere_radius": 2,
    })
    cfg.datadir = datadir
    cfg.basedir = basedir
    if kw["ft_path"]:
        cfg.ft_path = kw["ft_path"]
    elif ft_path and os.path.exists(ft_path):
        cfg.ft_path = ft_path
    if kw["depth_net_path"]:
        cfg.depth_net_path = kw["depth_net_path"]
    elif depth_net_path and os.path.exists(depth_net_path):
        cfg.depth_net_path = depth_net_path

    n_samples, distance, sampling_mode = kw["n_samples"], kw["distance"], kw["sampling_mode"]
    if kw["nerf_compare"]:
        cfg.expname = f"{name}_depth_net_render_mse"
    elif kw["nerf_max"]:
        cfg.expname = f"{name}_nerf_max_render"
    elif kw["nerf_full"]:
        cfg.expname = f"{name}_nerf_full_render"
    else:
        cfg.expname = (f"{name}_depth_net_render_n_samples_{n_samples}"
                       f"_distance_{distance}_sampling_mode_{sampling_mode}")
    if kw["temporary"]:
        cfg.expname = "tmp"
    cfg.n_depth_samples, cfg.distance, cfg.sampling_mode = n_samples, distance, sampling_mode

    if not kw["experiments"]:
        trainer = Trainer(cfg, device=kw["device"])
        psnr = trainer.train(N_iters=1)
        print(f"Final psnr: {psnr}")
        return trainer

    exp_basedir = os.path.join(basedir, "experiments")
    os.makedirs(exp_basedir, exist_ok=True)
    results = os.path.join(exp_basedir, "experiments_results.txt")
    with open(results, "w") as fp:
        fp.write("Experiments")
    trainer = None
    for sampling_mode in SAMPLING_MODES:
        cfg.basedir = os.path.join(exp_basedir, sampling_mode)
        with open(results, "a") as fp:
            fp.write(f"\n\nSampling mode: {sampling_mode}\n\n")
        for n_samples in N_SAMPLES_GRID:
            with open(results, "a") as fp:
                fp.write(f"N_samples: {n_samples}:\n")
            for distance in DISTANCE_GRID:
                cfg.expname = (f"{name}_depth_net_render_n_samples_{n_samples}"
                               f"_distance_{distance}_sampling_mode_{sampling_mode}")
                cfg.n_depth_samples, cfg.distance, cfg.sampling_mode = n_samples, distance, sampling_mode
                trainer = Trainer(cfg, device=kw["device"])
                psnr = trainer.train(N_iters=1)
                with open(results, "a") as fp:
                    fp.write(f"    Distance: {distance}, PSNR: {psnr:.2f}\n")
    return trainer


if __name__ == "__main__":
    main()
