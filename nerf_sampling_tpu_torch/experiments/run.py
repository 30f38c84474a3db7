"""Train from the command line (nerf_sampling_tpu/experiments/run.py).

    python3 -m nerf_sampling_tpu_torch.experiments.run -d example \\
        -m recommended_depth_net_module --mlp_impl cuda --ft_path NERF.npz --n_iters 2500
    python3 -m nerf_sampling_tpu_torch.experiments.run -d example --mode nerf \\
        --mlp_impl cuda --n_iters 500 --i_testset 500
    python3 -m nerf_sampling_tpu_torch.experiments.run -d example --mode joint \\
        -m recommended_depth_net_module --mlp_impl cuda --ft_path NERF.npz --joint_depth_warmup 100
    python3 -m nerf_sampling_tpu_torch.experiments.run -d example -m recommended_depth_net_module \\
        --mlp_impl cuda --ft_path pretrained/nerf/example/200000.tar --profile_dir logs/profile
    python3 -m nerf_sampling_tpu_torch.experiments.run -d example_llff -m llff_depth_net_module \\
        --mode nerf --mlp_impl cuda          # forward-facing, NDC: K4/K5 steps, K4 evals

The JAX CLI's flag surface and hard overrides (reference run.py:101-109:
depth_net_lr 1e-4, a 10x256 DepthNet, train_depth_net_only, sphere_radius
2), with argparse in place of click. The reference-parity flags (-si, -sr,
-ip, -w) always set the config; the extension flags set it only when typed
or when the YAML entry does not set the field. ``-d <name>`` generates a
built-in procedural scene on first use (``example`` and ``example_hard``
at 800x800 in blender format, ``example_llff`` at 400x400 in LLFF's,
``example_linemod`` and ``example_deepvoxels``:
``data/example.py::maybe_generate_example_dataset``). ``--mode nerf`` trains
the first 500 steps on a center crop when the entry leaves
``precrop_iters`` at 0, as the JAX CLI does. ``--ft_path`` takes the
JAX package's ``.npz`` or the reference's ``.tar``; with ``-d`` and no
``--ft_path``, depth_net mode reads ``nerf_sampling_tpu_torch/pretrained/
nerf/<dataset>/200000.tar`` where it exists (the reference's convention).
``--precision`` sets the plain path's fp32 matmuls (highest: strict fp32,
high: TF32, default: torch's "medium"); the kernels ignore it.
``--profile_dir`` traces steps 20-40 after the start with torch.profiler
(the Trainer's option; no JAX CLI flag). ``--steps_per_dispatch K`` runs K
steps per host sync (0, the default, is auto: on the card the largest
divisor of the logging cadences up to 100, each step after the first a
replay of a captured CUDA graph; on the CPU 1, while an explicit K runs
chunks of K eager steps there); it equals the per-step loop bit for bit
(train/trainer.py::resolve_steps_per_dispatch). The Trainer runs on the
card, and raises when there is none, unless ``--device cpu`` asks for the
CPU.

Data parallelism (JAX run.py:85-141): ``--n_devices N`` (N > 1, or 0 for
every card) trains on N ranks, one process per card. Started alone, this
CLI spawns them itself (rank r on ``cuda:r``, this process being rank 0;
nccl, or gloo ranks on the CPU with ``--device cpu``), joined through a
``file://`` rendezvous, and returns rank 0's Trainer. Under a launcher
(torchrun: ``WORLD_SIZE`` set) or with ``--multihost`` (which needs one)
each process joins the launcher's group instead:

    torchrun --nnodes 2 --nproc_per_node 8 --rdzv_endpoint HOST:PORT \
        -m nerf_sampling_tpu_torch.experiments.run -d example --multihost ...
"""

from __future__ import annotations

import argparse
import os
import tempfile

from nerf_sampling_tpu_torch.data.example import maybe_generate_example_dataset
from nerf_sampling_tpu_torch.definitions import DATASET_DIR, REFERENCE_CONFIG, ROOT_DIR
from nerf_sampling_tpu_torch.utils.config import INT8_HELP, load_trainer_config, override_config
from nerf_sampling_tpu_torch.utils.precision import PRECISION_HELP

# extension flags: (config field, default); None on the command line means "not typed"
_EXTENSION_DEFAULTS = {
    "train_mode": "depth_net",
    "basedir": "./logs",
    "matmul_precision": "highest",
    "mlp_impl": "plain",
    "seed": 42,
    "joint_depth_warmup": 0,
    "i_testset": 20000,
    "n_devices": 1,
    "steps_per_dispatch": 0,
    "multihost": False,
    "profile_dir": None,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Run sampling-network training with the provided configuration.")
    ap.add_argument("-c", "--config", default=REFERENCE_CONFIG, help="Path to configuration file.")
    ap.add_argument("-dp", "--dataset_path", help="Path to dataset folder.")
    ap.add_argument("-d", "--dataset", help="Name of the dataset to train on.")
    ap.add_argument("-m", "--model", default="lego_depth_net_module", help="Model key in the YAML config.")
    ap.add_argument("-w", "--wandb", dest="wandb_mode", default="disabled",
                    choices=["online", "offline", "disabled"], help="wandb logging mode.")
    ap.add_argument("-si", "--single_image", action="store_true", help="Train on a single image.")
    ap.add_argument("-sr", "--single_ray", action="store_true", help="Train on a single ray.")
    ap.add_argument("-ip", "--i_print", type=int, default=1000, help="Frequency of log printing.")
    ap.add_argument("--n_iters", type=int, default=100_000, help="Training iterations.")
    ap.add_argument("--mode", dest="train_mode", choices=["depth_net", "nerf", "joint"], default=None)
    ap.add_argument("--basedir", default=None)
    ap.add_argument("--precision", dest="matmul_precision", choices=["highest", "high", "default"],
                    default=None, help=PRECISION_HELP)
    ap.add_argument("--mlp_impl", choices=["plain", "cuda", "cuda_int8", "xla", "pallas", "pallas_int8"],
                    default=None,
                    help="plain: fp32 PyTorch; cuda: the hand-written kernels (K4/K5 NeRF queries, "
                         "K6 oracle, K1/K3 and K7 evals); " + INT8_HELP + " depth_net mode only (the "
                         "int8 K6 oracle and evals). The JAX names xla, pallas and pallas_int8 map onto them.")
    ap.add_argument("--joint_depth_warmup", type=int, default=None)
    ap.add_argument("--i_testset", type=int, default=None, help="Frequency of test-set evals.")
    ap.add_argument("--n_devices", type=int, default=None)
    ap.add_argument("--steps_per_dispatch", type=int, default=None, help="train steps per host sync (0: auto).")
    ap.add_argument("--multihost", action="store_true", default=None)
    ap.add_argument("--ft_path", default=None, help="Explicit NeRF checkpoint (.tar or .npz) to load.")
    ap.add_argument("--testskip", type=int, default=None, help="Load every Nth test/val image.")
    ap.add_argument("--seed", type=int, default=None, help="Init and sampling seed.")
    ap.add_argument("--profile_dir", default=None,
                    help="Trace steps 20-40 after the start with torch.profiler into PROFILE_DIR/trace.json.")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="Where the Trainer runs: the card (default) or the CPU.")
    return ap


def main(argv: list[str] | None = None):
    """Parse ``argv``, train, print the final PSNR; returns the Trainer (rank
    0's when this process spawns the ranks of ``--n_devices``)."""
    kw = vars(build_parser().parse_args(argv))
    cfg = trainer_config(kw)
    if cfg is None:
        return None
    n = cfg.n_devices
    if n == 1 or cfg.multihost or os.environ.get("WORLD_SIZE"):
        return _train(cfg, kw["n_iters"], None if kw["device"] == "cuda" else kw["device"])
    import torch

    from nerf_sampling_tpu_torch.parallel import ops

    on_cpu = kw["device"] == "cpu"
    if n == 0:
        if on_cpu:
            raise ValueError("--n_devices 0 counts the cards: give the number of CPU ranks with --device cpu")
        n = torch.cuda.device_count()
    if n < 1:
        raise ValueError(f"--n_devices must be 0 (every card) or at least 1, got {cfg.n_devices}")
    with tempfile.TemporaryDirectory() as tmp:
        return ops.spawn(_rank, n, (cfg, kw["n_iters"], on_cpu), rendezvous=os.path.join(tmp, "rendezvous"),
                         backend="gloo" if on_cpu else "nccl", join_timeout=ops.DEFAULT_TIMEOUT,
                         threads=max(1, torch.get_num_threads() // n) if on_cpu else None, rank0_here=True)


def _rank(rank: int, world: int, cfg, n_iters: int, on_cpu: bool):
    """One spawned rank of ``main``: its card (``cuda:rank``) or the CPU."""
    if on_cpu:
        return _train(cfg, n_iters, "cpu")
    import torch

    torch.cuda.set_device(rank)
    return _train(cfg, n_iters, f"cuda:{rank}")


def _train(cfg, n_iters: int, device: str | None):
    """The CLI's run on ``device`` (None: the Trainer's default card)."""
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    psnr = trainer.train(N_iters=n_iters + 1)
    if trainer.primary:
        print(f"Final psnr: {psnr}")
    return trainer


def trainer_config(kw: dict):
    """The TrainerConfig of the parsed flags ``kw`` (generating a ``-d``
    scene on first use), or None without a dataset."""
    cfg = load_trainer_config(kw["config"], kw["model"])
    cfg.single_image = kw["single_image"]
    cfg.single_ray = kw["single_ray"]
    cfg.i_print = kw["i_print"]
    cfg.wandb_mode = kw["wandb_mode"]
    for field, default in _EXTENSION_DEFAULTS.items():
        if kw[field] is not None:
            setattr(cfg, field, kw[field])
        elif field not in cfg.explicit_keys:
            setattr(cfg, field, default)
    if kw["testskip"] is not None:
        cfg.testskip = kw["testskip"]
    if cfg.train_mode == "nerf" and cfg.precrop_iters == 0:
        # reference blender configs train the first 500 iters on a center
        # crop (configs/lego.txt:16-17) against density collapse
        cfg.precrop_iters = 500

    datadir = kw["dataset_path"]
    ft_path = None
    name = kw["dataset"]
    if name is not None:
        datadir = os.path.join(DATASET_DIR, name)
        maybe_generate_example_dataset(name, datadir)
        candidate = os.path.join(ROOT_DIR, "pretrained", "nerf", name, "200000.tar")
        if cfg.train_mode == "depth_net" and os.path.exists(candidate):
            ft_path = candidate
        print(f"dataset_name={name!r}")
    if datadir is None:
        print("Please specify the name of the dataset or provide the path to the folder")
        return None

    override_config(cfg.__dict__, {  # hard overrides (reference run.py:101-109)
        "depth_net_lr": 1e-4,
        "n_layers": 10,
        "layer_width": 256,
        "train_depth_net_only": True,
        "sphere_radius": 2,
    })
    cfg.ft_path = kw["ft_path"] or ft_path
    cfg.datadir = datadir
    cfg.expname = f"{name or 'custom'}_{'depth_net' if cfg.train_mode == 'depth_net' else 'nerf'}"
    # reference run.py:148 renders the train-time DepthNet sample alone;
    # a model entry that sets sampling_mode keeps its eval population
    if "sampling_mode" not in cfg.explicit_keys:
        cfg.sampling_mode = "depth_only"
    return cfg


if __name__ == "__main__":
    main()
