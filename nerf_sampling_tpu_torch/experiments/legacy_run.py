"""The legacy vanilla-NeRF CLI (nerf_sampling_tpu/experiments/legacy_run.py).

    python3 -m nerf_sampling_tpu_torch.experiments.legacy_run \\
        --config_path nerf_sampling_tpu_torch/experiments/configs/legacy/lego.txt \\
        --datadir <blender scene> --mlp_impl cuda

The reference's run_nerf.py flag surface (config_parser, nerf_utils.py:
879-1104) with a ``--config_path`` file of ``key = value`` lines (the
port's copies of the 16 legacy configs are in ``experiments/configs/
legacy/``): a flag given on the command line wins over the file, a flag
left at its default keeps the file's value. The run is vanilla NeRF
training (``train_mode="nerf"``), as in the JAX package. Two flags of the
port's own: ``--mlp_impl`` (plain, the default, or cuda: K4/K5 for the
NeRF queries, K7 for the evals, K4 under NDC) and ``--device`` (the card unless
``cpu``). Every dataset type runs: blender, llff (NDC unless
``--no_ndc``: the nerf steps run K4/K5 on NDC points), LINEMOD and
deepvoxels.
"""

from __future__ import annotations

import argparse
import dataclasses

from nerf_sampling_tpu_torch.utils.config import TrainerConfig, load_legacy_txt_config

DATASET_TYPES = ("llff", "blender", "LINEMOD", "deepvoxels")


def config_parser() -> argparse.ArgumentParser:
    """The reference flag surface (nerf_utils.py:879-1104), then the port's
    --mlp_impl and --device."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, help="config file path")
    parser.add_argument("--expname", type=str, help="experiment name")
    parser.add_argument("--basedir", type=str, default="./logs/")
    parser.add_argument("--datadir", type=str, default="./data/llff/fern")

    # training options
    parser.add_argument("--netdepth", type=int, default=8)
    parser.add_argument("--netwidth", type=int, default=256)
    parser.add_argument("--netdepth_fine", type=int, default=8)
    parser.add_argument("--netwidth_fine", type=int, default=256)
    parser.add_argument("--N_rand", type=int, default=32 * 32 * 4)
    parser.add_argument("--lrate", type=float, default=5e-4)
    parser.add_argument("--lrate_decay", type=int, default=250)
    parser.add_argument("--chunk", type=int, default=1024 * 32)
    parser.add_argument("--netchunk", type=int, default=1024 * 64)
    parser.add_argument("--no_batching", action="store_true")
    parser.add_argument("--no_reload", action="store_true")
    parser.add_argument("--ft_path", type=str, default=None)
    parser.add_argument("--input_dims_embed", type=int, default=3)

    # rendering options
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--N_importance", type=int, default=0)
    parser.add_argument("--perturb", type=float, default=1.0)
    parser.add_argument("--use_viewdirs", action="store_true")
    parser.add_argument("--i_embed", type=int, default=0)
    parser.add_argument("--multires", type=int, default=10)
    parser.add_argument("--multires_views", type=int, default=4)
    parser.add_argument("--raw_noise_std", type=float, default=0.0)
    parser.add_argument("--render_only", action="store_true")
    parser.add_argument("--render_test", action="store_true")
    parser.add_argument("--render_factor", type=int, default=0)

    # precrop
    parser.add_argument("--precrop_iters", type=int, default=0)
    parser.add_argument("--precrop_frac", type=float, default=0.5)

    # dataset options
    parser.add_argument("--dataset_type", type=str, default="llff")
    parser.add_argument("--testskip", type=int, default=8)
    parser.add_argument("--shape", type=str, default="greek")
    parser.add_argument("--white_bkgd", action="store_true")
    parser.add_argument("--half_res", action="store_true")
    parser.add_argument("--factor", type=int, default=8)
    parser.add_argument("--no_ndc", action="store_true")
    parser.add_argument("--lindisp", action="store_true")
    parser.add_argument("--spherify", action="store_true")
    parser.add_argument("--llffhold", type=int, default=8)

    # logging/saving options
    parser.add_argument("--i_print", type=int, default=100)
    parser.add_argument("--i_img", type=int, default=500)
    parser.add_argument("--i_weights", type=int, default=10000)
    parser.add_argument("--i_testset", type=int, default=50000)
    parser.add_argument("--i_video", type=int, default=50000)

    parser.add_argument("--n_iters", type=int, default=200000)

    # the port's own
    parser.add_argument("--mlp_impl", choices=["plain", "cuda"], default=None,
                        help="plain (the default): fp32 PyTorch; cuda: the hand-written kernels")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Where the Trainer runs: the card (default) or the CPU.")
    return parser


def build_config(args: argparse.Namespace) -> TrainerConfig:
    """Merge the .txt config (if given) with the flags; a flag that differs
    from its default wins. ``--device`` is the Trainer's, not a config field."""
    if args.config_path:
        cfg = load_legacy_txt_config(args.config_path)
        cfg.config_path = args.config_path
    else:
        cfg = TrainerConfig()
    fields = {f.name for f in dataclasses.fields(TrainerConfig)} - {"device"}
    defaults = config_parser().parse_args([])
    for key, value in vars(args).items():
        if key not in fields or (key == "mlp_impl" and value is None):
            continue
        if args.config_path and value == getattr(defaults, key):
            continue  # keep the file's value unless the command line overrode it
        setattr(cfg, key, value)
    cfg.train_mode = "nerf"  # the legacy CLI is vanilla NeRF training
    cfg.train_depth_net_only = False
    if cfg.expname is None:
        cfg.expname = "legacy_experiment"
    return cfg


def train(cfg: TrainerConfig, n_iters: int, device: str = "cuda") -> float:
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    if cfg.dataset_type not in DATASET_TYPES:
        raise ValueError(f"unknown dataset_type {cfg.dataset_type}; use llff / blender / LINEMOD / deepvoxels")
    return Trainer(cfg, device=device).train(N_iters=n_iters + 1)


def main(argv: list[str] | None = None) -> float:
    args = config_parser().parse_args(argv)
    psnr = train(build_config(args), args.n_iters, args.device)
    print(f"Final psnr: {psnr}")
    return psnr


if __name__ == "__main__":
    main()
