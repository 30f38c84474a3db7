"""Training: checkpoints, sampler, train state, the depth-net, nerf and joint steps and the Trainer."""

from nerf_sampling_tpu_torch.train.checkpoint import (
    find_checkpoints,
    load_checkpoint,
    params_from_jax,
    params_to_jax,
    read_npz_tree,
    save_checkpoint,
)
from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
from nerf_sampling_tpu_torch.train.state import (
    TrainState,
    init_nerf_state,
    init_state,
    make_depth_optimizer,
    make_nerf_optimizer,
    nerf_lr_schedule,
    nerf_modules,
)
from nerf_sampling_tpu_torch.train.steps import (
    StepDraws,
    make_depth_net_train_step,
    make_joint_train_step,
    make_nerf_train_step,
)

__all__ = [
    "RaySampler",
    "SamplerConfig",
    "StepDraws",
    "TrainState",
    "find_checkpoints",
    "init_nerf_state",
    "init_state",
    "load_checkpoint",
    "make_depth_net_train_step",
    "make_depth_optimizer",
    "make_joint_train_step",
    "make_nerf_optimizer",
    "make_nerf_train_step",
    "nerf_lr_schedule",
    "nerf_modules",
    "params_from_jax",
    "params_to_jax",
    "read_npz_tree",
    "save_checkpoint",
]
