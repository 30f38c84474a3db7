"""Rendering: the four eval modes, the train-time renderers and the pose-path harness."""

from nerf_sampling_tpu_torch.render.engine import (
    EvalMode,
    KernelWeights,
    NeRFParams,
    Pipeline,
    RayBatch,
    eval_packs,
    make_ray_batch,
    pack_kernel_weights,
    render_flat_rays,
    render_image,
    render_rays_eval,
    render_rays_joint,
    render_rays_train,
    render_rays_vanilla,
    repack_depth,
    sample_as_in_nerf,
)
from nerf_sampling_tpu_torch.render.path import render_path

__all__ = [
    "EvalMode",
    "KernelWeights",
    "NeRFParams",
    "Pipeline",
    "RayBatch",
    "eval_packs",
    "make_ray_batch",
    "pack_kernel_weights",
    "render_flat_rays",
    "render_image",
    "render_path",
    "render_rays_eval",
    "render_rays_joint",
    "render_rays_train",
    "render_rays_vanilla",
    "repack_depth",
    "sample_as_in_nerf",
]
