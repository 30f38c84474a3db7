"""Eval rendering: the DEPTH_NET engine and the pose-path harness."""

from nerf_sampling_tpu_torch.render.engine import (
    EvalMode,
    KernelWeights,
    NeRFParams,
    Pipeline,
    RayBatch,
    make_ray_batch,
    pack_kernel_weights,
    render_flat_rays,
    render_image,
    render_rays_eval,
)
from nerf_sampling_tpu_torch.render.path import render_path

__all__ = [
    "EvalMode",
    "KernelWeights",
    "NeRFParams",
    "Pipeline",
    "RayBatch",
    "make_ray_batch",
    "pack_kernel_weights",
    "render_flat_rays",
    "render_image",
    "render_path",
    "render_rays_eval",
]
