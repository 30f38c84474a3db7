"""Core ray, encoding, geometry, sampling and compositing functions in torch."""

from nerf_sampling_tpu_torch.core.compositing import RenderOutputs, raw2alpha, raw2outputs
from nerf_sampling_tpu_torch.core.encoding import Embedder, positional_encoding
from nerf_sampling_tpu_torch.core.geometry import (
    find_intersection_points_with_sphere,
    solve_quadratic_equation,
)
from nerf_sampling_tpu_torch.core.metrics import img2mse, mse2psnr, psnr_np, to8b
from nerf_sampling_tpu_torch.core.rays import get_rays, get_rays_np, ndc_rays
from nerf_sampling_tpu_torch.core.sampling import (
    sample_pdf,
    sample_points_around_mean,
    stratified_z_vals,
    z_to_points,
)

__all__ = [
    "Embedder",
    "RenderOutputs",
    "find_intersection_points_with_sphere",
    "get_rays",
    "get_rays_np",
    "img2mse",
    "mse2psnr",
    "ndc_rays",
    "positional_encoding",
    "psnr_np",
    "raw2alpha",
    "raw2outputs",
    "sample_pdf",
    "sample_points_around_mean",
    "solve_quadratic_equation",
    "stratified_z_vals",
    "to8b",
    "z_to_points",
]
