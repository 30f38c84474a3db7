"""Dataset loaders and the procedural example scene (host-side numpy)."""

from nerf_sampling_tpu_torch.data.blender import load_blender_data, pose_spherical
from nerf_sampling_tpu_torch.data.example import generate_example_dataset
from nerf_sampling_tpu_torch.data.types import SceneData

__all__ = [
    "SceneData",
    "generate_example_dataset",
    "load_blender_data",
    "pose_spherical",
]
