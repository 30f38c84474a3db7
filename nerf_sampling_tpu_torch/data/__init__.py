"""Dataset loaders and the procedural example scenes (host-side numpy).

Every loader returns a ``SceneData``: blender, llff, LINEMOD and deepvoxels.
"""

from nerf_sampling_tpu_torch.data.blender import load_blender_data, pose_spherical
from nerf_sampling_tpu_torch.data.deepvoxels import load_deepvoxels_scene, load_dv_data
from nerf_sampling_tpu_torch.data.example import (
    generate_example_dataset,
    generate_example_deepvoxels_dataset,
    generate_example_linemod_dataset,
    generate_example_llff_dataset,
    maybe_generate_example_dataset,
)
from nerf_sampling_tpu_torch.data.linemod import load_linemod_data, load_linemod_scene
from nerf_sampling_tpu_torch.data.llff import load_llff_data, load_llff_scene
from nerf_sampling_tpu_torch.data.types import SceneData

__all__ = [
    "SceneData",
    "generate_example_dataset",
    "generate_example_deepvoxels_dataset",
    "generate_example_linemod_dataset",
    "generate_example_llff_dataset",
    "load_blender_data",
    "load_deepvoxels_scene",
    "load_dv_data",
    "load_linemod_data",
    "load_linemod_scene",
    "load_llff_data",
    "load_llff_scene",
    "maybe_generate_example_dataset",
    "pose_spherical",
]
