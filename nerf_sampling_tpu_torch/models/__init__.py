"""NeRF and DepthNet as torch nn.Modules."""

from nerf_sampling_tpu_torch.models.depth_net import DepthNet, DepthNetConfig
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig

__all__ = ["DepthNet", "DepthNetConfig", "NeRF", "NeRFConfig"]
