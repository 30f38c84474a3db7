"""NeRF, mip-NeRF and DepthNet as torch nn.Modules."""

from nerf_sampling_tpu_torch.models.depth_net import DepthNet, DepthNetConfig
from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig

__all__ = ["DepthNet", "DepthNetConfig", "MipNeRF", "MipNeRFConfig", "NeRF", "NeRFConfig"]
