"""Hand-written Hopper kernels of the render path, each beside its plain version.

- ``fused_depth_net``: K1, the DepthNet forward (csrc/depth_net.cu).
- ``fused_render``: K2, populate-and-shade around the depth (csrc/render_around_depth.cu).

A wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel for CUDA tensors; ``build`` compiles the sources at first use.
"""
