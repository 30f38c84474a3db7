"""Hand-written Hopper kernels of the render and train paths, each beside its plain version.

- ``fused_depth_net``: K1, the DepthNet forward (csrc/depth_net.cu).
- ``fused_render``: K2 and K3, populate-and-shade around the depth, uniform
  and gaussian (csrc/render_around_depth.cu).
- ``fused_nerf``: K4, the NeRF over point queries (csrc/nerf_points.cu).
- ``fused_nerf_vjp``: K5, K4's recompute backward (csrc/nerf_points_bwd.cu),
  and ``fused_nerf_train_apply``, the differentiable query.
- ``fused_hier``: K6 and K7, the hierarchical pass, seeded and
  deterministic (csrc/render_hier.cu).
- ``quant``: K10, the W8A8 int8 MLP that K2/K3/K8/K9 and K6/K7 run in
  their int8 mode: calibration, the int8 pack and the plain int8 chain.

A wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel for CUDA tensors; ``build`` compiles the sources at first use.
"""
