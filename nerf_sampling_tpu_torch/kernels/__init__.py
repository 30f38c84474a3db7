"""Hand-written Hopper kernels of the render and train paths, each beside its plain version.

- ``fused_depth_net``: K1, the DepthNet forward (csrc/depth_net.cu).
- ``fused_render``: K2, K3, K8 and K9, populate-and-shade around the depth
  (uniform, gaussian), on the eval grid and at the caller's z
  (csrc/render_around_depth.cu); the NeRF packs, their wgmma slice images
  and ``pack_args``.
- ``fused_nerf``: K4, the NeRF over point queries (csrc/nerf_points.cu).
- ``fused_nerf_vjp``: K5, K4's recompute backward (csrc/nerf_points_bwd.cu),
  and ``fused_nerf_train_apply``, the differentiable query.
- ``fused_hier``: K6 and K7, the hierarchical pass, seeded and
  deterministic (csrc/render_hier.cu).
- ``quant``: K10, the W8A8 int8 MLP that K2/K3/K8/K9 and K6/K7 run in
  their int8 mode: calibration, the int8 pack and the plain int8 chain.
- ``fused_mip``: K11, mip-NeRF's two-level render (csrc/render_mip.cu).

A wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel for CUDA tensors; ``build`` compiles the sources at first use.

The launch contract: a pack's matrices reach the device once, as its
wgmma slice image. Each C entry takes its inputs and outputs, then the
slice images, then only the vectors its epilogues read (biases, the
heads' rows, the int8 dequant rows; ``fused_render.pack_args``,
``fused_depth_net.epilogue_vectors``), and refuses a launch without the
slices. Every launch goes through ``build.launch``, which counts it in
``build.launches`` by (kernel, precision): ("K1", "bf16") .. ("K11",
"bf16"), precision "bf16", "fp32" or "int8".
"""
