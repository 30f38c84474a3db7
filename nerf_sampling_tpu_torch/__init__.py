"""PyTorch + CUDA port of nerf_sampling_tpu (render path of the DepthNet sampler).

The JAX package ``nerf_sampling_tpu`` is the reference this package is held
against. This package imports torch and numpy and never jax; its hand-written
Hopper kernels live in ``kernels/csrc`` and are built at first use.
"""
