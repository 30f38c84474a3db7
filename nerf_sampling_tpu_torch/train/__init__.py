"""Checkpoint reading and weight conversion (training itself is ROADMAP S2/S3)."""

from nerf_sampling_tpu_torch.train.checkpoint import params_from_jax, read_npz_tree

__all__ = ["params_from_jax", "read_npz_tree"]
