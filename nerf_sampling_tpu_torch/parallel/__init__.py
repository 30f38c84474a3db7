"""Data parallelism over torch.distributed (nerf_sampling_tpu/parallel/).

One process per card; training and rendering split the ray batch into
equal contiguous row blocks in rank order with replicated parameters, and
the collectives GSPMD inserts in the JAX package are written out: one
gradient all-reduce per step and one host all-gather per rendered image.
The JAX package's ``ray_sharding`` and ``replicated_sharding`` have no
counterpart here; ``ray_rows`` (a rank's rows of a batch) and
``replicate`` (parameters broadcast from rank 0) take their places.
"""

from nerf_sampling_tpu_torch.parallel.mesh import (
    make_hybrid_mesh,
    make_mesh,
    ray_rows,
    replicate,
    shard_ray_batch,
)
from nerf_sampling_tpu_torch.parallel.ops import (
    make_sharded_depth_train_step,
    make_sharded_eval,
    make_sharded_joint_train_step,
    make_sharded_nerf_train_step,
    maybe_initialize_distributed,
)
from nerf_sampling_tpu_torch.parallel.render import render_image_sharded

__all__ = [
    "make_hybrid_mesh",
    "make_mesh",
    "make_sharded_depth_train_step",
    "make_sharded_eval",
    "make_sharded_joint_train_step",
    "make_sharded_nerf_train_step",
    "maybe_initialize_distributed",
    "ray_rows",
    "render_image_sharded",
    "replicate",
    "shard_ray_batch",
]
