"""Package root paths (reference definitions.py)."""

import os

ROOT_DIR = os.path.dirname(os.path.abspath(__file__))
# the generated example scenes live here (listed in .gitignore)
DATASET_DIR = os.path.join(ROOT_DIR, "dataset")
# the experiment configs are data shared with the JAX package, read by path
REFERENCE_CONFIG = os.path.join(
    os.path.dirname(ROOT_DIR), "nerf_sampling_tpu", "experiments", "configs", "lego.yaml"
)
