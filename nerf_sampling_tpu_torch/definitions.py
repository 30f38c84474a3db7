"""Package root paths (reference definitions.py)."""

import os

ROOT_DIR = os.path.dirname(os.path.abspath(__file__))
# the generated example scenes live here (listed in .gitignore)
DATASET_DIR = os.path.join(ROOT_DIR, "dataset")
# the experiment configs: the port's own copy of the reference entries
REFERENCE_CONFIG = os.path.join(ROOT_DIR, "experiments", "configs", "lego.yaml")
