"""The port's own experiment config, on CPU.

The port reads ``nerf_sampling_tpu_torch/experiments/configs/lego.yaml``
(``definitions.REFERENCE_CONFIG``), its copy of the JAX package's
``nerf_sampling_tpu/experiments/configs/lego.yaml``, and nothing of the
JAX package's tree. The two files must hold the same entries, so that
they cannot drift apart.
"""

from __future__ import annotations

import dataclasses
import os

import pytest
import yaml

from nerf_sampling_tpu.definitions import ROOT_DIR as JAX_ROOT
from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG, ROOT_DIR
from nerf_sampling_tpu_torch.utils.config import load_trainer_config

JAX_CONFIG = os.path.join(JAX_ROOT, "experiments", "configs", "lego.yaml")


def test_reference_config_is_the_ports_own_copy():
    assert os.path.commonpath([REFERENCE_CONFIG, ROOT_DIR]) == ROOT_DIR
    assert os.path.isfile(REFERENCE_CONFIG)


def test_the_copy_holds_the_same_entries_as_the_jax_packages_config():
    with open(REFERENCE_CONFIG) as fp:
        ours = yaml.safe_load(fp)
    with open(JAX_CONFIG) as fp:
        theirs = yaml.safe_load(fp)
    assert ours == theirs and len(ours) > 0


@pytest.mark.parametrize("key", ["recommended_depth_net_module", "lego_depth_net_module"])
def test_the_copy_loads_the_entries_the_port_runs(key):
    """The trainer configs the port's CLIs and chip_smoke.py load from the
    copy are the ones the JAX package's file gives."""
    ours, theirs = load_trainer_config(REFERENCE_CONFIG, key), load_trainer_config(JAX_CONFIG, key)
    assert ours.config_path == REFERENCE_CONFIG
    assert dataclasses.replace(ours, config_path=JAX_CONFIG) == theirs
