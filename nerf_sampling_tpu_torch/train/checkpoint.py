"""Read the JAX package's ``tree:``-keyed .npz checkpoints into torch modules.

The JAX package saves every pytree leaf under "tree:" + its key path, e.g.
``tree:['params'].coarse['pts_linears'][0]['weight']``
(nerf_sampling_tpu/train/checkpoint.py:32-66). The reader parses those key
strings back into nested dicts and lists; ``params_from_jax`` converts the
parameter pytrees ([in, out] weights, fp16 storage allowed) into state dicts
of the port's modules ([out, in], fp32), with the reference's key names.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

_KEY_TOKEN = re.compile(r"\['([^']*)'\]|\.(\w+)|\[(\d+)\]")


def _parse_key(key: str) -> list:
    path, pos = [], 0
    while pos < len(key):
        m = _KEY_TOKEN.match(key, pos)
        if m is None:
            raise ValueError(f"unparseable checkpoint key path: {key!r}")
        name, attr, index = m.groups()
        path.append(int(index) if index is not None else (name if name is not None else attr))
        pos = m.end()
    return path


def _listify(node: Any) -> Any:
    """Dicts whose keys are exactly 0..n-1 become lists (pytree sequences)."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"sparse sequence indices in checkpoint: {sorted(node)}")
        return [node[i] for i in range(len(node))]
    return node


def read_npz_tree(path: str) -> tuple[dict, int]:
    """(nested tree of numpy leaves, global_step) from a JAX .npz checkpoint."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if not key.startswith("tree:"):
                continue
            parts = _parse_key(key[len("tree:"):])
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
        step = int(data["global_step"]) if "global_step" in data.files else 0
    return _listify(tree), step


def _linear(layer: dict, prefix: str, sd: dict) -> None:
    """JAX {"weight": [in, out], "bias": [out]} -> torch Linear [out, in] fp32."""
    sd[f"{prefix}.weight"] = torch.from_numpy(np.array(np.asarray(layer["weight"], np.float32).T))
    sd[f"{prefix}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))


def nerf_state_dict(params: dict) -> dict:
    sd: dict = {}
    for i, layer in enumerate(params["pts_linears"]):
        _linear(layer, f"pts_linears.{i}", sd)
    if "feature_linear" in params:
        _linear(params["feature_linear"], "feature_linear", sd)
        _linear(params["alpha_linear"], "alpha_linear", sd)
        for i, layer in enumerate(params["views_linears"]):
            _linear(layer, f"views_linears.{i}", sd)
        _linear(params["rgb_linear"], "rgb_linear", sd)
    else:
        _linear(params["output_linear"], "output_linear", sd)
    return sd


def depth_net_state_dict(params: dict) -> dict:
    sd: dict = {}
    for name in ("origin_layers", "direction_layers", "intersection_layers"):
        for i, layer in enumerate(params[name]):
            _linear(layer, f"{name}.{i}", sd)
    for i, layer in enumerate(params["cat_layers"]):
        _linear(layer, f"cat_layers.{2 * i}", sd)  # LeakyReLU at the odd indices
    _linear(params["to_depth"], "to_depth.0", sd)
    return sd


def params_from_jax(tree: dict) -> dict:
    """{"coarse", "fine", "depth"} JAX parameter pytrees -> torch state dicts.

    Missing or None entries are skipped; the result has the same keys as the
    entries present.
    """
    out = {}
    for name, fn in (
        ("coarse", nerf_state_dict),
        ("fine", nerf_state_dict),
        ("depth", depth_net_state_dict),
    ):
        if tree.get(name) is not None:
            out[name] = fn(tree[name])
    return out


def load_render_params(path: str, pipeline, device: torch.device | str):
    """A JAX .npz checkpoint's {"params": ...} as eval-mode modules on ``device``.

    ``pipeline`` (render.engine.Pipeline) gives the architectures; every
    module loads with strict=True. Returns render.engine.NeRFParams, with
    the kernels' packed weights when ``pipeline.mlp_impl`` is "cuda".
    """
    from nerf_sampling_tpu_torch.models import DepthNet, NeRF
    from nerf_sampling_tpu_torch.render.engine import CUDA, NeRFParams, pack_kernel_weights

    tree, _ = read_npz_tree(path)
    sds = params_from_jax(tree["params"])

    def build(module, name):
        if name not in sds:
            return None
        module.load_state_dict(sds[name], strict=True)
        return module.to(device).eval()

    params = NeRFParams(
        coarse=build(NeRF(pipeline.nerf), "coarse"),
        fine=build(NeRF(pipeline.fine), "fine") if pipeline.fine is not None else None,
        depth=build(DepthNet(pipeline.depth), "depth") if pipeline.depth is not None else None,
    )
    if pipeline.mlp_impl == CUDA and params.depth is not None:
        params = pack_kernel_weights(params)
    return params
