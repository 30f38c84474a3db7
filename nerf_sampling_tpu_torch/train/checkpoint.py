"""The JAX package's ``tree:``-keyed .npz checkpoints, read and written.

The JAX package saves every pytree leaf under "tree:" + its key path, e.g.
``tree:['params'].coarse['pts_linears'][0]['weight']``
(nerf_sampling_tpu/train/checkpoint.py:32-90). ``read_npz_tree`` parses
those key strings back into nested dicts and lists; ``params_from_jax``
converts the parameter pytrees ([in, out] weights, fp16 storage allowed)
into state dicts of the port's modules ([out, in], fp32), with the
reference's key names, and ``params_to_jax`` is its inverse.

``save_checkpoint`` writes the same layout, so a resume is exact and the
JAX package's ``load_checkpoint`` reads every leaf:

- a depth-net checkpoint (``depth_{i:06d}.npz``) holds ``params`` (the JAX
  NeRFParams: coarse, fine, depth) and ``opt_state``, the DepthNet's Adam
  moments in optax.adam's layout (``[0].count``, ``[0].mu[...]``,
  ``[0].nu[...]``);
- a nerf or joint checkpoint (``{i:06d}.npz``) holds ``params`` and
  ``opt_state``, the NeRFs' Adam in the layout of optax.adam with a
  schedule over NeRFParams(coarse, fine, None) (``[0].mu.coarse[...]``,
  ..., and the schedule's ``[1].count``); joint mode adds
  ``depth_opt_state``, the DepthNet's Adam.

The reference's own format, a ``torch.save`` of ``{"global_step",
"network_fn_state_dict", "network_fine_state_dict", "depth_network",
"optimizer_state_dict", "sampling_optimizer_state_dict"}`` (reference
utils.py:79-88; nerf_sampling_tpu/train/checkpoint.py:94-411), is read by
``import_torch_checkpoint`` and written by ``export_torch_checkpoint``. The
port's modules carry the reference's parameter names, so its state dicts
are the file's. The two optimizers are torch Adam state dicts keyed by
the position of each parameter in the reference modules' ``parameters()``
order (``nerf_param_order``, ``depth_param_order``), whatever order the
port's modules register them in.

A restored Adam's ``step`` count lies on its parameter's device, where the
card's capturable Adam keeps it (train/state.py); a save or an export reads
it once.
"""

from __future__ import annotations

import os
import re
from typing import Any, NamedTuple

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


def _linear_to_jax(sd: dict, prefix: str) -> dict:
    """torch Linear [out, in] -> JAX {"weight": [in, out], "bias": [out]} fp32."""
    return {
        "weight": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _count(sd: dict, prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def nerf_params_to_jax(sd: dict) -> dict:
    params: dict = {
        "pts_linears": [_linear_to_jax(sd, f"pts_linears.{i}") for i in range(_count(sd, "pts_linears."))]
    }
    if "feature_linear.weight" in sd:
        params["feature_linear"] = _linear_to_jax(sd, "feature_linear")
        params["alpha_linear"] = _linear_to_jax(sd, "alpha_linear")
        params["views_linears"] = [
            _linear_to_jax(sd, f"views_linears.{i}") for i in range(_count(sd, "views_linears."))
        ]
        params["rgb_linear"] = _linear_to_jax(sd, "rgb_linear")
    else:
        params["output_linear"] = _linear_to_jax(sd, "output_linear")
    return params


def depth_net_params_to_jax(sd: dict) -> dict:
    params = {
        name: [_linear_to_jax(sd, f"{name}.{i}") for i in range(_count(sd, f"{name}."))]
        for name in ("origin_layers", "direction_layers", "intersection_layers")
    }
    n_cat = _count(sd, "cat_layers.")  # Linear at the even indices
    params["cat_layers"] = [_linear_to_jax(sd, f"cat_layers.{2 * i}") for i in range(n_cat)]
    params["to_depth"] = _linear_to_jax(sd, "to_depth.0")
    return params


def params_to_jax(sds: dict) -> dict:
    """{"coarse", "fine", "depth"} torch state dicts -> JAX parameter pytrees
    (the inverse of ``params_from_jax``); missing or None entries are skipped."""
    out = {}
    for name, fn in (
        ("coarse", nerf_params_to_jax),
        ("fine", nerf_params_to_jax),
        ("depth", depth_net_params_to_jax),
    ):
        if sds.get(name) is not None:
            out[name] = fn(sds[name])
    return out


class JaxNeRFParams(NamedTuple):
    """The JAX NeRFParams' key layout (``.coarse``, ``.fine``, ``.depth``)."""

    coarse: Any = None
    fine: Any = None
    depth: Any = None


class JaxAdamState(NamedTuple):
    """optax ScaleByAdamState's key layout (``.count``, ``.mu``, ``.nu``)."""

    count: Any
    mu: Any
    nu: Any


def adam_state_to_jax(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> tuple:
    """A torch Adam's moments of a DepthNet as optax.adam's state pytree
    (ScaleByAdamState, then the EmptyState of its learning-rate scale)."""
    mu, nu, step = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        step = int(st["step"]) if "step" in st else step
    return (JaxAdamState(np.asarray(step, np.int32), depth_net_params_to_jax(mu),
                         depth_net_params_to_jax(nu)),)


def adam_state_from_jax(opt_tree, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> int:
    """Load optax.adam moments (``opt_state`` as read by ``read_npz_tree``)
    into ``optimizer``'s state for ``model``; returns the step count."""
    adam = opt_tree[0]
    count = int(adam["count"])
    mu, nu = depth_net_state_dict(adam["mu"]), depth_net_state_dict(adam["nu"])
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32, device=p.device),
            "exp_avg": mu[name].to(p.device).reshape(p.shape).clone(),
            "exp_avg_sq": nu[name].to(p.device).reshape(p.shape).clone(),
        }
    return count


class JaxScheduleState(NamedTuple):
    """optax ScaleByScheduleState's key layout (``.count``)."""

    count: Any


def nerf_adam_state_to_jax(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> tuple:
    """A torch Adam's moments of ``state.nerf_modules`` (coarse, fine) as
    optax.adam-with-a-schedule's state over NeRFParams(coarse, fine, None)."""
    from nerf_sampling_tpu_torch.train.state import adam_count

    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    for name, p in model.named_parameters():
        net, key = name.split(".", 1)
        st = optimizer.state.get(p, {})
        for k, tree in moments.items():
            tree.setdefault(net, {})[key] = st.get(k, torch.zeros_like(p))

    def as_jax(tree: dict) -> JaxNeRFParams:
        return JaxNeRFParams(**{net: nerf_params_to_jax(sd) for net, sd in tree.items()})

    count = np.asarray(adam_count(optimizer), np.int32)
    return (JaxAdamState(count, as_jax(moments["exp_avg"]), as_jax(moments["exp_avg_sq"])),
            JaxScheduleState(count))


def nerf_adam_state_from_jax(opt_tree, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> int | None:
    """Load the NeRFs' optax moments (``opt_state`` as read by
    ``read_npz_tree``) into ``optimizer``'s state for ``state.nerf_modules``;
    returns the count, or None when ``opt_tree`` is not a NeRF optimizer's
    state (a depth-net checkpoint's), which then restores nothing."""
    adam = opt_tree[0]
    if not isinstance(adam.get("mu"), dict) or "coarse" not in adam["mu"]:
        return None
    count = int(adam["count"])
    mu = {net: nerf_state_dict(t) for net, t in adam["mu"].items()}
    nu = {net: nerf_state_dict(t) for net, t in adam["nu"].items()}
    for name, p in model.named_parameters():
        net, key = name.split(".", 1)
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32, device=p.device),
            "exp_avg": mu[net][key].to(p.device).reshape(p.shape).clone(),
            "exp_avg_sq": nu[net][key].to(p.device).reshape(p.shape).clone(),
        }
    return count


def _flatten(node: Any, path: str, out: dict) -> None:
    """JAX keystr paths of a pytree of dicts, lists/tuples, NamedTuples and
    array leaves; None is an empty subtree, as in jax.tree_util."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], f"{path}[{k!r}]", out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for k in node._fields:
            _flatten(getattr(node, k), f"{path}.{k}", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{path}[{i}]", out)
    else:
        out["tree:" + path] = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else np.asarray(node)


def save_checkpoint(path: str, tree: dict, step: int) -> None:
    """Save a pytree + step to .npz under the JAX package's ``tree:`` keys."""
    arrays: dict = {}
    _flatten(tree, "", arrays)
    arrays["global_step"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path: str) -> tuple[dict, int]:
    """(nested tree, global_step) of a ``tree:``-keyed .npz."""
    return read_npz_tree(path)


def find_checkpoints(dirpath: str, pattern: str = r"\.(npz|tar)$") -> list[str]:
    """Sorted checkpoint paths in a directory (zero-padded step names sort by
    step); at one step the ``.npz`` sorts after the ``.tar``."""
    if not os.path.isdir(dirpath):
        return []
    return [
        os.path.join(dirpath, f)
        for f in sorted(
            (f for f in os.listdir(dirpath) if re.search(pattern, f)),
            key=lambda f: (os.path.splitext(f)[0], f.endswith(".npz")),
        )
    ]


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


# --------------------------------------------------------------------------
# The reference's .tar format
# --------------------------------------------------------------------------


def _fp32_state(sd: dict) -> dict:
    """A state dict as contiguous fp32 CPU tensors (an .npz restore's dtype)."""
    return {k: v.detach().to("cpu", torch.float32).contiguous().clone() for k, v in sd.items()}


def import_torch_checkpoint(path: str) -> dict:
    """Read a reference ``.tar`` checkpoint: {"global_step", "coarse",
    "fine", "depth"}, the last three the port's state dicts (fp32, the
    reference's key names) or None where the file has none. Optimizer
    moments are not read (the JAX package reads none either). The file
    comes from outside the program, so it is unpickled with
    ``weights_only``: tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)

    def sd(key: str) -> dict | None:
        return _fp32_state(ckpt[key]) if ckpt.get(key) else None

    return {"global_step": int(ckpt.get("global_step", 0)), "coarse": sd("network_fn_state_dict"),
            "fine": sd("network_fine_state_dict"), "depth": sd("depth_network")}


def nerf_params_from_keras(weights: list, D: int = 8) -> dict:
    """Original-TF-NeRF Keras weight lists (reference
    NeRF.load_weights_from_keras, run_nerf_helpers.py:136-183) as a NeRF
    state dict: ``[W0, b0, W1, b1, ...]`` for pts_linears, then
    feature_linear, views_linears[0], rgb_linear, alpha_linear; Keras
    kernels are [in, out], so each is transposed."""
    def lin(i: int, prefix: str, sd: dict) -> None:
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(weights[i], np.float32).T))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(weights[i + 1], np.float32).reshape(-1).copy())

    sd: dict = {}
    for i in range(D):
        lin(2 * i, f"pts_linears.{i}", sd)
    for i, prefix in enumerate(("feature_linear", "views_linears.0", "rgb_linear", "alpha_linear")):
        lin(2 * D + 2 * i, prefix, sd)
    return sd


def nerf_param_order(sd: dict) -> list[str]:
    """The reference NeRF's ``parameters()`` order (run_nerf_helpers.py:87-106:
    pts_linears, views_linears, feature_linear, alpha_linear, rgb_linear),
    by state-dict name; torch Adam keys its state by position in it."""
    names = [f"pts_linears.{i}" for i in range(_count(sd, "pts_linears."))]
    names += [f"views_linears.{i}" for i in range(_count(sd, "views_linears."))]
    names += ["feature_linear", "alpha_linear", "rgb_linear"]
    return [f"{n}.{wb}" for n in names for wb in ("weight", "bias")]


def depth_param_order(sd: dict) -> list[str]:
    """The reference DepthNet's ``parameters()`` order (depth_net.py:103-107:
    the three towers, cat_layers at its even indices, to_depth)."""
    names = [f"{t}.{i}" for t in ("origin_layers", "direction_layers", "intersection_layers")
             for i in range(_count(sd, f"{t}."))]
    names += [f"cat_layers.{2 * i}" for i in range(_count(sd, "cat_layers."))]
    names += ["to_depth.0"]
    return [f"{n}.{wb}" for n in names for wb in ("weight", "bias")]


def _adam_state_dict(n_params: int, lr: float, state: dict | None = None) -> dict:
    """A torch-Adam state dict of ``n_params`` parameters (the JAX export's
    layout, nerf_sampling_tpu/train/checkpoint.py:196-226); ``state`` maps
    position -> {"step", "exp_avg", "exp_avg_sq"}, empty for a fresh one."""
    return {
        "state": state or {},
        "param_groups": [{
            "lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0, "amsgrad": False,
            "maximize": False, "foreach": None, "capturable": False, "differentiable": False,
            "fused": None, "params": list(range(n_params)),
        }],
    }


def adam_state_to_torch(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        names: list[str]) -> dict:
    """``optimizer``'s per-parameter state of ``model``, keyed by the
    position of each parameter name in ``names`` (a reference order);
    parameters it has not stepped are left out, as a fresh torch Adam has
    none."""
    params = dict(model.named_parameters())
    state = {}
    for idx, name in enumerate(names):
        st = optimizer.state.get(params[name])
        if st:
            state[idx] = {k: st[k].detach().cpu().clone() for k in ("step", "exp_avg", "exp_avg_sq")}
    return state


def adam_state_from_torch(opt_sd: dict, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          names: list[str]) -> None:
    """Load a reference-layout torch Adam state dict's moments (keyed by
    position in ``names``) into ``optimizer``'s state for ``model``."""
    params = dict(model.named_parameters())
    for idx, st in opt_sd["state"].items():
        p = params[names[idx]]
        optimizer.state[p] = {"step": st["step"].detach().to(p.device, torch.float32).clone(),
                              "exp_avg": st["exp_avg"].to(p.device, p.dtype).clone(),
                              "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype).clone()}


def nerf_state_order(coarse_sd: dict, fine_sd: dict | None) -> list[str]:
    """The names of ``state.nerf_modules``' parameters in the reference's
    joint NeRF optimizer's order (coarse, then fine: its grad_vars,
    nerf_utils.py:417-430)."""
    order = [f"coarse.{n}" for n in nerf_param_order(coarse_sd)]
    if fine_sd is not None:
        order += [f"fine.{n}" for n in nerf_param_order(fine_sd)]
    return order


def export_torch_checkpoint(
    path: str,
    step: int,
    coarse: dict,
    fine: dict | None = None,
    depth: dict | None = None,
    lrate: float = 5e-4,
    depth_net_lr: float = 1e-4,
    nerf_opt: tuple | None = None,
    depth_opt: tuple | None = None,
    lrate_decay: int = 250,
) -> None:
    """Write a reference-format ``.tar`` of the state dicts ``coarse``,
    ``fine`` and ``depth`` (the JAX ``export_torch_checkpoint``).

    ``nerf_opt`` and ``depth_opt`` are the live (module, torch Adam) pairs
    whose moments go into ``optimizer_state_dict`` (the NeRFs'
    ``nerf_modules``) and ``sampling_optimizer_state_dict`` (the
    DepthNet's), in the reference's parameter order; None writes a fresh
    optimizer (depth_net mode's frozen NeRF, as the reference's, Trainer.py:
    538-543). A NeRF without viewdirs always gets a fresh one: the
    reference module registers views_linears whatever use_viewdirs says
    (run_nerf_helpers.py:96), so its positions are not the port's. The
    NeRF's lr is the reference's decayed value at ``step`` (Trainer.py:
    546-551).
    """
    coarse = _fp32_state(coarse)
    data: dict = {"global_step": step, "network_fn_state_dict": coarse}
    n_nerf = len(coarse)
    if fine is not None:
        data["network_fine_state_dict"] = fine = _fp32_state(fine)
        n_nerf += len(fine)
    nerf_state = None
    if nerf_opt is not None and "feature_linear.weight" in coarse:
        nerf_state = adam_state_to_torch(*nerf_opt, nerf_state_order(coarse, fine))
    decayed_lr = lrate * 0.1 ** (step / (lrate_decay * 1000))
    data["optimizer_state_dict"] = _adam_state_dict(n_nerf, decayed_lr, nerf_state)
    depth = _fp32_state(depth) if depth is not None else {}
    data["depth_network"] = depth
    depth_state = None
    if depth_opt is not None and depth:
        depth_state = adam_state_to_torch(*depth_opt, depth_param_order(depth))
    data["sampling_optimizer_state_dict"] = _adam_state_dict(len(depth), depth_net_lr, depth_state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(data, path)
