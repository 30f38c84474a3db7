"""The system under test, built from a configuration file and the raw checkpoint arrays.

The only module of the benchmark besides the drivers that imports the
program (``nerf_sampling_tpu_torch``): its Pipeline from the
configuration's widths, its modules loaded from the same arrays that the
reference is handed (through the program's own loader), its kernel packs.
"""

from __future__ import annotations

import dataclasses

from nerf_sampling_tpu_torch.models import DepthNet, NeRF
from nerf_sampling_tpu_torch.models.depth_net import DepthNetConfig
from nerf_sampling_tpu_torch.models.nerf import NeRFConfig
from nerf_sampling_tpu_torch.render.engine import NeRFParams, Pipeline
from nerf_sampling_tpu_torch.train.checkpoint import params_from_jax


def nerf_config(net: dict) -> NeRFConfig:
    return NeRFConfig(D=net["D"], W=net["W"], input_ch=3 * (1 + 2 * net["multires"]),
                      input_ch_views=3 * (1 + 2 * net["multires_views"]), output_ch=5,
                      skips=tuple(net["skips"]), use_viewdirs=True)


def pipeline(cfg: dict, mlp_impl: str, **overrides) -> Pipeline:
    """The program's Pipeline of a configuration file."""
    dn = cfg.get("depth_net")
    depth = None if dn is None else DepthNetConfig(
        hidden_sizes=(dn["layer_width"],) * dn["n_layers"], cat_hidden_sizes=(dn["layer_width"],) * dn["n_layers"],
        multires=dn["multires"], sphere_radius=dn["sphere_radius"], near=cfg["near"], far=cfg["far"])
    p = Pipeline(
        nerf=nerf_config(cfg["nerf"]), fine=nerf_config(cfg["nerf_fine"]), depth=depth,
        multires=cfg["nerf"]["multires"], multires_views=cfg["nerf"]["multires_views"],
        N_samples=cfg["N_samples"], N_importance=cfg["N_importance"], perturb=cfg["perturb"],
        white_bkgd=cfg["white_bkgd"], near=cfg["near"], far=cfg["far"],
        n_depth_samples=cfg.get("n_depth_samples", 2), sampling_mode=cfg.get("sampling_mode", "uniform"),
        distance=cfg.get("distance", 0.01), bg_depth_loss_weight=cfg.get("bg_depth_loss_weight", 1.0),
        mlp_impl=mlp_impl, matmul_precision=cfg["matmul_precision"],
    )
    return dataclasses.replace(p, **overrides)


def modules(pipe: Pipeline, raw: dict, device, with_depth: bool) -> NeRFParams:
    """The NeRFs (and the DepthNet) loaded from the raw arrays by the program's loader."""
    sds = params_from_jax({k: raw[k] for k in (("coarse", "fine", "depth") if with_depth else ("coarse", "fine"))})

    def build(module, sd):
        module.load_state_dict(sd, strict=True)
        return module.to(device)

    return NeRFParams(coarse=build(NeRF(pipe.nerf), sds["coarse"]), fine=build(NeRF(pipe.fine), sds["fine"]),
                      depth=build(DepthNet(pipe.depth), sds["depth"]) if with_depth else None)


def param_names(kind: str) -> dict[str, str]:
    """The program's parameter name -> the raw tree's leaf name."""
    if kind == "depth":
        names = {f"{t}.{i}.{w}": f"{t}.{i}.{w}" for t in ("origin_layers", "direction_layers", "intersection_layers")
                 for i in range(64) for w in ("weight", "bias")}
        names.update({f"cat_layers.{2 * i}.{w}": f"cat_layers.{i}.{w}" for i in range(64) for w in ("weight", "bias")})
        names.update({f"to_depth.0.{w}": f"to_depth.{w}" for w in ("weight", "bias")})
        return names
    out = {}
    for net in ("coarse", "fine"):
        for layer in ("feature_linear", "alpha_linear", "rgb_linear"):
            for w in ("weight", "bias"):
                out[f"{net}.{layer}.{w}"] = f"{net}.{layer}.{w}"
        for layer in ("pts_linears", "views_linears"):
            for i in range(64):
                for w in ("weight", "bias"):
                    out[f"{net}.{layer}.{i}.{w}"] = f"{net}.{layer}.{i}.{w}"
    return out

