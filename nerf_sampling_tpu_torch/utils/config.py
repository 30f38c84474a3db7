"""The trainer config (nerf_sampling_tpu/utils/config.py).

``TrainerConfig`` keeps every field of the JAX dataclass, so the same YAML
configs load into it; ``nerf_config``, ``depth_net_config`` and ``pipeline``
build the port's configs. ``load_trainer_config`` reads the reference's
YAML layout {model_key: {module, kwargs}}, e.g. the port's copy of the JAX
package's ``experiments/configs/lego.yaml`` (``definitions.REFERENCE_CONFIG``);
``load_legacy_txt_config`` the reference's legacy ``key = value`` files
(the port's copies in ``experiments/configs/legacy/``), and
``load_obj_from_config`` instantiates a {module, kwargs} entry.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from nerf_sampling_tpu_torch.core.encoding import Embedder
from nerf_sampling_tpu_torch.models.depth_net import DepthNetConfig
from nerf_sampling_tpu_torch.models.nerf import NeRFConfig
from nerf_sampling_tpu_torch.render.engine import Pipeline


@dataclasses.dataclass
class TrainerConfig:
    """Every trainer knob of the JAX TrainerConfig, with the same defaults
    except ``mlp_impl`` (the port's "plain" is the JAX "xla").

    A config file loads to the same fields in both packages. ``pipeline()``
    passes on what the ported eval renders and train steps read; the knobs
    of the unported modes are kept here, and the Trainer raises on those it
    does not port.
    """

    # identity / io
    dataset_type: str = "blender"
    basedir: str = "./logs"
    expname: str = "experiment"
    datadir: str = ""
    config_path: str | None = None
    explicit_keys: frozenset = frozenset()
    device: str = "tpu"  # accepted for reference-config compatibility; unused

    # ray batching / pixel sampling
    N_rand: int = 1024
    no_batching: bool = True
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 64
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    single_image: bool = False
    single_ray: bool = False

    # NeRF architecture
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0
    input_dims_embed: int = 3
    use_viewdirs: bool = True

    # sampling / rendering
    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    lindisp: bool = False
    white_bkgd: bool = True
    near: float = 2.0
    far: float = 6.0

    # dataset options
    half_res: bool = True
    testskip: int = 8
    factor: int = 8
    no_ndc: bool = False
    spherify: bool = False
    llffhold: int = 8
    path_zflat: bool = False
    shape: str = "greek"

    # depth net
    n_layers: int = 6
    layer_width: int = 256
    sphere_radius: float = 2.0
    depth_net_lr: float = 1e-4
    train_depth_net_only: bool = True
    depth_net_path: str | None = None
    n_depth_samples: int = 2
    distance: float = 0.01
    sampling_mode: str = "uniform"

    # optimization
    lrate: float = 5e-4
    lrate_decay: int = 250
    train_mode: str = "depth_net"

    # checkpoints
    ft_path: str | None = None
    no_reload: bool = False
    export_torch_ckpt: bool = True

    # logging / eval cadence
    i_print: int = 100
    i_img: int = 500
    i_weights: int = 10000
    i_testset: int = 20000
    i_video: int = 100000
    n_devices: int = 1
    multihost: bool = False
    save_train_set_render: bool = False
    wandb_mode: str = "disabled"
    keep_best: bool = True
    early_stop_patience: int = 0
    bg_depth_loss_weight: float = 1.0
    joint_depth_warmup: int = 0

    # render-only modes
    render_only: bool = False
    render_test: bool = False
    render_factor: int = 0
    save_scene_data: bool = False
    compare_nerf: bool = False
    use_nerf_max_pts: bool = False
    use_full_nerf: bool = False

    # "plain" (fp32 PyTorch) | "cuda" (hand-written kernels) | "cuda_int8"
    # (their W8A8 int8 MLP for a frozen NeRF); the JAX names map onto them
    mlp_impl: str = "plain"
    steps_per_dispatch: int = 0
    # the plain path's fp32 matmuls: "highest" (strict fp32) | "high" (TF32) |
    # "default" (torch's "medium"); the kernels ignore it (utils/precision.py)
    matmul_precision: str = "highest"

    profile_dir: str | None = None
    debug_nans: bool = False

    seed: int = 42

    def nerf_config(self, fine: bool = False) -> NeRFConfig:
        if self.i_embed == -1:
            input_ch, input_ch_views = 3, 3 if self.use_viewdirs else 0
        else:
            input_ch = Embedder(self.input_dims_embed, self.multires).out_dim
            input_ch_views = (
                Embedder(self.input_dims_embed, self.multires_views).out_dim
                if self.use_viewdirs else 0
            )
        return NeRFConfig(
            D=self.netdepth_fine if fine else self.netdepth,
            W=self.netwidth_fine if fine else self.netwidth,
            input_ch=input_ch,
            input_ch_views=input_ch_views,
            output_ch=5 if self.N_importance > 0 else 4,
            skips=(4,),
            use_viewdirs=self.use_viewdirs,
        )

    def depth_net_config(self) -> DepthNetConfig:
        # reference sampling_trainer.py:68-74: hidden == cat == [width]*n_layers
        sizes = tuple(self.layer_width for _ in range(self.n_layers))
        return DepthNetConfig(
            hidden_sizes=sizes,
            cat_hidden_sizes=sizes,
            multires=10,
            sphere_radius=self.sphere_radius,
            near=self.near,
            far=self.far,
        )

    def pipeline(self, with_depth: bool = True) -> Pipeline:
        return Pipeline(
            nerf=self.nerf_config(False),
            fine=self.nerf_config(True) if self.N_importance > 0 else None,
            depth=self.depth_net_config() if with_depth else None,
            multires=self.multires,
            multires_views=self.multires_views,
            i_embed=self.i_embed,
            N_samples=self.N_samples,
            N_importance=self.N_importance,
            perturb=self.perturb,
            raw_noise_std=self.raw_noise_std,
            white_bkgd=self.white_bkgd,
            lindisp=self.lindisp,
            use_viewdirs=self.use_viewdirs,
            ndc=self.dataset_type == "llff" and not self.no_ndc,
            near=self.near,
            far=self.far,
            n_depth_samples=self.n_depth_samples,
            sampling_mode=self.sampling_mode,
            distance=self.distance,
            bg_depth_loss_weight=self.bg_depth_loss_weight,
            joint_depth_warmup=self.joint_depth_warmup,
            mlp_impl=self.mlp_impl,
            netchunk=self.netchunk,
            matmul_precision=self.matmul_precision,
        )


# the CLIs' --mlp_impl help for the int8 mode (the JAX CLIs' warning)
INT8_HELP = (
    "cuda_int8 (the JAX pallas_int8): the W8A8 int8 kernels, auto-calibrated on the loaded checkpoint; "
    "NOT recommended for final renders: the JAX package measured trained fields losing about 8.8 dB "
    "under int8 activations (RESULTS.md); it is quality-safe as the frozen-NeRF oracle of depth-net "
    "training."
)


def override_config(config: dict, update: dict) -> None:
    """Strict-key dict merge (reference utils.py:125-140)."""
    for key, value in update.items():
        if key not in config:
            raise KeyError(f"Key {key} does not exist in config")
        config[key] = value


def load_obj_from_config(cfg: dict) -> Any:
    """Dynamic {"module", "kwargs"} instantiation (reference utils.py:12-21)."""
    module_name, class_name = cfg["module"].rsplit(".", maxsplit=1)
    cls = getattr(importlib.import_module(module_name), class_name)
    return cls(**cfg["kwargs"])


def _coerce(kwargs: dict) -> dict:
    """Drop YAML 'None' placeholders and unknown keys -> TrainerConfig kwargs."""
    fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    return {
        k: (None if isinstance(v, str) and v == "None" else v)
        for k, v in kwargs.items()
        if k in fields
    }


def load_trainer_config(path: str, model_key: str | None = None) -> TrainerConfig:
    """Load a YAML experiment config ({model_key: {module, kwargs}}) into a TrainerConfig."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    if model_key is not None and model_key in doc:
        doc = doc[model_key]
    coerced = _coerce(doc.get("kwargs", doc))
    cfg = TrainerConfig(**coerced)
    cfg.config_path = path
    cfg.explicit_keys = frozenset(coerced)
    return cfg


# the legacy configs' store_true flags (reference config_parser)
_LEGACY_FLAGS = {
    "no_batching", "no_reload", "use_viewdirs", "white_bkgd", "half_res",
    "no_ndc", "lindisp", "spherify", "render_only", "render_test",
}


def load_legacy_txt_config(path: str) -> TrainerConfig:
    """Parse a legacy configargparse .txt config (reference
    nerf_pytorch/configs/*.txt: 'key = value' lines, '#' comments)."""
    kwargs: dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if key in _LEGACY_FLAGS:
                kwargs[key] = value.lower() in ("true", "1", "yes", "")
                continue
            for cast in (int, float):
                try:
                    value = cast(value)
                    break
                except (TypeError, ValueError):
                    continue
            kwargs[key] = value
    coerced = _coerce(kwargs)
    cfg = TrainerConfig(**coerced)
    cfg.explicit_keys = frozenset(coerced)
    return cfg
