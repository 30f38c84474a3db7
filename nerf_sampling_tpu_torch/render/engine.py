"""DepthNet render path (nerf_sampling_tpu/render/engine.py).

Two implementations of one eval render, chosen by ``Pipeline.mlp_impl``:

- ``"plain"``: the fp32 PyTorch path. DepthNet module -> uniform (or
  gaussian) population -> NeRF module -> ``raw2outputs``, over ray chunks,
  with per-sample outputs. It is the CPU path and the kernels' oracle.
- ``"cuda"``: the hand-written kernels, K1 (DepthNet) then K2
  (populate-and-shade), over all rays at once, with map-level outputs. On
  CPU tensors their wrappers run the kernels' plain versions at bf16.

The JAX names map onto these ("xla" -> "plain", "pallas" -> "cuda");
"pallas_int8" is not ported. Only EvalMode.DEPTH_NET is ported; the other
modes and the fused gaussian population raise NotImplementedError naming
their ROADMAP item, and nothing falls back quietly to the plain path.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch

from nerf_sampling_tpu_torch.core.compositing import raw2outputs
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.core.rays import get_rays
from nerf_sampling_tpu_torch.core.sampling import sample_points_around_mean
from nerf_sampling_tpu_torch.kernels import fused_depth_net, fused_render
from nerf_sampling_tpu_torch.models.depth_net import DepthNet, DepthNetConfig
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.utils.precision import strict_fp32

PLAIN, CUDA = "plain", "cuda"
_JAX_IMPL_NAMES = {"xla": PLAIN, "pallas": CUDA}


class EvalMode(enum.Enum):
    """Test-time rendering modes (reference render_rays_test)."""

    DEPTH_NET = "depth_net"
    COMPARE_NERF = "compare_nerf"
    NERF_MAX = "nerf_max"
    FULL_NERF = "full_nerf"


class KernelWeights(NamedTuple):
    """The bf16 weight layouts that K1 and K2 read (``pack_kernel_weights``)."""

    depth: dict  # fused_depth_net.pack_depth_net of the DepthNet
    nerf: dict  # fused_render.pack_nerf of the NeRF that renders: fine, else coarse


class NeRFParams(NamedTuple):
    """The models of one render; fine and depth may be None.

    ``kernels`` holds their packed layouts for ``mlp_impl="cuda"``; without
    it the kernel path packs them again on every call.
    """

    coarse: NeRF
    fine: NeRF | None = None
    depth: DepthNet | None = None
    kernels: KernelWeights | None = None


def pack_kernel_weights(params: NeRFParams) -> NeRFParams:
    """``params`` with the kernels' packed weights, made once from the modules
    as they are now (pack again after changing their weights)."""
    model = params.fine if params.fine is not None else params.coarse
    return params._replace(kernels=KernelWeights(
        depth=fused_depth_net.pack_depth_net(params.depth, torch.bfloat16),
        nerf=fused_render.pack_nerf(model, torch.bfloat16),
    ))


class RayBatch(NamedTuple):
    rays_o: torch.Tensor  # [N, 3]
    rays_d: torch.Tensor  # [N, 3]
    viewdirs: torch.Tensor | None  # [N, 3] unit, or None
    near: torch.Tensor  # [N, 1]
    far: torch.Tensor  # [N, 1]


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Static rendering configuration (field names as in the JAX Pipeline).

    Only the fields that the DEPTH_NET eval render reads are here; the JAX
    Pipeline's coarse-sampling fields (N_samples, N_importance, perturb,
    raw_noise_std, lindisp) come with the modes that read them (ROADMAP S4).
    """

    nerf: NeRFConfig
    fine: NeRFConfig | None = None
    depth: DepthNetConfig | None = None
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0  # -1 disables positional encoding
    white_bkgd: bool = True
    use_viewdirs: bool = True
    ndc: bool = False
    near: float = 2.0
    far: float = 6.0
    n_depth_samples: int = 2
    sampling_mode: str = "uniform"
    distance: float = 0.01
    # "plain" (fp32 PyTorch) or "cuda" (the hand-written kernels)
    mlp_impl: str = PLAIN
    netchunk: int = 1024 * 64

    def __post_init__(self):
        impl = _JAX_IMPL_NAMES.get(self.mlp_impl, self.mlp_impl)
        if impl == "pallas_int8":
            raise NotImplementedError(
                "mlp_impl='pallas_int8' (the W8A8 kernels, K10) is not ported: ROADMAP S8"
            )
        if impl not in (PLAIN, CUDA):
            raise ValueError(f"mlp_impl must be '{PLAIN}' or '{CUDA}', got {self.mlp_impl!r}")
        object.__setattr__(self, "mlp_impl", impl)

    def embed_pts(self, pts: torch.Tensor) -> torch.Tensor:
        return pts if self.i_embed == -1 else positional_encoding(pts, self.multires)

    def embed_dirs(self, dirs: torch.Tensor) -> torch.Tensor:
        return dirs if self.i_embed == -1 else positional_encoding(dirs, self.multires_views)


def make_ray_batch(pipeline: Pipeline, rays_o: torch.Tensor, rays_d: torch.Tensor) -> RayBatch:
    """Unit viewdirs and per-ray bounds (reference prepare_rays)."""
    if pipeline.ndc:
        raise NotImplementedError("NDC rays are not ported yet: ROADMAP S6")
    viewdirs = None
    if pipeline.use_viewdirs:
        viewdirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)).reshape(-1, 3)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    near = torch.full_like(rays_d[..., :1], pipeline.near)
    far = torch.full_like(rays_d[..., :1], pipeline.far)
    return RayBatch(rays_o, rays_d, viewdirs, near, far)


def query_nerf(
    pipeline: Pipeline, model: NeRF, pts: torch.Tensor, viewdirs: torch.Tensor | None
) -> torch.Tensor:
    """Embed [N, S, 3] points (+ dirs) and evaluate the NeRF, netchunk points at a time."""
    if viewdirs is not None:
        flat_in = torch.cat([pts, viewdirs[:, None, :].expand(pts.shape)], -1).reshape(-1, 6)
    else:
        flat_in = pts.reshape(-1, 3)
    outs = []
    for chunk_in in torch.split(flat_in, pipeline.netchunk):
        emb = pipeline.embed_pts(chunk_in[:, :3])
        if viewdirs is not None:
            emb = torch.cat([emb, pipeline.embed_dirs(chunk_in[:, 3:6])], -1)
        outs.append(model(emb))
    raw = torch.cat(outs, 0)
    return raw.reshape(*pts.shape[:-1], raw.shape[-1])


def _unported_mode(mode: EvalMode) -> NotImplementedError:
    return NotImplementedError(
        f"EvalMode.{mode.name} needs the hierarchical sampler and its kernels "
        "(K6-K8): ROADMAP S4"
    )


def render_rays_eval(
    pipeline: Pipeline,
    params: NeRFParams,
    rays: RayBatch,
    mode: EvalMode = EvalMode.DEPTH_NET,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """DEPTH_NET eval render of one ray batch on the plain path (reference
    render_rays_test)."""
    if mode != EvalMode.DEPTH_NET:
        raise _unported_mode(mode)
    depth_mean = params.depth(rays.rays_o, rays.rays_d)
    depth_pts, depth_z = sample_points_around_mean(
        rays.rays_o, rays.rays_d, depth_mean,
        n_samples=pipeline.n_depth_samples, mode=pipeline.sampling_mode,
        std=pipeline.distance, generator=generator,
    )
    model = params.fine if params.fine is not None else params.coarse
    depth_raw = query_nerf(pipeline, model, depth_pts, rays.viewdirs)
    out = raw2outputs(depth_raw, depth_z, rays.rays_d, 0.0, pipeline.white_bkgd)
    return {
        "depth_net_rgb_map": out.rgb_map,
        "depth_net_disp_map": out.disp_map,
        "depth_net_weights": out.weights,
        "depth_net_pts": depth_pts,
        "depth_net_z_vals": depth_z,
    }


def _fused_fast_paths(
    pipeline: Pipeline,
    params: NeRFParams,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mode: EvalMode,
) -> dict[str, torch.Tensor]:
    """DEPTH_NET uniform through K1 and K2; flat [N, ...] map-level outputs."""
    p = pipeline
    if mode != EvalMode.DEPTH_NET:
        raise _unported_mode(mode)
    if p.sampling_mode == "gaussian":
        raise NotImplementedError(
            "the fused gaussian population (K3, in-kernel Philox) is not ported: ROADMAP S4"
        )
    if p.sampling_mode != "uniform" or not 1 < p.n_depth_samples <= fused_render.MAX_SAMPLES:
        raise ValueError(
            "mlp_impl='cuda' renders the uniform population with 2.."
            f"{fused_render.MAX_SAMPLES} samples; got {p.sampling_mode}/{p.n_depth_samples}"
        )
    if not p.use_viewdirs or p.i_embed == -1:
        raise ValueError("mlp_impl='cuda' needs use_viewdirs and positional encoding")
    if p.ndc:
        raise NotImplementedError("NDC rays are not ported yet: ROADMAP S6")
    ro, rd = rays_o.reshape(-1, 3).contiguous(), rays_d.reshape(-1, 3).contiguous()
    if params.kernels is None:
        params = pack_kernel_weights(params)
    depth = fused_depth_net.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    model = params.fine if params.fine is not None else params.coarse
    maps = fused_render.fused_render_around_depth(
        params.kernels.nerf, model.cfg, ro, rd, depth, n_samples=p.n_depth_samples, std=p.distance,
        white_bkgd=p.white_bkgd, multires=p.multires, multires_views=p.multires_views,
    )
    return {
        "depth_net_rgb_map": maps["rgb_map"],
        "depth_net_disp_map": maps["disp_map"],
        "depth_net_weights": maps["acc_map"],
        "depth_net_z_vals": maps["depth_map"],
        "depth_net_pts": ro.new_zeros((ro.shape[0], 0, 3)),
    }


@torch.no_grad()
def render_flat_rays(
    pipeline: Pipeline,
    params: NeRFParams,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mode: EvalMode = EvalMode.DEPTH_NET,
    chunk: int = 1024 * 32,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Render flat [N, 3] rays -> dict of flat [N, ...] maps.

    ``mlp_impl="cuda"`` takes the kernels over all rays at once;
    ``"plain"`` renders ``chunk`` rays at a time.
    """
    if pipeline.mlp_impl == CUDA:
        return _fused_fast_paths(pipeline, params, rays_o, rays_d, mode)
    strict_fp32()
    rays = make_ray_batch(pipeline, rays_o, rays_d)
    n = rays.rays_o.shape[0]
    pieces: dict[str, list[torch.Tensor]] = {}
    for s in range(0, n, chunk):
        tile = RayBatch(*(x[s : s + chunk] for x in rays))
        for name, v in render_rays_eval(pipeline, params, tile, mode, generator).items():
            pieces.setdefault(name, []).append(v)
    return {name: torch.cat(v, 0) for name, v in pieces.items()}


def render_image(
    pipeline: Pipeline,
    params: NeRFParams,
    H: int,
    W: int,
    K,
    c2w,
    *,
    device: torch.device | str,
    mode: EvalMode = EvalMode.DEPTH_NET,
    chunk: int = 1024 * 32,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Render a full image on ``device``: rays -> render_flat_rays -> [H, W, ...] maps."""
    rays_o, rays_d = get_rays(H, W, K, c2w, device)
    flat = render_flat_rays(
        pipeline, params, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
        mode=mode, chunk=chunk, generator=generator,
    )
    return {name: v.reshape(H, W, *v.shape[1:]) for name, v in flat.items()}
