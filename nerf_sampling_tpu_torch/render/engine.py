"""Render and train paths (nerf_sampling_tpu/render/engine.py).

Two implementations of each eval render, chosen by ``Pipeline.mlp_impl``:

- ``"plain"``: the fp32 PyTorch path, over ray chunks, with per-sample
  outputs. DEPTH_NET: DepthNet module -> uniform (or gaussian) population
  -> NeRF module -> ``raw2outputs``; FULL_NERF: the hierarchical pass at
  perturb 0; NERF_MAX: its argmax sample alone; COMPARE_NERF: both, the
  argmax diagnostics beside the DepthNet's render. It is the CPU path and
  the kernels' oracle.
- ``"cuda"``: the hand-written kernels over all rays at once, with
  map-level outputs. DEPTH_NET: K1 (DepthNet) then K2 (uniform
  populate-and-shade) or K3 (gaussian); FULL_NERF: K7 (the deterministic
  hierarchical pass), or K8 (the linspace render of the coarse NeRF) when
  N_importance is 0; NERF_MAX: K7's argmax sample; COMPARE_NERF, the
  diagnostic mode: K7, K1 and K9 (shading the population drawn on the
  plain side), all in fp32. On CPU tensors their wrappers run the kernels'
  plain versions at the kernels' dtype. Outside the kernels' envelope the
  JAX package drops to its composable path; the port raises ValueError
  naming the envelope. Under NDC (forward-facing scenes) the kernels' fast
  path does not apply, as in the JAX package, and "cuda" takes the chunked
  composable route, every MLP on a kernel: DEPTH_NET runs K1 for the depth
  mean, the population in PyTorch, and K4 for its queries; FULL_NERF and
  NERF_MAX the hierarchical pass with K4 queries. COMPARE_NERF under NDC
  raises (the JAX package swaps in its fp32 XLA path there).
- ``"cuda_int8"``: the same kernels with the W8A8 int8 MLP (K10) in the
  NeRF passes of DEPTH_NET (K1 bf16, then K2/K3 int8), FULL_NERF (K7
  int8, or K8 int8 on the coarse NeRF) and NERF_MAX (K7 int8), under the
  per-checkpoint calibration in ``Pipeline.quant_calib``
  (``render/quantize.py``). COMPARE_NERF stays exactly the fp32 path of
  "cuda", and the train queries stay on K4/K5 in bf16 (JAX
  ``render/engine.py:209-232, 662-667``). It raises under NDC, where the
  JAX package has no int8 route and renders bf16 under the int8 flag.

A Pipeline whose ``nerf`` is a ``MipNeRFConfig`` renders mip-NeRF (its
MLP the ``MipNeRF`` module in ``NeRFParams.coarse``, ``fine`` None): in
FULL_NERF, on rays through pixel centres with radii (``render_image``), the
two deterministic levels of its configuration. ``"plain"`` runs the
published math on the module in fp32 (``render_rays_mip``, ray chunks);
``"cuda"`` runs K11 (``kernels/fused_mip.py``), one launch for all rays of
a call, from the pack in ``KernelWeights.mip``. No int8, NDC or other mode.

The train renderers (``sample_as_in_nerf``, ``render_rays_train``,
``render_rays_vanilla``, ``render_rays_joint``) are autograd PyTorch; under
``"cuda"`` every NeRF query of the hierarchical pass goes through K4 with
K5 as its backward (``query_nerf``), and the depth-point query stays plain
fp32 (its gradient w.r.t. the points trains the DepthNet). The depth-net
step puts its frozen-NeRF pass on K6 (``train/steps.py``), int8 under
"cuda_int8". The JAX names map onto these ("xla" -> "plain", "pallas" ->
"cuda", "pallas_int8" -> "cuda_int8"). Nothing falls back quietly to the
plain path or to bf16.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import torch

from nerf_sampling_tpu_torch.core.compositing import RenderOutputs, raw2outputs
from nerf_sampling_tpu_torch.core.encoding import integrated_pos_enc, mip_pos_enc, positional_encoding
from nerf_sampling_tpu_torch.core.rays import get_rays, get_rays_mip, ndc_rays
from nerf_sampling_tpu_torch.core.sampling import (
    Rows,
    sample_pdf,
    sample_points_around_mean,
    stratified_z_vals,
    z_to_points,
)
from nerf_sampling_tpu_torch.kernels import fused_depth_net, fused_hier, fused_mip, fused_nerf_vjp, fused_render, quant
from nerf_sampling_tpu_torch.models.depth_net import DepthNet, DepthNetConfig
from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig, render_levels
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.utils import profiling
from nerf_sampling_tpu_torch.utils.precision import check_precision, matmul_precision

PLAIN, CUDA, CUDA_INT8 = "plain", "cuda", "cuda_int8"
KERNEL_IMPLS = (CUDA, CUDA_INT8)  # the impls that run the hand-written kernels
_JAX_IMPL_NAMES = {"xla": PLAIN, "pallas": CUDA, "pallas_int8": CUDA_INT8}


class EvalMode(enum.Enum):
    """Test-time rendering modes (reference render_rays_test)."""

    DEPTH_NET = "depth_net"
    COMPARE_NERF = "compare_nerf"
    NERF_MAX = "nerf_max"
    FULL_NERF = "full_nerf"


class KernelWeights(NamedTuple):
    """The weight layouts that the kernels read (``pack_kernel_weights``):
    bf16, or int8 NeRF packs under "cuda_int8" (``quant.qpack_nerf`` and
    ``fused_hier.qpack_hier``; each pack says which it is, and the kernel
    wrappers run the int8 kernels on int8 packs), and the COMPARE mode's
    fp32 packs in ``fp32``."""

    depth: dict | None  # fused_depth_net.pack_depth_net of the DepthNet (K1, bf16 under cuda_int8 too)
    nerf: dict | None  # fused_render.pack_nerf of the NeRF that renders: fine, else coarse (K2, K3, K9)
    hier: dict | None = None  # fused_hier.pack_hier of coarse and fine (K6, K7)
    coarse: dict | None = None  # fused_render.pack_nerf of the coarse NeRF (K8)
    fp32: KernelWeights | None = None  # depth, nerf and hier at fp32 (COMPARE_NERF: K1, K9, K7)
    mip: dict | None = None  # fused_mip.pack_mip of a mip-NeRF (K11; nerf is None then)


class NeRFParams(NamedTuple):
    """The models of one render; fine and depth may be None.

    ``kernels`` holds their packed layouts for ``mlp_impl="cuda"``; without
    it the kernel path packs them again on every call.
    """

    coarse: NeRF | MipNeRF
    fine: NeRF | None = None
    depth: DepthNet | None = None
    kernels: KernelWeights | None = None


def _packs(params: NeRFParams, dtype: torch.dtype, with_hier: bool, with_coarse: bool = False,
           quant_pair: tuple[quant.QuantCalib, quant.QuantCalib] | None = None) -> KernelWeights:
    if isinstance(params.coarse, MipNeRF):  # K11 runs bf16 alone
        return KernelWeights(depth=None, nerf=None, mip=fused_mip.pack_mip(params.coarse))
    model = params.fine if params.fine is not None else params.coarse
    depth = params.depth
    if quant_pair is not None:
        qc, qf = quant_pair
        nerf, coarse = quant.qpack_nerf(model, qf), quant.qpack_nerf(params.coarse, qc) if with_coarse else None
        hier = fused_hier.qpack_hier(params.coarse, params.fine, quant_pair) if with_hier else None
    else:
        nerf = fused_render.pack_nerf(model, dtype)
        coarse = fused_render.pack_nerf(params.coarse, dtype) if with_coarse else None
        hier = fused_hier.pack_hier(params.coarse, params.fine, dtype) if with_hier else None
    return KernelWeights(
        depth=fused_depth_net.pack_depth_net(depth, dtype) if depth is not None else None,
        nerf=nerf, hier=hier, coarse=coarse,
    )


def pack_kernel_weights(params: NeRFParams, with_hier: bool = False, with_coarse: bool = False,
                        with_fp32: bool = False,
                        quant_pair: tuple[quant.QuantCalib, quant.QuantCalib] | None = None) -> NeRFParams:
    """``params`` with the kernels' packed weights: bf16 copies of the
    modules' weights as they are at this call.

    A pack does not follow later changes to the modules. Pack again (or
    ``repack_depth``) after any change to their weights: the Trainer repacks
    before every eval what its steps changed (the DepthNets' packs in
    depth-net mode; every pack in nerf and joint mode); a frozen NeRF's
    packs are made once. ``with_hier`` adds the pack of K6 and K7,
    ``with_coarse`` the coarse NeRF's for K8 and ``with_fp32`` the fp32
    packs of COMPARE_NERF (``eval_packs`` names what an eval mode reads). A
    mip-NeRF's is its K11 pack alone.
    ``quant_pair``, the (coarse, fine) QuantCalibs, makes the NeRFs' packs
    int8 under them (the DepthNet's stays bf16).
    """
    return params._replace(kernels=_packs(params, torch.bfloat16, with_hier, with_coarse, quant_pair)._replace(
        fp32=_packs(params, torch.float32, True) if with_fp32 else None))


def quant_pair(pipeline: Pipeline, params: NeRFParams) -> tuple[quant.QuantCalib, quant.QuantCalib] | None:
    """The (coarse, fine) QuantCalibs of a "cuda_int8" pipeline, else None
    (JAX ``_quant_pair``); without a fine NeRF the fine slot reuses the
    coarse calib."""
    if pipeline.mlp_impl != CUDA_INT8:
        return None
    if pipeline.quant_calib is None:
        raise ValueError(
            "mlp_impl='cuda_int8' needs pipeline.quant_calib: calibrate the checkpoint first "
            "(render.quantize.calibrate_pipeline)"
        )
    qc, qf = pipeline.quant_calib
    return (qc, qc) if params.fine is None else (qc, qf)


def is_mip(pipeline: Pipeline) -> bool:
    """Whether the pipeline renders mip-NeRF (its ``nerf`` a ``MipNeRFConfig``)."""
    return isinstance(pipeline.nerf, MipNeRFConfig)


def eval_packs(pipeline: Pipeline, mode: EvalMode, params: NeRFParams | None = None) -> dict[str, Any]:
    """The ``pack_kernel_weights`` arguments of what the kernel path of
    ``mode`` reads; under "cuda_int8" (COMPARE_NERF aside) also the
    ``quant_pair`` of ``params``."""
    if pipeline.ndc or is_mip(pipeline):  # NDC's composable route: K1 reads the DepthNet's pack; K4 packs the
        return {"with_hier": False, "with_coarse": False, "with_fp32": False}  # live NeRF weights; mip: K11's
    hier = pipeline.N_importance > 0
    packs: dict[str, Any] = {
        "with_hier": mode in (EvalMode.FULL_NERF, EvalMode.NERF_MAX) and hier,
        "with_coarse": mode == EvalMode.FULL_NERF and not hier,
        "with_fp32": mode == EvalMode.COMPARE_NERF,
    }
    if pipeline.mlp_impl == CUDA_INT8 and mode != EvalMode.COMPARE_NERF and params is not None:
        packs["quant_pair"] = quant_pair(pipeline, params)
    return packs


def make_nerf_slices(kernels: KernelWeights) -> None:
    """Make the forward weight slices of every NeRF pack in ``kernels`` now
    (``fused_render.pack_slices``, kept in each pack): the full forward of
    the nerf and coarse packs and of the hier pack's fine net, the trunk
    and alpha head of its coarse net. The Trainer makes a frozen NeRF's at
    setup, so that they do not first appear, and stay, at the first eval."""
    if kernels.mip is not None:
        fused_render.pack_slices(kernels.mip)
    for k in (kernels, kernels.fp32):
        if k is None:
            continue
        for pack in (k.nerf, k.coarse):
            if pack is not None:
                fused_render.pack_slices(pack)
        if k.hier is not None:
            fused_render.pack_slices(k.hier["coarse"], sigma_only=True)
            fused_render.pack_slices(k.hier["fine"])


def repack_depth(params: NeRFParams) -> NeRFParams:
    """``params`` with the DepthNet's packs (bf16, and fp32 where there are
    fp32 packs) made anew and the NeRF's packs kept."""
    k = params.kernels
    fp32 = k.fp32
    if fp32 is not None:
        fp32 = fp32._replace(depth=fused_depth_net.pack_depth_net(params.depth, torch.float32))
    return params._replace(kernels=k._replace(
        depth=fused_depth_net.pack_depth_net(params.depth, torch.bfloat16), fp32=fp32))


class RayBatch(NamedTuple):
    rays_o: torch.Tensor  # [N, 3]
    rays_d: torch.Tensor  # [N, 3]
    viewdirs: torch.Tensor | None  # [N, 3] unit, or None
    near: torch.Tensor  # [N, 1]
    far: torch.Tensor  # [N, 1]


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Static rendering configuration (field names as in the JAX Pipeline).

    ``H``, ``W`` and ``focal`` are the image geometry of the NDC
    reprojection: the Trainer sets them from the scene under ``ndc``, since
    the train steps see only flat ray batches; arguments to
    ``make_ray_batch`` win over them (a full-image render passes its own).
    """

    nerf: NeRFConfig | MipNeRFConfig  # a MipNeRFConfig renders mip-NeRF (module docstring)
    fine: NeRFConfig | None = None
    depth: DepthNetConfig | None = None
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0  # -1 disables positional encoding
    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = True
    lindisp: bool = False
    use_viewdirs: bool = True
    ndc: bool = False
    near: float = 2.0
    far: float = 6.0
    H: int | None = None
    W: int | None = None
    focal: float | None = None
    n_depth_samples: int = 2
    sampling_mode: str = "uniform"
    distance: float = 0.01
    # down-weights the depth MSE of background rays (hierarchical acc <=
    # 0.5) in depth-net and joint training; 1.0 is the reference objective
    bg_depth_loss_weight: float = 1.0
    # joint training: the DepthNet and its loss terms stay out of the step
    # for the NeRF's first joint_depth_warmup steps (0: off)
    joint_depth_warmup: int = 0
    # "plain" (fp32 PyTorch), "cuda" (the hand-written kernels) or
    # "cuda_int8" (their W8A8 int8 MLP in the eval renders and the oracle)
    mlp_impl: str = PLAIN
    netchunk: int = 1024 * 64
    # "cuda_int8": the (coarse, fine) kernels.quant.QuantCalibs
    # (render.quantize.calibrate_pipeline); tied to the calibrated checkpoint
    quant_calib: tuple[quant.QuantCalib, quant.QuantCalib] | None = None
    # the plain path's fp32 matmul precision (the JAX NeRF/DepthNet configs'
    # ``precision``): "highest", "high" (TF32) or "default" (torch's
    # "medium"), applied in a scope around each plain render and train step
    # (utils/precision.py); the kernels ignore it
    matmul_precision: str = "highest"

    def __post_init__(self):
        impl = _JAX_IMPL_NAMES.get(self.mlp_impl, self.mlp_impl)
        if impl not in (PLAIN,) + KERNEL_IMPLS:
            raise ValueError(f"mlp_impl must be '{PLAIN}', '{CUDA}' or '{CUDA_INT8}', got {self.mlp_impl!r}")
        object.__setattr__(self, "mlp_impl", impl)
        check_precision(self.matmul_precision)
        if is_mip(self) and (impl == CUDA_INT8 or self.ndc):
            raise ValueError("a mip-NeRF pipeline renders with mlp_impl 'plain' or 'cuda', without NDC")

    def embed_pts(self, pts: torch.Tensor) -> torch.Tensor:
        return pts if self.i_embed == -1 else positional_encoding(pts, self.multires)

    def embed_dirs(self, dirs: torch.Tensor) -> torch.Tensor:
        return dirs if self.i_embed == -1 else positional_encoding(dirs, self.multires_views)


def make_ray_batch(
    pipeline: Pipeline,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    H: int | None = None,
    W: int | None = None,
    focal: float | None = None,
) -> RayBatch:
    """Unit viewdirs, the NDC reprojection under ``pipeline.ndc`` and
    per-ray bounds (reference prepare_rays, nerf_utils.py:156-188).

    The viewdirs are the directions before the reprojection; H, W and focal
    come from the arguments, else from the pipeline.
    """
    viewdirs = None
    if pipeline.use_viewdirs:
        viewdirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)).reshape(-1, 3)
    if pipeline.ndc:
        H = H if H is not None else pipeline.H
        W = W if W is not None else pipeline.W
        focal = focal if focal is not None else pipeline.focal
        if focal is None or H is None or W is None:
            raise ValueError("NDC reprojection needs H/W/focal: pass them to make_ray_batch or set them on "
                             "the Pipeline")
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    near = torch.full_like(rays_d[..., :1], pipeline.near)
    far = torch.full_like(rays_d[..., :1], pipeline.far)
    return RayBatch(rays_o, rays_d, viewdirs, near, far)


def check_kernel_queries(p: Pipeline) -> None:
    """What K4/K5 (and K6/K7) take of a "cuda" or "cuda_int8" pipeline; raises, naming
    what is missing (the JAX package drops to XLA outside its kernels'
    envelope; the port does not fall back). NDC points are queried as any
    others."""
    if not p.use_viewdirs or p.i_embed == -1:
        raise ValueError("mlp_impl='cuda' needs use_viewdirs and positional encoding")


def _query_plain(
    pipeline: Pipeline, model: NeRF, pts: torch.Tensor, viewdirs: torch.Tensor | None
) -> torch.Tensor:
    """Embed [N, S, 3] points (+ dirs) and evaluate the NeRF module,
    netchunk points at a time (fp32 autograd)."""
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


def query_nerf(
    pipeline: Pipeline,
    model: NeRF,
    pts: torch.Tensor,
    viewdirs: torch.Tensor | None,
    *,
    input_grads: bool = True,
) -> torch.Tensor:
    """Raw [N, S, 4] of the NeRF at [N, S, 3] points with per-ray unit
    viewdirs [N, 3] (reference run_network).

    ``"plain"``: the module in fp32 autograd. ``"cuda"`` and ``"cuda_int8"``
    (train queries stay bf16): K4, with K5 as its backward
    (``fused_nerf_train_apply``), over all points at once;
    ``input_grads=False`` drops dL/d(points, viewdirs) from K5 and is right
    only when the loss does not differentiate through them.
    """
    if pipeline.mlp_impl not in KERNEL_IMPLS:
        return _query_plain(pipeline, model, pts, viewdirs)
    check_kernel_queries(pipeline)
    if viewdirs is None:
        raise ValueError("mlp_impl='cuda' queries need view directions")
    return fused_nerf_vjp.fused_nerf_train_apply(
        model, model.cfg, pts, viewdirs[:, None, :], pipeline.multires, pipeline.multires_views,
        input_grads=input_grads,
    )


class HierarchicalResult(NamedTuple):
    """Coarse + fine sampling outputs (reference sample_as_in_NeRF returns)."""

    coarse: RenderOutputs
    coarse_z_vals: torch.Tensor  # [N, Nc]
    fine: RenderOutputs  # == coarse when N_importance == 0
    fine_z_vals: torch.Tensor  # [N, Nc+Nf]
    fine_pts: torch.Tensor  # [N, Nc+Nf, 3]
    fine_raw: torch.Tensor  # [N, Nc+Nf, 4]


def sample_as_in_nerf(
    pipeline: Pipeline,
    params: NeRFParams,
    rays: RayBatch,
    generator: torch.Generator | None = None,
    *,
    perturb: float | None = None,
    raw_noise_std: float | None = None,
    t_rand: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> HierarchicalResult:
    """Hierarchical coarse + fine sampling (reference nerf_utils.py:497-611).

    perturb / raw_noise_std default to the pipeline's values. The draws come
    from ``generator`` or are injected: ``t_rand`` [N, Nc] (stratified
    jitter) and ``u`` [N, Nf] (the inverse-CDF uniforms). ``rows`` is a
    rank's window of the global draws (core/sampling.py).
    """
    perturb = pipeline.perturb if perturb is None else perturb
    raw_noise_std = pipeline.raw_noise_std if raw_noise_std is None else raw_noise_std
    z_vals = stratified_z_vals(
        rays.near, rays.far, pipeline.N_samples, generator=generator,
        perturb=perturb, lindisp=pipeline.lindisp, t_rand=t_rand, rows=rows,
    )
    pts = z_to_points(rays.rays_o, rays.rays_d, z_vals)
    # the hierarchical losses never differentiate through the sample points
    # (z is detached, the rays are data): K5 drops its dL/dx chain
    raw = query_nerf(pipeline, params.coarse, pts, rays.viewdirs, input_grads=False)
    coarse = raw2outputs(raw, z_vals, rays.rays_d, raw_noise_std, pipeline.white_bkgd,
                         generator=generator, rows=rows)
    if pipeline.N_importance <= 0:
        return HierarchicalResult(coarse, z_vals, coarse, z_vals, pts, raw)
    z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(
        z_mids, coarse.weights[..., 1:-1], pipeline.N_importance,
        generator=generator, det=(perturb == 0.0), u=u, rows=rows,
    ).detach()  # reference detaches (Trainer.py:572)
    # stable: ties keep coarse samples first, as jnp.sort does
    fine_z = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1, stable=True).values
    fine_pts = z_to_points(rays.rays_o, rays.rays_d, fine_z)
    fine_model = params.fine if params.fine is not None else params.coarse
    fine_raw = query_nerf(pipeline, fine_model, fine_pts, rays.viewdirs, input_grads=False)
    fine = raw2outputs(fine_raw, fine_z, rays.rays_d, raw_noise_std, pipeline.white_bkgd,
                       generator=generator, rows=rows)
    return HierarchicalResult(coarse, z_vals, fine, fine_z, fine_pts, fine_raw)


def _argmax_depth(
    fine: RenderOutputs, fine_z: torch.Tensor, rays: RayBatch
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max_z [N, 1], max_pts [N, 1, 3], max_weights [N, 1]) at the first
    maximum weight in sorted order (reference nerf_utils.py:689-691)."""
    top = torch.argmax(fine.weights, dim=1, keepdim=True)
    max_z = torch.gather(fine_z, 1, top)
    max_w = torch.gather(fine.weights, 1, top)
    return max_z, z_to_points(rays.rays_o, rays.rays_d, max_z), max_w


def query_fine_or_coarse(
    pipeline: Pipeline, params: NeRFParams, pts: torch.Tensor, rays: RayBatch
) -> torch.Tensor:
    """NeRF query preferring the fine network (reference nerf_utils.py:696-699),
    in plain fp32 autograd whatever ``mlp_impl`` says (the JAX
    ``force_xla=True``): its gradient w.r.t. the points trains the DepthNet."""
    model = params.fine if params.fine is not None else params.coarse
    return _query_plain(pipeline, model, pts, rays.viewdirs)


def render_rays_train(
    pipeline: Pipeline,
    params: NeRFParams,
    rays: RayBatch,
    generator: torch.Generator | None = None,
    *,
    t_rand: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> dict[str, torch.Tensor]:
    """Train-time renderer (reference render_rays, nerf_utils.py:614-733).

    Full hierarchical NeRF -> argmax-weight depth target -> DepthNet predicts
    one depth -> NeRF queried at that single point -> composited maps. The
    hierarchical pass carries no gradient; the depth point's query does.
    """
    with torch.no_grad():
        hier = sample_as_in_nerf(pipeline, params, rays, generator, t_rand=t_rand, u=u, rows=rows)
        max_z, max_pts, _ = _argmax_depth(hier.fine, hier.fine_z_vals, rays)
    depth_z = params.depth(rays.rays_o, rays.rays_d)
    depth_pts = z_to_points(rays.rays_o, rays.rays_d, depth_z)
    depth_raw = query_fine_or_coarse(pipeline, params, depth_pts, rays)
    out = raw2outputs(depth_raw, depth_z, rays.rays_d, pipeline.raw_noise_std,
                      pipeline.white_bkgd, generator=generator, rows=rows)
    return {
        "depth_net_rgb_map": out.rgb_map,
        "depth_net_disp_map": out.disp_map,
        "depth_net_z_vals": depth_z,
        "max_z_vals": max_z,
        "depth_net_pts": depth_pts,
        "max_pts": max_pts,
        "raw": depth_raw,
        "acc_map": hier.fine.acc_map,
    }


def render_rays_joint(
    pipeline: Pipeline,
    params: NeRFParams,
    rays: RayBatch,
    generator: torch.Generator | None = None,
    *,
    t_rand: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> dict[str, torch.Tensor]:
    """Joint renderer: one hierarchical pass feeding both objectives (the
    vanilla NeRF maps, fine rgb and coarse rgb0, and the DepthNet's maps
    and argmax target from the same pass)."""
    hier = sample_as_in_nerf(pipeline, params, rays, generator, t_rand=t_rand, u=u, rows=rows)
    max_z, _, _ = _argmax_depth(hier.fine, hier.fine_z_vals, rays)
    depth_z = params.depth(rays.rays_o, rays.rays_d)
    depth_pts = z_to_points(rays.rays_o, rays.rays_d, depth_z)
    depth_raw = query_fine_or_coarse(pipeline, params, depth_pts, rays)
    out = raw2outputs(depth_raw, depth_z, rays.rays_d, pipeline.raw_noise_std,
                      pipeline.white_bkgd, generator=generator, rows=rows)
    return {
        "rgb_map": hier.fine.rgb_map,
        "rgb0": hier.coarse.rgb_map,
        "depth_net_rgb_map": out.rgb_map,
        "depth_net_z_vals": depth_z,
        "max_z_vals": max_z.detach(),
        "acc_map": hier.fine.acc_map,
    }


def render_rays_vanilla(
    pipeline: Pipeline,
    params: NeRFParams,
    rays: RayBatch,
    generator: torch.Generator | None = None,
    *,
    t_rand: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> dict[str, torch.Tensor]:
    """The vanilla hierarchical NeRF train renderer (no DepthNet): fine
    maps and the coarse ones (rgb0, disp0, acc0)."""
    hier = sample_as_in_nerf(pipeline, params, rays, generator, t_rand=t_rand, u=u, rows=rows)
    return {
        "rgb_map": hier.fine.rgb_map,
        "disp_map": hier.fine.disp_map,
        "acc_map": hier.fine.acc_map,
        "rgb0": hier.coarse.rgb_map,
        "disp0": hier.coarse.disp_map,
        "acc0": hier.coarse.acc_map,
    }


def render_rays_eval(
    pipeline: Pipeline,
    params: NeRFParams,
    rays: RayBatch,
    mode: EvalMode = EvalMode.DEPTH_NET,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Test-time render of one ray batch, 4 modes (reference
    render_rays_test, nerf_utils.py:736-876; JAX ``render_rays_eval``), at
    perturb 0 and no raw noise: the plain path, and the composable route of
    "cuda" under NDC (K1 for the depth mean from ``params.kernels.depth``,
    K4 for every NeRF query)."""
    ret: dict[str, torch.Tensor] = {}
    if mode in (EvalMode.COMPARE_NERF, EvalMode.NERF_MAX, EvalMode.FULL_NERF):
        hier = sample_as_in_nerf(pipeline, params, rays, generator, perturb=0.0, raw_noise_std=0.0)
        max_z, max_pts, max_w = _argmax_depth(hier.fine, hier.fine_z_vals, rays)
        ret.update(max_z_vals=max_z, max_pts=max_pts, max_weights=max_w)
    if mode == EvalMode.NERF_MAX:
        # render from the argmax sample only (reference :824-829); disp is
        # the reference's zeros shaped like rgb
        rgb = torch.sigmoid(hier.fine_raw[..., :3])
        top = torch.argmax(hier.fine.weights, dim=1, keepdim=True)
        max_rgb = torch.gather(rgb, 1, top[..., None].expand(-1, 1, 3))[:, 0]
        ret.update(depth_net_rgb_map=max_rgb, depth_net_disp_map=torch.zeros_like(max_rgb),
                   depth_net_weights=max_w, depth_net_pts=max_pts, depth_net_z_vals=max_z)
        return ret
    if mode == EvalMode.FULL_NERF:
        ret.update(depth_net_rgb_map=hier.fine.rgb_map, depth_net_disp_map=hier.fine.disp_map,
                   depth_net_weights=hier.fine.weights, depth_net_pts=hier.fine_pts,
                   depth_net_z_vals=hier.fine_z_vals)
        return ret
    # DEPTH_NET, and the depth-net half of COMPARE_NERF (:837-865)
    if pipeline.mlp_impl in KERNEL_IMPLS:  # the composable route under NDC: K1 in bf16, as JAX (:540-552)
        depth_mean = fused_depth_net.fused_depth_net_apply(
            params.kernels.depth, params.depth.cfg, rays.rays_o, rays.rays_d, torch.bfloat16).reshape(-1, 1)
    else:
        depth_mean = params.depth(rays.rays_o, rays.rays_d)
    depth_pts, depth_z = sample_points_around_mean(
        rays.rays_o, rays.rays_d, depth_mean,
        n_samples=pipeline.n_depth_samples, mode=pipeline.sampling_mode,
        std=pipeline.distance, generator=generator,
    )
    model = params.fine if params.fine is not None else params.coarse
    depth_raw = query_nerf(pipeline, model, depth_pts, rays.viewdirs)
    out = raw2outputs(depth_raw, depth_z, rays.rays_d, 0.0, pipeline.white_bkgd)
    ret.update(depth_net_rgb_map=out.rgb_map, depth_net_disp_map=out.disp_map,
               depth_net_weights=out.weights, depth_net_pts=depth_pts, depth_net_z_vals=depth_z)
    return ret


def _mip_maps(rgb: torch.Tensor, distance: torch.Tensor, acc: torch.Tensor) -> dict[str, torch.Tensor]:
    """A mip-NeRF render's flat maps under the eval modes' names: the
    distance as depth and, for the callers that show one, 1 / distance as
    disparity."""
    return {"depth_net_rgb_map": rgb, "depth_net_disp_map": 1.0 / torch.clamp(distance, min=1e-10),
            "depth_net_weights": acc, "depth_net_z_vals": distance,
            "depth_net_pts": rgb.new_zeros((rgb.shape[0], 0, 3))}


def _check_mip(pipeline: Pipeline, mode: EvalMode, full_outputs: bool = False) -> None:
    if mode != EvalMode.FULL_NERF:
        raise ValueError(f"a mip-NeRF pipeline renders FULL_NERF (its last level), not {mode.name}")
    if full_outputs:
        raise ValueError("a mip-NeRF render has no per-sample outputs to export")


def render_rays_mip(pipeline: Pipeline, model: MipNeRF, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    radii: torch.Tensor) -> dict[str, torch.Tensor]:
    """mip-NeRF at test time over rays [N, 3] with radii [N, 1] in plain
    PyTorch: ``models.mipnerf.render_levels`` querying the module over each
    interval's IPE and the ray's view encoding; the last level's maps
    (``_mip_maps``)."""
    cfg = model.cfg
    view = mip_pos_enc(rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True), cfg.deg_view)

    def query(mean, cov, last):
        enc = integrated_pos_enc(mean, cov, cfg.min_deg_point, cfg.max_deg_point)
        raw_rgb, raw_density = model(enc, view[:, None, :].expand(*enc.shape[:2], view.shape[-1]))
        return raw_rgb, raw_density[..., 0]

    return _mip_maps(*render_levels(cfg, rays_o, rays_d, radii, pipeline.near, pipeline.far, pipeline.white_bkgd,
                                    query))


def _mip_fast_path(pipeline: Pipeline, params: NeRFParams, rays_o: torch.Tensor, rays_d: torch.Tensor,
                   radii: torch.Tensor) -> dict[str, torch.Tensor]:
    """mip-NeRF on K11: one launch over all rays; the recorder's
    ``nst.render.mip`` span around it."""
    k = params.kernels
    if k is None or k.mip is None:
        params = pack_kernel_weights(params)
    with profiling.span("nst.render.mip"):
        maps = fused_mip.render_mip_kernel(
            params.kernels.mip, params.coarse.cfg, rays_o.reshape(-1, 3).contiguous(),
            rays_d.reshape(-1, 3).contiguous(), radii.reshape(-1).contiguous(), near=pipeline.near,
            far=pipeline.far, white_bkgd=pipeline.white_bkgd)
    return _mip_maps(maps["rgb_map"], maps["depth_map"], maps["acc_map"])


def check_eval_envelope(p: Pipeline, mode: EvalMode) -> None:
    """What the kernel path of ``mode`` takes of a "cuda" pipeline; raises
    ValueError naming the envelope where the JAX package drops to its
    composable path (nerf_sampling_tpu/render/engine.py:631-650). Under NDC
    the route is the composable one on K1 and K4, which takes every mode but
    COMPARE_NERF, and no int8."""
    check_kernel_queries(p)
    if p.ndc:
        if mode == EvalMode.COMPARE_NERF:
            raise ValueError("mlp_impl='cuda' renders COMPARE_NERF through its fp32 kernels (K7, K1, K9), which "
                             "take no NDC rays; the NDC route (K1 and K4) serves DEPTH_NET, FULL_NERF and NERF_MAX")
        if p.mlp_impl == CUDA_INT8:
            raise ValueError("mlp_impl='cuda_int8' has no NDC route: under NDC the renders run K1 and K4 in bf16 "
                             "(mlp_impl='cuda')")
        return
    S_max = fused_render.MAX_SAMPLES
    if mode in (EvalMode.COMPARE_NERF, EvalMode.NERF_MAX) and p.N_importance <= 0:
        raise ValueError(f"mlp_impl='cuda' renders {mode.name} through K7's argmax, which needs "
                         "N_importance > 0")
    if mode != EvalMode.DEPTH_NET and p.N_importance > 0 and not (
            4 <= p.N_samples and p.N_samples + p.N_importance <= S_max):
        raise ValueError(f"mlp_impl='cuda' runs the hierarchical pass (K7) with N_samples >= 4 and "
                         f"N_samples + N_importance <= {S_max}; got {p.N_samples} + {p.N_importance}")
    if mode == EvalMode.FULL_NERF and p.N_importance <= 0 and not 2 <= p.N_samples <= S_max:
        raise ValueError(f"mlp_impl='cuda' renders FULL_NERF without fine samples (K8) with "
                         f"2..{S_max} samples; got {p.N_samples}")
    if mode in (EvalMode.DEPTH_NET, EvalMode.COMPARE_NERF) and (
            p.sampling_mode not in ("uniform", "gaussian") or not 1 < p.n_depth_samples <= S_max):
        raise ValueError(
            "mlp_impl='cuda' renders the uniform or gaussian population with 2.."
            f"{S_max} samples; got {p.sampling_mode}/{p.n_depth_samples}"
        )


def _fused_fast_paths(
    pipeline: Pipeline,
    params: NeRFParams,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mode: EvalMode,
    generator: torch.Generator | None = None,
    ray_base: int = 0,
    radii: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """The four eval modes on the kernels, routed as the JAX package routes
    them (nerf_sampling_tpu/render/engine.py:607-814); flat [N, ...]
    map-level outputs. The gaussian population (K3's seed, COMPARE's
    draws) comes from ``generator``; K3 keys its draws by the global ray
    index, ``ray_base`` being that of ``rays_o[0]``. Packs the ``mode`` reads that
    ``params`` lacks are made for this call. Under "cuda_int8" the NeRF
    passes of every mode but COMPARE_NERF run the int8 kernels. A mip-NeRF
    pipeline renders FULL_NERF on K11, over rays with ``radii``."""
    p = pipeline
    if is_mip(p):  # render_flat_rays checked the mode and the radii
        return _mip_fast_path(p, params, rays_o, rays_d, radii)
    check_eval_envelope(p, mode)
    int8 = p.mlp_impl == CUDA_INT8 and mode != EvalMode.COMPARE_NERF
    population = mode in (EvalMode.DEPTH_NET, EvalMode.COMPARE_NERF)
    if population and p.sampling_mode == "gaussian" and generator is None:
        raise ValueError("the gaussian population requires a torch.Generator")
    ro, rd = rays_o.reshape(-1, 3).contiguous(), rays_d.reshape(-1, 3).contiguous()
    n = ro.shape[0]
    need = eval_packs(p, mode, params)
    k = params.kernels
    if k is None or (need["with_hier"] and k.hier is None) or (need["with_coarse"] and k.coarse is None) \
            or (need["with_fp32"] and k.fp32 is None) or (not need["with_fp32"] and quant.is_int8(k.nerf) != int8):
        params = pack_kernel_weights(params, **need)
    model = params.fine if params.fine is not None else params.coarse
    common = dict(white_bkgd=p.white_bkgd, multires=p.multires, multires_views=p.multires_views)
    # COMPARE is the parity-diagnostic mode: its kernels run fp32 (JAX :657-661)
    dtype, packs = (torch.float32, params.kernels.fp32) if mode == EvalMode.COMPARE_NERF \
        else (torch.bfloat16, params.kernels)

    def map_outputs(maps, z=None):
        return {
            "depth_net_rgb_map": maps["rgb_map"],
            "depth_net_disp_map": maps["disp_map"],
            "depth_net_weights": maps["acc_map"],
            "depth_net_z_vals": maps["depth_map"] if z is None else z,
            "depth_net_pts": ro.new_zeros((n, 0, 3)),
        }

    diag: dict[str, torch.Tensor] = {}
    if mode != EvalMode.DEPTH_NET and p.N_importance > 0:
        hmaps = fused_hier.fused_render_hier(
            packs.hier, params.coarse.cfg, model.cfg, ro, rd, seed=None, n_coarse=p.N_samples,
            n_importance=p.N_importance, near=p.near, far=p.far, lindisp=p.lindisp, dtype=dtype, **common,
        )
        if mode == EvalMode.FULL_NERF:
            return map_outputs(hmaps)
        max_z = hmaps["max_z"].reshape(-1, 1)
        diag = {"max_z_vals": max_z, "max_pts": z_to_points(ro, rd, max_z),
                "max_weights": hmaps["max_w"].reshape(-1, 1)}
        if mode == EvalMode.NERF_MAX:
            max_rgb = hmaps["max_rgb"]
            return {**diag, "depth_net_rgb_map": max_rgb, "depth_net_disp_map": torch.zeros_like(max_rgb),
                    "depth_net_weights": diag["max_weights"], "depth_net_pts": diag["max_pts"],
                    "depth_net_z_vals": max_z}
    elif mode == EvalMode.FULL_NERF:
        return map_outputs(fused_render.fused_render(
            packs.coarse, params.coarse.cfg, ro, rd, n_samples=p.N_samples, near=p.near,
            far=p.far, lindisp=p.lindisp, **common))

    # DEPTH_NET populate-and-shade, and the depth-net half of COMPARE
    depth = fused_depth_net.fused_depth_net_apply(packs.depth, params.depth.cfg, ro, rd, dtype)
    pop = dict(n_samples=p.n_depth_samples, std=p.distance, **common)
    if mode == EvalMode.COMPARE_NERF:
        # the diagnostic keeps the exact [N, S] z values: drawn here, shaded by K9
        _, z_vals = sample_points_around_mean(
            ro, rd, depth.reshape(-1, 1), n_samples=p.n_depth_samples, mode=p.sampling_mode,
            std=p.distance, generator=generator)
        maps = fused_render.fused_shade(packs.nerf, model.cfg, ro, rd, z_vals.contiguous(),
                                        dtype=dtype, **common)
        return {**diag, **map_outputs(maps, z_vals)}
    if p.sampling_mode == "uniform":
        maps = fused_render.fused_render_around_depth(packs.nerf, model.cfg, ro, rd, depth, **pop)
    else:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device))
        maps = fused_render.fused_render_gaussian(packs.nerf, model.cfg, ro, rd, depth, seed=seed,
                                                   ray_base=ray_base, **pop)
    return map_outputs(maps)


@torch.no_grad()
def render_flat_rays(
    pipeline: Pipeline,
    params: NeRFParams,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    mode: EvalMode = EvalMode.DEPTH_NET,
    chunk: int = 1024 * 32,
    generator: torch.Generator | None = None,
    full_outputs: bool = False,
    H: int | None = None,
    W: int | None = None,
    focal: float | None = None,
    ray_base: int = 0,
    radii: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Render flat [N, 3] rays -> dict of flat [N, ...] maps.

    ``mlp_impl="cuda"`` (and "cuda_int8") takes the kernels over all rays at once, with
    map-level outputs; ``"plain"`` renders ``chunk`` rays at a time, with
    per-sample ones, and so does "cuda" under NDC, on K1 and K4 (the
    composable route; H, W and focal are the reprojection's). ``full_outputs``
    is the caller's request for the per-sample points and weights (the
    scene-data export): it renders on the plain path whatever ``mlp_impl``
    says, as the JAX package's composable path does. ``ray_base`` is the
    global index of the first ray, which keys K3's draws (a rank's rows of
    an image: parallel/render.py); the plain path draws from ``generator``.
    A mip-NeRF pipeline takes each ray's base radius, ``radii`` [N] or [N,
    1]: K11 over all rays, or ``render_rays_mip`` over chunks.
    """
    if is_mip(pipeline):
        _check_mip(pipeline, mode, full_outputs)
        if radii is None:
            raise ValueError("a mip-NeRF render needs each ray's radius (render_image makes them)")
        if pipeline.mlp_impl == CUDA:
            return _fused_fast_paths(pipeline, params, rays_o, rays_d, mode, generator, ray_base, radii)
        ro, rd, rr = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), radii.reshape(-1, 1)
        pieces: dict[str, list[torch.Tensor]] = {}
        with matmul_precision(pipeline.matmul_precision):
            for s in range(0, ro.shape[0], chunk):
                got = render_rays_mip(pipeline, params.coarse, ro[s:s + chunk], rd[s:s + chunk], rr[s:s + chunk])
                for name, v in got.items():
                    pieces.setdefault(name, []).append(v)
        return {name: torch.cat(v, 0) for name, v in pieces.items()}
    if full_outputs:
        pipeline = dataclasses.replace(pipeline, mlp_impl=PLAIN)
    if pipeline.mlp_impl in KERNEL_IMPLS:
        if not pipeline.ndc:
            return _fused_fast_paths(pipeline, params, rays_o, rays_d, mode, generator, ray_base)
        check_eval_envelope(pipeline, mode)
        if mode == EvalMode.DEPTH_NET and (params.kernels is None or params.kernels.depth is None):
            params = pack_kernel_weights(params, **eval_packs(pipeline, mode))
    rays = make_ray_batch(pipeline, rays_o, rays_d, H=H, W=W, focal=focal)
    n = rays.rays_o.shape[0]
    pieces: dict[str, list[torch.Tensor]] = {}
    with matmul_precision(pipeline.matmul_precision):
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
    full_outputs: bool = False,
) -> dict[str, torch.Tensor]:
    """Render a full image on ``device``: rays -> render_flat_rays -> [H, W, ...] maps
    (an NDC reprojection takes H, W and K's focal; mip-NeRF's rays go
    through pixel centres, with radii); the recorder's ``nst.render.image``
    span."""
    with profiling.span("nst.render.image"):
        radii = None
        if is_mip(pipeline):
            rays_o, rays_d, radii = get_rays_mip(H, W, K, c2w, device)
            radii = radii.reshape(-1)
        else:
            rays_o, rays_d = get_rays(H, W, K, c2w, device)
        flat = render_flat_rays(
            pipeline, params, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
            mode=mode, chunk=chunk, generator=generator, full_outputs=full_outputs,
            H=H, W=W, focal=float(K[0][0]), radii=radii,
        )
        return {name: v.reshape(H, W, *v.shape[1:]) for name, v in flat.items()}
