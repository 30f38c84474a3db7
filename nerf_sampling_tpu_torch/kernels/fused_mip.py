"""K11: mip-NeRF's two-level render as one hand-written CUDA kernel, with its plain version.

The kernel source is ``csrc/render_mip.cu``, on the wgmma core
(``csrc/mlp_wgmma.cuh``) as K7 is. One launch renders every ray of a call,
deterministically (mip-NeRF at test time, ``google/mipnerf``
``internal/models.py``). Per ray, with S intervals a level:

1. the first level's S + 1 t-values, near (1 - t) + far t at t =
   linspace(0, 1, S + 1);
2. for each interval, the Gaussian of its conical frustum (base radius from
   the ray), its integrated positional encoding (IPE: exp(-var/2) sin(y),
   then exp(-var/2) sin(y + pi/2), 16 scales x 3 axes, 96 columns; the
   kernel takes cos(y) for sin(y + pi/2), ``kernel_ipe``) and the MLP's
   trunk and density head (the coarse level's rgb is never read);
3. interval compositing (softplus(raw - 1) density, delta = (t1 - t0) |d|,
   transmittance exp(-cumsum)) to the weights, their blurpool and 0.01
   padding, the pdf and CDF, and S + 1 new t-values at u = linspace(0, 1 -
   eps, S + 1) (mip-NeRF's ``resample_along_rays``, not merged with the
   first level's);
4. the same MLP in full over the new intervals (the view encoding, mip-NeRF's
   ``pos_enc`` of the unit direction with its identity, 27 columns), rgb =
   sigmoid(raw) 1.002 - 0.001, and the compositing of rgb, distance and acc
   over a white background.

``pack_mip`` lays the MLP out as ``fused_render.pack_nerf`` does, over a PE
tile of 128 columns in the core's two 64-column panels: the 96 IPE columns,
then the 27 view columns, then 5 zeros. Layer 0 and the skip layer read both
panels, their rows past the IPE's 96 zero (so the view columns add nothing
there); the views layer reads the second panel alone, its first 32 rows
(IPE columns) and last 5 zero. One slice image (``fused_render.pack_slices``
of the pack) serves both levels: the first level streams its trunk and
density head, a prefix of the full forward's slices.

``render_mip_plain`` computes the same in plain PyTorch: the kernel's fill
in fp32 rounded to bf16, the MLP as ``fused_render.mlp_plain`` runs it (bf16
activations, fp32 sums), everything else fp32 (``core``'s mip-NeRF
functions, ``models.mipnerf.render_levels``). The configuration's
``disable_integration`` (mip-NeRF's own: the variances left out of the
encoding) reaches the kernel too: a different model, which the
benchmark's check must refuse.
"""

from __future__ import annotations

import torch

from nerf_sampling_tpu_torch.core.encoding import mip_pos_enc, safe_wrap
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels.fused_render import (
    KERNEL_WIDTH,
    _flat_weights,
    check_slices,
    mlp_plain,
    pack_slices,
)
from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig, render_levels
from nerf_sampling_tpu_torch.models.nerf import NeRFConfig
from nerf_sampling_tpu_torch.utils import profiling

PE_COLS = 128  # the PE tile: the IPE's 96 columns, the view encoding's 27, 5 zeros
VIEW_COL = 96  # first column of the view encoding
VIEW_PANEL = 64  # the second panel, which the views layer reads alone
MAX_INTERVALS = 512

launches = 0  # K11 launches since the last reset


def _pe_config(cfg: MipNeRFConfig) -> NeRFConfig:
    """The ``NeRFConfig`` under which ``mlp_plain`` runs a mip pack: a PE row
    of 128 columns, and the view rows from the second panel's 64."""
    return NeRFConfig(D=cfg.net_depth, W=cfg.net_width, input_ch=PE_COLS, input_ch_views=PE_COLS - VIEW_PANEL,
                      skips=tuple(i for i in range(cfg.net_depth - 1) if cfg.skip_after(i)), use_viewdirs=True)


def pack_mip(model: MipNeRF, dtype=torch.bfloat16) -> dict:
    """The MLP's weights as [in, out] matrices in ``pack_nerf``'s keys, over
    the 128-column PE row: w0 and each skip layer's input rows [128, W]
    (the IPE's 96, zeros past them), views_ws [64, Wc] (zeros, the view
    encoding's 27 rows from row 32, zeros)."""
    cfg = model.cfg
    if cfg.net_depth_condition != 1:
        raise ValueError("the kernels' views branch is one layer (net_depth_condition 1)")
    C, Cv, W = cfg.input_ch, cfg.input_ch_views, cfg.net_width
    if C > VIEW_COL or Cv > PE_COLS - VIEW_COL:
        raise ValueError("the encodings exceed the kernel's PE row (96 IPE and 32 view columns)")

    def T(lin) -> torch.Tensor:
        return lin.weight.detach().float().T

    def b(lin) -> torch.Tensor:
        return lin.bias.detach().float().contiguous()

    def rows(w: torch.Tensor, n: int, at: int = 0) -> torch.Tensor:
        out = torch.zeros((n, w.shape[1]), device=w.device)
        out[at:at + w.shape[0]] = w
        return out.to(dtype).contiguous()

    trunk_w, skip_w = [], {}
    for i in range(1, cfg.net_depth):
        w = T(model.pts_linears[i])
        if cfg.skip_after(i - 1):  # [h, inputs] @ W
            skip_w[i] = rows(w[W:], PE_COLS)
            w = w[:W]
        trunk_w.append(w.to(dtype).contiguous())
    vw = T(model.views_linears[0])  # rows [bottleneck (W) | view encoding (Cv)]
    return {
        "w0": rows(T(model.pts_linears[0]), PE_COLS),
        "trunk_w": trunk_w,
        "trunk_b": [b(lin) for lin in model.pts_linears],
        "skip_w": skip_w,
        "feature_w": T(model.bottleneck_linear).to(dtype).contiguous(),
        "feature_b": b(model.bottleneck_linear),
        "alpha_w": T(model.density_linear)[:, 0].to(dtype).contiguous(),
        "alpha_b": b(model.density_linear),
        "views_wf": vw[:W].to(dtype).contiguous(),
        "views_ws": rows(vw[W:], PE_COLS - VIEW_PANEL, VIEW_COL - VIEW_PANEL),
        "views_b": b(model.views_linears[0]),
        "rgb_w": model.rgb_linear.weight.detach().float().to(dtype).contiguous(),  # [3, Wc]
        "rgb_b": b(model.rgb_linear),
    }


def mip_slices(packed: dict) -> torch.Tensor:
    """The pack's one slice image (its full forward, ``fused_render.pack_slices``),
    made once and kept in the pack; the first level streams its prefix."""
    slices = pack_slices(packed)
    check_slices(slices, packed)
    return slices


def kernel_ipe(mean: torch.Tensor, cov: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """The kernel's IPE in fp32: ``core.encoding.integrated_pos_enc`` with
    each cosine column cos(wrap(y)) (one sincos a scale and axis) where
    mip-NeRF takes sin(wrap(y + pi/2)), a rounding of y + pi/2 apart."""
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)], device=mean.device)
    shape = (*mean.shape[:-1], -1)
    y = safe_wrap((mean[..., None, :] * scales[:, None]).reshape(shape))
    w = torch.exp(-0.5 * (cov[..., None, :] * (scales * scales)[:, None]).reshape(shape))
    return torch.cat([w * torch.sin(y), w * torch.cos(y)], -1)


def pe_rows(cfg: MipNeRFConfig, mean: torch.Tensor, cov: torch.Tensor, rays_d: torch.Tensor,
            dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's PE rows [N * S, 128] of the intervals' Gaussians [N, S,
    3]: the IPE (``kernel_ipe``), the view encoding of d / |d|, zeros,
    rounded to ``dtype``."""
    ipe = kernel_ipe(mean, cov, cfg.min_deg_point, cfg.max_deg_point)
    n, S = ipe.shape[:2]
    vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    view = mip_pos_enc(vd, cfg.deg_view)[:, None, :].expand(n, S, cfg.input_ch_views)
    pad = ipe.new_zeros(n, S, PE_COLS - cfg.input_ch - cfg.input_ch_views)
    return torch.cat([ipe, view, pad], -1).to(dtype).float().reshape(n * S, PE_COLS)


def render_mip_plain(
    packed: dict,
    cfg: MipNeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    radii: torch.Tensor,
    *,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
) -> dict[str, torch.Tensor]:
    """K11's computation in plain PyTorch: rgb_map [N, 3], depth_map (the
    distance) [N] and acc_map [N] of rays [N, 3] with radii [N] or [N, 1]
    (``models.mipnerf.render_levels`` over the kernel's PE rows and bf16
    chain, the first level's rgb not computed)."""
    pe_cfg = _pe_config(cfg)

    def query(mean, cov, last):
        n, S = mean.shape[:2]
        x = pe_rows(cfg, mean, cov, rays_d)
        raw, _ = mlp_plain(packed, pe_cfg, x, x[:, VIEW_PANEL:], sigma_only=not last)
        if not last:
            return None, raw.reshape(n, S)
        raw = raw.reshape(n, S, 4)
        return raw[..., :3], raw[..., 3]

    rgb, distance, acc = render_levels(cfg, rays_o, rays_d, radii.reshape(-1, 1), near, far, white_bkgd, query)
    return {"rgb_map": rgb, "depth_map": distance, "acc_map": acc}


def check_mip_kernel(cfg: MipNeRFConfig) -> None:
    """What K11 takes of a mip-NeRF configuration; raises ValueError naming it."""
    if (cfg.net_width, cfg.net_width_condition, cfg.net_depth_condition) != (KERNEL_WIDTH, KERNEL_WIDTH // 2, 1):
        raise ValueError("K11 is built for net_width 256 and one condition layer of 128")
    if (cfg.min_deg_point, cfg.max_deg_point, cfg.deg_view) != (0, 16, 4):
        raise ValueError("K11 is built for the IPE's degrees 0..16 and the view encoding's 4")
    if cfg.num_levels != 2 or not 4 <= cfg.num_samples <= MAX_INTERVALS:
        raise ValueError(f"K11 renders two levels of 4..{MAX_INTERVALS} intervals")
    if cfg.net_depth > 16 or cfg.skip_after(cfg.net_depth - 1):
        raise ValueError("K11 takes net_depth <= 16 and skips inside the trunk")


def render_mip_kernel(
    packed: dict,
    cfg: MipNeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    radii: torch.Tensor,
    *,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
) -> dict[str, torch.Tensor]:
    """K11 over N rays [N, 3] with radii [N] (or [N, 1]), all in one launch;
    on CPU tensors its plain version. While the recorder is on: the
    intervals queried at each level (``nst.mip.coarse_rows``,
    ``nst.mip.fine_rows``) and the launch's device ms (``nst.mip.kernel_ms``)."""
    global launches
    n = rays_o.shape[0]
    radii = radii.reshape(-1)
    for name, t, shape in (("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)), ("radii", radii, (n,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != rays_o.device:
            raise ValueError(f"{name} must be fp32 {shape} on the rays' device")
    if rays_o.device.type == "cpu":
        return render_mip_plain(packed, cfg, rays_o, rays_d, radii, near=near, far=far, white_bkgd=white_bkgd)
    check_mip_kernel(cfg)
    weights = _flat_weights(packed)
    inputs = [rays_o.contiguous(), rays_d.contiguous(), radii.contiguous()]
    if any(w.device != rays_o.device for w in weights):
        raise ValueError("packed weights must be on the rays' device")
    slices = mip_slices(packed)
    out = torch.empty((5, n), dtype=torch.float32, device=rays_o.device)
    arr, count = build.pointer_array(inputs + [out] + weights + [slices])
    lib = build.load_library()
    S = cfg.num_samples
    with profiling.device_ms("nst.mip.kernel_ms", rays_o.device):
        rc = lib.nst_render_mip(
            arr, count, n, S, cfg.net_depth, sum(1 << i for i in packed["skip_w"]), float(near), float(far),
            int(bool(white_bkgd)), int(not cfg.disable_integration), float(cfg.density_bias), 1 + 2 * cfg.rgb_padding,
            float(cfg.rgb_padding), float(cfg.resample_padding), build.current_stream(rays_o.device))
    build.check(rc, "render_mip_kernel")
    launches += 1
    profiling.count("nst.mip.coarse_rows", n * S)
    profiling.count("nst.mip.fine_rows", n * S)
    return {"rgb_map": out[0:3].T, "depth_map": out[3], "acc_map": out[4]}


def kernel_occupancy(n_intervals: int = 128) -> dict[str, int]:
    """K11's launch shape at S intervals a level: resident blocks per SM, rays
    per block, threads per block, dynamic shared memory, the card's SMs."""
    return build.occupancy("nst_render_mip_occupancy", n_intervals)
