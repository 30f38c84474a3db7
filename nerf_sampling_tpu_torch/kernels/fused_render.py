"""K2: DepthNet populate-and-shade as a hand-written CUDA kernel, with its plain version.

Replaces nerf_sampling_tpu/kernels/fused_render.py::_call with
z_source="around_center" (``fused_render_around_depth``). The kernel source
is ``csrc/render_around_depth.cu``. For every ray it shades the uniform
population z = clip(depth + offsets, near, far) with the NeRF MLP and
composites the samples in order over a white background.

``pack_nerf`` lays the NeRF's weights out as [in, out] matrices over one
positional-encoding row of 96 columns: the 63 point-embedding columns
(padded to 64) and the 27 view-embedding columns (padded to 32), so each
concatenation of the reference is one more zero-padded operand of the same
sum. ``render_around_depth_plain`` computes the same thing in plain PyTorch:
fp32 is the reference, bf16 rounds where the kernel rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_sampling_tpu_torch.core.compositing import raw2outputs
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.utils.precision import strict_fp32

MAX_SAMPLES = 512
PTS_ROWS, VIEW_ROWS = 64, 32  # padded embedding widths of the kernel's PE row
KERNEL_WIDTH = 256  # NeRF width the CUDA kernel is built for

launches = 0  # kernel launches since the last reset (see chip_smoke.py)


def uniform_population_offsets(n_samples: int, std: float) -> np.ndarray:
    """sorted(linspace(-std, std, n-1) U {0}) as float32 [n] (reference
    sample_points_around_mean "uniform", before the [2, 6] clip)."""
    if n_samples < 2:
        return np.zeros((1,), np.float32)
    grid = np.linspace(-std, std, n_samples - 1)
    return np.sort(np.concatenate([grid, [0.0]])).astype(np.float32)


def pack_nerf(model: NeRF, dtype=torch.bfloat16) -> dict:
    """Repack a viewdirs NeRF's weights as [in, out] matrices for the kernel."""
    cfg = model.cfg
    if not cfg.use_viewdirs:
        raise ValueError("the fused render needs use_viewdirs=True")
    Cp, Cv, W = cfg.input_ch, cfg.input_ch_views, cfg.W
    if Cp > PTS_ROWS or Cv > VIEW_ROWS:
        raise ValueError("embedding widths exceed the kernel's PE row")

    def T(lin) -> torch.Tensor:
        return lin.weight.detach().float().T

    def b(lin) -> torch.Tensor:
        return lin.bias.detach().float().contiguous()

    def cast(w: torch.Tensor) -> torch.Tensor:
        return w.to(dtype).contiguous()

    def pad(w: torch.Tensor, rows: int) -> torch.Tensor:
        out = torch.zeros((rows, w.shape[1]), device=w.device)
        out[: w.shape[0]] = w
        return cast(out)

    pts = model.pts_linears
    trunk_w, skip_w = [], {}
    for i in range(1, cfg.D):
        w = T(pts[i])
        if (i - 1) in cfg.skips:  # cat([input_pts, h]) @ W
            skip_w[i] = pad(w[:Cp], PTS_ROWS)
            w = w[Cp:]
        trunk_w.append(cast(w))
    vw = T(model.views_linears[0])  # rows [feature(W) | views emb(Cv)]
    return {
        "w0": pad(T(pts[0]), PTS_ROWS),
        "trunk_w": trunk_w,  # layers 1..D-1
        "trunk_b": [b(lin) for lin in pts],
        "skip_w": skip_w,
        "feature_w": cast(T(model.feature_linear)),
        "feature_b": b(model.feature_linear),
        "alpha_w": cast(T(model.alpha_linear)[:, 0]),
        "alpha_b": b(model.alpha_linear),
        "views_wf": cast(vw[:W]),
        "views_ws": pad(vw[W:], VIEW_ROWS),
        "views_b": b(model.views_linears[0]),
        "rgb_w": cast(model.rgb_linear.weight.detach().float()),  # [3, W/2]
        "rgb_b": b(model.rgb_linear),
    }


def render_around_depth_plain(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    offsets: torch.Tensor,
    *,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """The kernel's computation in plain PyTorch -> rgb/disp/acc/depth maps."""
    strict_fp32()
    f32 = torch.float32
    Cp, Cv = cfg.input_ch, cfg.input_ch_views

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(f32)

    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(f32)

    n, S = rays_o.shape[0], offsets.shape[0]
    z = torch.clamp(depth.reshape(n, 1) + offsets[None, :], near, far)  # keeps NaN
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    x_pts = rnd(positional_encoding(pts, multires)).reshape(n * S, Cp)
    x_v = rnd(positional_encoding(vd, multires_views))[:, None, :].expand(n, S, Cv).reshape(n * S, Cv)

    h = rnd(torch.relu(mm(x_pts, packed["w0"][:Cp]) + packed["trunk_b"][0]))
    for i in range(1, cfg.D):
        zi = mm(h, packed["trunk_w"][i - 1])
        if i in packed["skip_w"]:
            zi = zi + mm(x_pts, packed["skip_w"][i][:Cp])
        h = rnd(torch.relu(zi + packed["trunk_b"][i]))
    sigma = mm(h, packed["alpha_w"][:, None]) + packed["alpha_b"]
    feature = rnd(mm(h, packed["feature_w"]) + packed["feature_b"])
    hv = rnd(torch.relu(
        mm(feature, packed["views_wf"]) + mm(x_v, packed["views_ws"][:Cv]) + packed["views_b"]
    ))
    rgb_logits = mm(hv, packed["rgb_w"].T) + packed["rgb_b"]
    raw = torch.cat([rgb_logits, sigma], -1).reshape(n, S, 4)
    out = raw2outputs(raw, z, rays_d, 0.0, white_bkgd)
    return {"rgb_map": out.rgb_map, "disp_map": out.disp_map,
            "acc_map": out.acc_map, "depth_map": out.depth_map}


def _flat_weights(packed: dict) -> list[torch.Tensor]:
    """Weights in the order nst_render_around_depth reads them, after checking
    that they are the kernel's layout: bf16 matrices and fp32 biases."""
    bf16, f32 = torch.bfloat16, torch.float32
    flat = [(packed["w0"], bf16)] + [(w, bf16) for w in packed["trunk_w"]]
    flat += [(b, f32) for b in packed["trunk_b"]]
    flat += [(packed["skip_w"][i], bf16) for i in sorted(packed["skip_w"])]
    flat += [(packed[k], f32 if k.endswith("_b") else bf16)
             for k in ("feature_w", "feature_b", "alpha_w", "alpha_b",
                       "views_wf", "views_ws", "views_b", "rgb_w", "rgb_b")]
    for w, dtype in flat:
        if w.dtype != dtype:
            raise TypeError("packed weights must be pack_nerf(model, torch.bfloat16): "
                            f"bf16 matrices and fp32 biases, got a {w.dtype} {dtype} slot")
    return [w for w, _ in flat]


def render_around_depth_kernel(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    offsets: torch.Tensor,
    *,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
) -> dict[str, torch.Tensor]:
    """Maps of N rays [N, 3] around depth [N] at the std-scaled offsets [S].

    On a CPU tensor this runs ``render_around_depth_plain`` at bf16; on a
    CUDA tensor it launches the kernel, or raises on what it does not take.
    """
    global launches
    n, S = rays_o.shape[0], offsets.shape[0]
    for name, t, shape in (("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)),
                           ("depth", depth, (n,)), ("offsets", offsets, (S,))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != rays_o.device:
            raise ValueError("all inputs must be on one device")
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"n_samples must be in [1, {MAX_SAMPLES}], got {S}")
    weights = _flat_weights(packed)
    kw = dict(near=near, far=far, white_bkgd=white_bkgd, multires=multires,
              multires_views=multires_views)
    if rays_o.device.type == "cpu":
        return render_around_depth_plain(packed, cfg, rays_o, rays_d, depth, offsets,
                                         dtype=torch.bfloat16, **kw)
    if rays_o.device.type != "cuda":
        raise ValueError(f"unsupported device {rays_o.device}")
    if not all(t.is_contiguous() for t in (rays_o, rays_d, depth, offsets)):
        raise ValueError("inputs must be contiguous")
    if (cfg.W, cfg.input_ch, cfg.input_ch_views, multires, multires_views) != (
        KERNEL_WIDTH, 63, 27, 10, 4
    ):
        raise ValueError("the CUDA kernel is built for W=256, multires 10 and multires_views 4")
    if cfg.D > 16 or any(not 0 <= s < cfg.D - 1 for s in cfg.skips):
        raise ValueError("the CUDA kernel takes D <= 16 and skips inside the trunk")
    for w in weights:
        if w.device != rays_o.device or not w.is_contiguous():
            raise ValueError("packed weights must be contiguous and on the rays' device")
    skip_mask = sum(1 << i for i in packed["skip_w"])
    lib = build.load_library()
    out = torch.empty((6, n), dtype=torch.float32, device=rays_o.device)
    arr, count = build.pointer_array([rays_o, rays_d, depth, offsets, out] + weights)
    rc = lib.nst_render_around_depth(
        arr, count, n, S, cfg.D, skip_mask, float(near), float(far), int(bool(white_bkgd)),
        build.current_stream(rays_o.device),
    )
    build.check(rc, "render_around_depth_kernel")
    launches += 1
    return {"rgb_map": out[0:3].T, "disp_map": out[3], "acc_map": out[4], "depth_map": out[5]}


def fused_render_around_depth(
    packed: dict,
    cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    depth: torch.Tensor,
    *,
    n_samples: int = 64,
    std: float = 0.5,
    clip_near: float = 2.0,
    clip_far: float = 6.0,
    white_bkgd: bool = True,
    multires: int = 10,
    multires_views: int = 4,
) -> dict[str, torch.Tensor]:
    """Uniform populate-and-shade of [N, 3] rays around depth [N] through K2;
    ``packed`` is ``pack_nerf(model, torch.bfloat16)``, made once per set of weights."""
    offsets = torch.from_numpy(uniform_population_offsets(n_samples, std)).to(rays_o.device)
    return render_around_depth_kernel(
        packed, cfg, rays_o, rays_d, depth.reshape(-1), offsets,
        near=clip_near, far=clip_far, white_bkgd=white_bkgd,
        multires=multires, multires_views=multires_views,
    )
