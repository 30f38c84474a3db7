"""K5: the recompute backward of K4 as a hand-written CUDA kernel, and the differentiable NeRF query.

Replaces nerf_sampling_tpu/kernels/fused_nerf_vjp.py: ``_bwd_call`` (the
backward kernel) and ``fused_nerf_train_apply`` (the custom VJP around K4).
The kernel source is ``csrc/nerf_points_bwd.cu``. Given the cotangent g
[M, 4] of K4's raw output, it recomputes the forward from the points and
returns the weight grads in ``pack_nerf``'s layout and, with ``want_dx``,
dL/d(points, view directions) through the fp32 positional encoding:

- ReLU masks: h > 0 on the bf16 trunk activations, zv > 0 on the views
  layer's fp32 pre-activation;
- d_h of the last trunk layer = g16[:, 3] * alpha_w + d_feature16 @ feature_w^T;
- bias grads: column sums of the fp32 d_z and g; matrix grads:
  activations^T @ d_z16 with fp32 sums, rounded to bf16 (the packed dtype,
  as the JAX package's grads are).

The kernel's sums are deterministic (two launches give the same bits, and
``want_dx`` does not change the weight grads). Its row pass runs on the
wgmma core (``csrc/mlp_wgmma.cuh``), fills its PE tile as K4 does (and
counts, while the recorder is on, ``nst.k5.rows`` and
``nst.k5.view_rays``), and is fed the pack's forward slices (the
ones K4 ran the forward from: ``fused_render.pack_slices``) and its
backward slices (``fused_render.wgmma_slices`` of the backward part of
``wgmma_program``), made on every step since the weights change every
step. ``nerf_points_bwd_plain`` is the same
backward written out in plain PyTorch, rounding where the kernel rounds
(autograd of the bf16 forward would round elsewhere).

``fused_nerf_train_apply`` is a ``torch.autograd.Function``: K4 forward,
K5 backward, the module's live weights packed on every call and their
forward slices made once, in the forward, for both kernels; the
packed-layout grads mapped back onto the module's parameters.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels.fused_nerf import (
    count_fill,
    flat_queries,
    nerf_points_kernel,
    point_embeddings,
    rows_per_dir,
)
from nerf_sampling_tpu_torch.kernels.fused_render import (
    PTS_ROWS,
    VIEW_ROWS,
    check_cuda,
    epilogue_vectors,
    mlp_plain,
    pack_args,
    pack_nerf,
    pack_slices,
    wgmma_program,
    wgmma_slices,
)
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig

SLICE_ROWS = 4096  # rows per slice of the weight-grad GEMMs (fp32 partials per slice)
_HEAD_COLS = 16  # the g16 plane: r, g, b, sigma, then zeros


def grad_jobs(packed: dict) -> list[tuple[str, int | None, int, int]]:
    """The kernel's weight-grad products, in its order: (name, layer, K, N)
    of each [K, N] block of its flat result."""
    W = packed["feature_w"].shape[0]
    jobs = [("w0", None, PTS_ROWS, W)]
    jobs += [("trunk_w", i, W, W) for i in range(1, len(packed["trunk_b"]))]
    jobs += [("skip_w", i, PTS_ROWS, W) for i in sorted(packed["skip_w"])]
    jobs += [("feature_w", None, W, W), ("views_wf", None, W, W // 2),
             ("views_ws", None, VIEW_ROWS, W // 2), ("alpha_head", None, W, _HEAD_COLS),
             ("rgb_head", None, W // 2, _HEAD_COLS)]
    return jobs


def _pe_backward(dP: torch.Tensor, x: torch.Tensor, L: int) -> torch.Tensor:
    """dL/dx [M, 3] of the embedding [x, sin(2^f x), cos(2^f x)]_f from
    dL/d(embedding) [M, 3 + 6L], in fp32."""
    f = 2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)
    a = x[:, None, :] * f[None, :, None]  # [M, L, 3]
    ds = dP[:, 3:].reshape(-1, L, 2, 3)
    terms = f[None, :, None] * (ds[:, :, 0] * torch.cos(a) - ds[:, :, 1] * torch.sin(a))
    return dP[:, :3] + terms.sum(1)


def nerf_points_bwd_plain(
    packed: dict,
    cfg: NeRFConfig,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    g: torch.Tensor,
    *,
    want_dx: bool,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> tuple[dict, torch.Tensor | None, torch.Tensor | None]:
    """K5's computation in plain PyTorch: (weight grads in ``pack_nerf``'s
    layout, dL/dpts [M, 3], dL/dviewdirs [M / S, 3]); the input grads are
    None without ``want_dx``."""
    f32 = torch.float32
    S = rows_per_dir(pts, viewdirs)
    Cp, Cv = cfg.input_ch, cfg.input_ch_views

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(f32)

    def w32(w: torch.Tensor) -> torch.Tensor:
        return w.to(f32)

    def pad(x: torch.Tensor, rows: int) -> torch.Tensor:
        return torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))], 0)

    x_pts, x_v = point_embeddings(pts, viewdirs, multires, multires_views, dtype)
    _, acts = mlp_plain(packed, cfg, x_pts, x_v, dtype)
    h = acts.h
    g = g.to(f32)
    g16 = rnd(g)
    d: dict = {"trunk_w": [None] * (cfg.D - 1), "trunk_b": [None] * cfg.D, "skip_w": {}}
    d["rgb_b"] = g[:, :3].sum(0)
    d["alpha_b"] = g[:, 3:].sum(0)
    d["rgb_w"] = (acts.hv.T @ g16[:, :3]).T
    d["alpha_w"] = h[-1].T @ g16[:, 3]
    d_zv = torch.where(acts.zv > 0, g16[:, :3] @ w32(packed["rgb_w"]), 0.0)
    d_zv16 = rnd(d_zv)
    d["views_b"] = d_zv.sum(0)
    d["views_wf"] = acts.feature.T @ d_zv16
    d["views_ws"] = pad(x_v.T @ d_zv16, VIEW_ROWS)
    d_feature = d_zv16 @ w32(packed["views_wf"]).T
    d["feature_b"] = d_feature.sum(0)
    df16 = rnd(d_feature)
    d["feature_w"] = h[-1].T @ df16
    d_h = g16[:, 3:] * w32(packed["alpha_w"])[None, :] + df16 @ w32(packed["feature_w"]).T
    dP_pts = torch.zeros_like(x_pts) if want_dx else None
    for i in range(cfg.D - 1, -1, -1):
        d_z = torch.where(h[i] > 0, d_h, 0.0)
        d_z16 = rnd(d_z)
        d["trunk_b"][i] = d_z.sum(0)
        if i == 0:
            d["w0"] = pad(x_pts.T @ d_z16, PTS_ROWS)
            if want_dx:
                dP_pts = dP_pts + d_z16 @ w32(packed["w0"][:Cp]).T
            continue
        d["trunk_w"][i - 1] = h[i - 1].T @ d_z16
        if i in packed["skip_w"]:
            d["skip_w"][i] = pad(x_pts.T @ d_z16, PTS_ROWS)
            if want_dx:
                dP_pts = dP_pts + d_z16 @ w32(packed["skip_w"][i][:Cp]).T
        d_h = d_z16 @ w32(packed["trunk_w"][i - 1]).T
    for k in ("w0", "feature_w", "alpha_w", "views_wf", "views_ws", "rgb_w"):
        d[k] = rnd(d[k])
    d["trunk_w"] = [rnd(w) for w in d["trunk_w"]]
    d["skip_w"] = {i: rnd(w) for i, w in d["skip_w"].items()}
    if not want_dx:
        return d, None, None
    dP_v = d_zv16 @ w32(packed["views_ws"][:Cv]).T
    dirs_rows = torch.repeat_interleave(viewdirs, S, dim=0)
    dpts = _pe_backward(dP_pts, pts, (Cp - 3) // 6)
    ddirs = _pe_backward(dP_v, dirs_rows, (Cv - 3) // 6).reshape(-1, S, 3).sum(1)
    return d, dpts, ddirs


def _unflatten_grads(packed: dict, dw: torch.Tensor, db: torch.Tensor) -> dict:
    """The kernel's flat results as ``pack_nerf``'s layout."""
    D, W = len(packed["trunk_b"]), packed["feature_w"].shape[0]
    d: dict = {"trunk_w": [], "skip_w": {}}
    off = 0
    for name, layer, K, N in grad_jobs(packed):
        block = dw[off:off + K * N].view(K, N)
        off += K * N
        if name == "trunk_w":
            d["trunk_w"].append(block)
        elif name == "skip_w":
            d["skip_w"][layer] = block
        elif name == "alpha_head":
            d["alpha_w"] = block[:, 3]
        elif name == "rgb_head":
            d["rgb_w"] = block[:, :3].T
        else:
            d[name] = block
    d["trunk_b"] = list(db[: D * W].view(D, W))
    d["feature_b"] = db[D * W:(D + 1) * W]
    d["views_b"] = db[(D + 1) * W:(D + 1) * W + W // 2]
    d["rgb_b"] = db[(D + 1) * W + W // 2:(D + 1) * W + W // 2 + 3]
    d["alpha_b"] = db[(D + 1) * W + W // 2 + 3:]
    return d


def nerf_points_bwd_kernel(
    packed: dict,
    cfg: NeRFConfig,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    g: torch.Tensor,
    *,
    want_dx: bool,
    fwd_slices: torch.Tensor | None = None,
    multires: int = 10,
    multires_views: int = 4,
    events: list | None = None,
) -> tuple[dict, torch.Tensor | None, torch.Tensor | None]:
    """K5: the grads of ``nerf_points_bwd_plain`` for the cotangent g [M, 4].

    On a CPU tensor this runs ``nerf_points_bwd_plain`` at bf16; on a CUDA
    tensor it launches the kernel's three passes (the row pass, the
    weight-grad GEMMs, the reductions), or raises on what it does not take.
    ``fwd_slices`` are the pack's forward slices that K4 ran from (made here
    with ``pack_slices`` when None); the backward's are made here.
    ``events``, a list, receives four recorded CUDA events: before each
    pass and after the last (the per-pass times of chip_smoke.py).
    """
    S = rows_per_dir(pts, viewdirs)
    m = pts.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (m, 4) or g.device != pts.device:
        raise ValueError(f"g must be fp32 [{m}, 4] on the points' device")
    if pts.device.type == "cpu":
        epilogue_vectors(packed)
        return nerf_points_bwd_plain(packed, cfg, pts, viewdirs, g, want_dx=want_dx, multires=multires,
                                     multires_views=multires_views, dtype=torch.bfloat16)
    pa = pack_args(packed, cfg, slices=fwd_slices)
    program = wgmma_program(packed, backward=True, want_dx=want_dx)
    bwd_slices = wgmma_slices(program[len(wgmma_program(packed)):])
    check_cuda(cfg, multires, multires_views, (pts, viewdirs, g), [pa.slices, bwd_slices, *pa.vectors])
    dev = pts.device
    total = sum(K * N for _, _, K, N in grad_jobs(packed))
    sizes = (ctypes.c_longlong * 9)()
    build.check(build.load_library().nst_nerf_points_bwd_sizes(m, cfg.D, pa.skip_mask, total, SLICE_ROWS, sizes),
                "nst_nerf_points_bwd_sizes")
    if pa.slices.shape[0] != sizes[8] or bwd_slices.shape[0] != sizes[7 if want_dx else 6]:
        raise ValueError("the weight slices do not match the kernel's program")
    ws = torch.empty(sizes[0], dtype=torch.bfloat16, device=dev)
    bias_part = torch.empty(sizes[1], dtype=torch.float32, device=dev)
    wpart = torch.empty(sizes[2], dtype=torch.float32, device=dev)
    dw = torch.empty(total, dtype=torch.float32, device=dev)
    db = torch.empty(sizes[3], dtype=torch.float32, device=dev)
    masks = torch.empty(sizes[4], dtype=torch.int32, device=dev)
    dP = torch.empty(sizes[5], dtype=torch.float32, device=dev) if want_dx else None
    dx = torch.empty((m, 6), dtype=torch.float32, device=dev) if want_dx else None
    ptrs = [pts, viewdirs, g, dx, ws, bias_part, wpart, dw, db, masks, dP, pa.slices, bwd_slices, *pa.vectors]
    for k in range(3):  # the row pass, the weight-grad GEMMs, the reductions
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        build.launch("K5", "bf16", "nst_nerf_points_bwd", ptrs, m, S, cfg.D, pa.skip_mask, total, SLICE_ROWS, k)
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    count_fill("k5", m, S)
    d = _unflatten_grads(packed, dw, db)
    if not want_dx:
        return d, None, None
    return d, dx[:, :3], dx[:, 3:].reshape(-1, S, 3).sum(1)


def grads_to_params(model: NeRF, d: dict) -> list[torch.Tensor]:
    """Packed-layout grads -> one grad per ``model.parameters()``, in order:
    transposed, the zero-padded embedding rows dropped, the skip layer's
    cat([input_pts, h]) rows and the views layer's [feature | view emb]
    rows put back together."""
    cfg = model.cfg
    Cp, Cv = cfg.input_ch, cfg.input_ch_views
    by_name = {}
    for i in range(cfg.D):
        if i == 0:
            w = d["w0"][:Cp]
        elif i in d["skip_w"]:
            w = torch.cat([d["skip_w"][i][:Cp], d["trunk_w"][i - 1]], 0)
        else:
            w = d["trunk_w"][i - 1]
        by_name[f"pts_linears.{i}.weight"] = w.T
        by_name[f"pts_linears.{i}.bias"] = d["trunk_b"][i]
    by_name.update({
        "feature_linear.weight": d["feature_w"].T,
        "feature_linear.bias": d["feature_b"],
        "alpha_linear.weight": d["alpha_w"][None, :],
        "alpha_linear.bias": d["alpha_b"],
        "views_linears.0.weight": torch.cat([d["views_wf"], d["views_ws"][:Cv]], 0).T,
        "views_linears.0.bias": d["views_b"],
        "rgb_linear.weight": d["rgb_w"],
        "rgb_linear.bias": d["rgb_b"],
    })
    return [by_name[name].reshape(p.shape).contiguous() for name, p in model.named_parameters()]


class _FusedNeRF(torch.autograd.Function):
    """K4 forward, K5 backward (``fused_nerf_train_apply``)."""

    @staticmethod
    def forward(ctx, model, multires, multires_views, input_grads, pts, dirs, *params):
        packed = pack_nerf(model, torch.bfloat16)  # the live weights: they change every step
        slices = pack_slices(packed)  # their forward slices, once: K4 runs from them and K5 recomputes from them
        ctx.model, ctx.packed, ctx.slices = model, packed, slices
        ctx.kw = dict(multires=multires, multires_views=multires_views)
        ctx.input_grads = input_grads
        ctx.save_for_backward(pts, dirs)
        return nerf_points_kernel(packed, model.cfg, pts, dirs, slices=slices, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        pts, dirs = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[4] or ctx.needs_input_grad[5]
        want_dx = ctx.input_grads and need_dx
        d, dpts, ddirs = nerf_points_bwd_kernel(ctx.packed, ctx.model.cfg, pts, dirs, g.contiguous(),
                                                want_dx=want_dx, fwd_slices=ctx.slices, **ctx.kw)
        if need_dx and not want_dx:  # input_grads=False: zero input cotangents, as JAX
            dpts, ddirs = torch.zeros_like(pts), torch.zeros_like(dirs)
        return (None, None, None, None, dpts, ddirs, *grads_to_params(ctx.model, d))


def fused_nerf_train_apply(
    model: NeRF,
    cfg: NeRFConfig,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    multires: int = 10,
    multires_views: int = 4,
    *,
    input_grads: bool = True,
) -> torch.Tensor:
    """Differentiable raw [..., 4] of points [..., 3] through K4, with K5 as
    its backward (nerf_sampling_tpu/kernels/fused_nerf_vjp.py::fused_nerf_train_apply).

    Gradients reach every parameter of ``model`` and, when ``input_grads``,
    the points and view directions; ``input_grads=False`` drops the dL/dx
    chain from K5 and gives zero input gradients, which is right only when
    the loss does not differentiate through the inputs (the hierarchical
    train losses: z is detached, the rays are data).
    """
    if cfg != model.cfg:
        raise ValueError("cfg is not the model's config")
    p, d = flat_queries(pts, viewdirs)
    raw = _FusedNeRF.apply(model, multires, multires_views, bool(input_grads), p, d, *model.parameters())
    return raw.reshape(*pts.shape[:-1], 4)

