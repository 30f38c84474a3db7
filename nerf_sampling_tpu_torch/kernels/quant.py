"""K10: the W8A8 int8 NeRF MLP of the int8 eval and oracle kernels, with its plain version.

Replaces nerf_sampling_tpu/kernels/quant.py (``mlp_forward_affine_q``, the
int8 body that the Pallas kernels ``fused_render._call`` and
``fused_hier._call`` run when they are given a ``QuantCalib``). Here the
int8 body is a mode of the kernels' MLP core: in K2/K3/K8/K9
(``csrc/render_around_depth.cu``) and K6/K7 (``csrc/render_hier.cu``) the
wgmma core's s8 forward (``csrc/mlp_wgmma.cuh``, fed
``fused_render.wgmma_qslices``), with ``nerf_mlp.cuh``'s requants
(``quant_f32`` and ``requant_int``). This module holds what the host does
around it:

- ``calibrate_nerf_quant``: a host fp32 forward (numpy) over 512 rays x 17
  linspace z records the per-channel activation amaxes and walks the scale
  chain to the static requant constants (``QuantCalib``);
- ``qpack_nerf``: ``pack_nerf``'s layout with the h-chain matrices (trunk
  layers 1..D-1, feature, the feature rows of the views layer) as int8
  [out, in] with per-output-channel scales folded into the next layer,
  int32 bias rows, fp32 dequant rows at the skip layer and the views layer,
  and the last trunk scales folded into the bf16 alpha head;
- ``mlp_plain_q``: the int8 chain in plain PyTorch, the kernels' oracle.

The chain (JAX ``mlp_forward_affine_q``), on the bf16 embeddings:

    h0 = relu(x_pts @ w0 + b0)                        bf16 x bf16 -> fp32
    hq = int8(min(h0 * inv_sh0 + 0.5, 127))           truncation toward 0
    layer i, "int":  a = max(hq @ Wq_i + bz_i, 0)     int8 x int8 -> int32
                     hq = requant_int(a, p, q, m, lo=0)
    layer i, "skip": zf = (hq @ Wq_i) * sw_i + x_pts @ skip_w_i + b_i
                     hq = int8(min(relu(zf) * inv_sh_i + 0.5, 127))
    sigma = hq @ alpha_w (folded, bf16) + alpha_b
    fq = requant_int(hq @ feat_q + feat_bz, lo=-127)
    hv = bf16(relu((fq @ views_q) * views_sw + x_views @ views_ws + views_b))
    rgb = hv @ rgb_w + rgb_b

A NaN activation (a NaN depth, a ray that misses the sphere) quantizes to
0 here and in the kernels: XLA, torch and CUDA each define the float ->
int8 cast of NaN differently. The maps of such a row stay NaN all the same:
its NaN z carries into compositing.

The int8 products of ``mlp_plain_q`` run as fp32 matrix products and are
exact: every partial sum is below 127^2 * 256 < 2^24, so no summation
order changes them (with TF32 off: ``strict_fp32``). The integer epilogue
runs on int64 tensors, so the plain version runs on the CPU and on the
card alike.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.utils.precision import strict_fp32

_I8MAX = 127.0


@dataclasses.dataclass(frozen=True)
class QuantCalib:
    """Static per-layer requant constants of one NeRF.

    steps[i-1] describes trunk layer i (i = 1..D-1):
      ("int", p, q, m)   integer-domain requant (non-skip layers)
      ("skip", inv_sh)   fp32 merge + per-tensor requant (skip layers)
    feat: ("int", p, q, m) for the feature layer (signed clip).
    sh0: per-tensor scale of h_0 (layer 0's fp32 relu output).
    """

    sh0: float
    steps: tuple
    feat: tuple


def _decompose(S: float) -> tuple[int, int, int]:
    """(p, q, m) with (t*m)>>q ~ a/S for t = a>>p, t <= 2^15, m < 2^15."""
    S = float(max(S, 1e-20))
    amax_int = _I8MAX * S
    p = max(0, int(math.ceil(math.log2(max(amax_int, 1.0)))) - 15)
    ratio = (2.0**p) / S
    q = 14 - int(math.floor(math.log2(ratio)))
    q = max(0, min(q, 30))
    m = int(round(ratio * (2.0**q)))
    m = min(max(m, 1), (1 << 15) - 1)
    return p, q, m


def _scale_of(step) -> float:
    """The requant step's effective scalar S (h_q ~ a_i32 / S)."""
    _, p, q, m = step
    return (2.0 ** (p + q)) / m


def calibrate_nerf_quant(
    model: NeRF,
    rays_o,
    rays_d,
    *,
    near: float = 2.0,
    far: float = 6.0,
    multires: int = 10,
    multires_views: int = 4,
    n_rays: int = 512,
    n_z: int = 17,
) -> QuantCalib:
    """Host-side calibration of ``model``: a full-precision forward over the
    linspace z grid of ``n_rays`` of the given rays [N, 3], recording the
    activation ranges the integer requant constants need (JAX
    ``calibrate_nerf_quant``; the same scale chain, on the port's weights
    and positional encoding)."""
    from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf

    cfg = model.cfg
    if not cfg.use_viewdirs:
        raise ValueError("int8 quantization targets use_viewdirs kernels")
    Cp = cfg.input_ch
    pk = pack_nerf(model, torch.float32)  # host fp32 copies of its layout, the PE rows unpadded
    w0, fw, fb = (pk[k].cpu().numpy() for k in ("w0", "feature_w", "feature_b"))
    tw, tb = [w.cpu().numpy() for w in pk["trunk_w"]], [b.cpu().numpy() for b in pk["trunk_b"]]
    skip_w = {i: w.cpu().numpy()[:Cp] for i, w in pk["skip_w"].items()}
    o = np.asarray(torch.as_tensor(rays_o).detach().cpu(), np.float32).reshape(-1, 3)
    d = np.asarray(torch.as_tensor(rays_d).detach().cpu(), np.float32).reshape(-1, 3)
    idx = np.linspace(0, o.shape[0] - 1, min(n_rays, o.shape[0])).astype(int)
    o, d = o[idx], d[idx]
    z = np.linspace(near, far, n_z, dtype=np.float32)
    pts = (o[:, None] + z[None, :, None] * d[:, None]).reshape(-1, 3)
    x = positional_encoding(torch.from_numpy(pts), multires).numpy()

    D = cfg.D
    skips = set(cfg.skips)
    h = np.maximum(x @ w0[:Cp] + tb[0], 0.0)
    hmax = [np.abs(h).max(axis=0)]  # per-channel amax of h_0..h_{D-1}
    for i in range(1, D):
        zi = h @ tw[i - 1]
        if (i - 1) in skips:
            zi = zi + x @ skip_w[i]
        h = np.maximum(zi + tb[i], 0.0)
        hmax.append(np.abs(h).max(axis=0))
    feat = h @ fw + fb
    fmax = np.abs(feat).max(axis=0)

    # walk the scale chain exactly as qpack_nerf will, deriving the static
    # requant constants from the calibrated amaxes
    sh0 = float(max(hmax[0].max() / _I8MAX, 1e-12))
    u = np.full(cfg.W, sh0, np.float32)
    steps = []
    for i in range(1, D):
        if (i - 1) in skips:
            sh = float(max(hmax[i].max() / _I8MAX, 1e-12))
            steps.append(("skip", 1.0 / sh))
            u = np.full(cfg.W, sh, np.float32)
        else:
            wfold = tw[i - 1] * u[:, None]
            sw = np.maximum(np.abs(wfold).max(axis=0) / _I8MAX, 1e-12)
            amax_int = float((hmax[i] / sw).max())
            pqm = _decompose(amax_int / _I8MAX)
            steps.append(("int",) + pqm)
            pp, qq, mm = pqm
            u = sw * (2.0 ** (pp + qq) / mm)
    wfold = fw * u[:, None]
    sw_f = np.maximum(np.abs(wfold).max(axis=0) / _I8MAX, 1e-12)
    amax_int_f = float((fmax / sw_f).max())
    feat_pqm = ("int",) + _decompose(amax_int_f / _I8MAX)
    return QuantCalib(sh0=sh0, steps=tuple(steps), feat=feat_pqm)


def check_calib(calib: QuantCalib, cfg: NeRFConfig) -> None:
    """Raises unless ``calib`` describes a NeRF of ``cfg``'s depth and skips."""
    if not isinstance(calib, QuantCalib):
        raise TypeError(f"expected a QuantCalib, got {type(calib).__name__}")
    kinds = tuple("skip" if (i - 1) in cfg.skips else "int" for i in range(1, cfg.D))
    if tuple(s[0] for s in calib.steps) != kinds or calib.feat[0] != "int":
        raise ValueError("the QuantCalib was made for another NeRF architecture")


def _f32(x: float, device) -> torch.Tensor:
    """A Python float rounded to fp32 once, as JAX rounds a weak-typed scalar."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def qpack_nerf(model: NeRF, calib: QuantCalib) -> dict:
    """The int8 pack of ``model`` under ``calib`` in ``pack_nerf``'s layout
    ([in, out] matrices over the 96-column PE row), but for the int8
    matrices, which are [out, in]: an output channel's weights lie
    contiguous, as the kernels' int8 tensor-core loads read them. The keys
    the int8 kernels read (JAX ``qpack_nerf_params``):

    - ``w0`` bf16 [64, W], ``b0`` fp32 [W]: layer 0;
    - ``trunk_wq``: int8 [W, W] of layers 1..D-1; ``trunk_row``: their int32
      bias rows [W], or at a skip layer its fp32 dequant row [W];
    - ``skip_w`` {i: bf16 [64, W]}, ``skip_b`` {i: fp32 [W]} at the skip layers;
    - ``feature_wq`` int8 [W, W], ``feature_bz`` int32 [W];
    - ``alpha_w`` bf16 [W] (the last trunk scales folded in), ``alpha_b``;
    - ``views_wq`` int8 [W/2, W], ``views_sw`` fp32 [W/2], ``views_ws`` bf16
      [32, W/2], ``views_b``; ``rgb_w`` bf16 [3, W/2], ``rgb_b``;
    - ``calib``: the QuantCalib, whose scalars the kernels take as they are.
    """
    from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf

    cfg = model.cfg
    check_calib(calib, cfg)
    p = pack_nerf(model, torch.float32)
    dev = p["w0"].device
    bf16 = torch.bfloat16

    def qweights(w: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        wfold = w * u[:, None]
        sw = torch.clamp(torch.abs(wfold).amax(dim=0) / _I8MAX, min=1e-12)
        w_q = torch.clamp(torch.round(wfold / sw), -127, 127).to(torch.int8)
        return w_q.T.contiguous(), sw.contiguous()  # [out, in]

    def bias_z(b: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(b / sw), -(2.0**30), 2.0**30).to(torch.int32).contiguous()

    out: dict = {
        "w0": p["w0"].to(bf16).contiguous(),
        "b0": p["trunk_b"][0],
        "trunk_wq": [],
        "trunk_row": [],
        "skip_w": {},
        "skip_b": {},
        "calib": calib,
    }
    u = torch.full((cfg.W,), calib.sh0, dtype=torch.float32, device=dev)
    for i in range(1, cfg.D):
        step = calib.steps[i - 1]
        w_q, sw = qweights(p["trunk_w"][i - 1], u)
        out["trunk_wq"].append(w_q)
        if step[0] == "skip":
            out["skip_w"][i] = p["skip_w"][i].to(bf16).contiguous()
            out["skip_b"][i] = p["trunk_b"][i]
            out["trunk_row"].append(sw)  # fp32 dequant row
            u = torch.full((cfg.W,), 1.0 / step[1], dtype=torch.float32, device=dev)
        else:
            out["trunk_row"].append(bias_z(p["trunk_b"][i], sw))
            u = sw * _f32(_scale_of(step), dev)

    f_q, sw_f = qweights(p["feature_w"], u)
    out["feature_wq"] = f_q
    out["feature_bz"] = bias_z(p["feature_b"], sw_f)
    u_f = sw_f * _f32(_scale_of(calib.feat), dev)
    v_q, sw_v = qweights(p["views_wf"], u_f)
    out.update(
        views_wq=v_q, views_sw=sw_v, views_ws=p["views_ws"].to(bf16).contiguous(), views_b=p["views_b"],
        rgb_w=p["rgb_w"].to(bf16).contiguous(), rgb_b=p["rgb_b"],
        # the last trunk activation's per-channel scales folded into the alpha head
        alpha_w=(p["alpha_w"] * u).to(bf16).contiguous(), alpha_b=p["alpha_b"],
    )
    return out


def is_int8(packed: dict) -> bool:
    """True for a ``qpack_nerf`` pack (or the sigma-only part of one)."""
    return "calib" in packed


def quant_plan(packed: dict, D: int) -> np.ndarray:
    """The int8 kernels' scalar constants of a pack as one host int32 array:
    [bits(inv_sh0), then per layer i = 1..D-1 (p, q, m, bits(inv_sh)), then
    the feature layer's (p, q, m)]; inv_sh is 1/sh rounded to fp32 once, as
    JAX rounds its weak-typed Python scalar, and 0 at the int layers."""
    calib = packed["calib"]
    plan = np.zeros(1 + 4 * (D - 1) + 3, np.int32)
    plan[0] = np.float32(1.0 / calib.sh0).view(np.int32)
    for i, step in enumerate(calib.steps):
        if step[0] == "skip":
            plan[1 + 4 * i + 3] = np.float32(step[1]).view(np.int32)
        else:
            plan[1 + 4 * i : 1 + 4 * i + 3] = step[1:]
    plan[-3:] = calib.feat[1:]
    return plan


def _requant_fp32(h: torch.Tensor, inv_sh: float) -> torch.Tensor:
    """Nonneg fp32 -> int8 values (as fp32) via a scalar scale, round-half-up
    by truncation of h*inv_sh + 0.5 (two rounded fp32 steps); NaN -> 0."""
    x = h * _f32(inv_sh, h.device) + 0.5
    x = torch.where(torch.isnan(x), torch.zeros_like(x), torch.clamp(x, max=_I8MAX))
    return torch.trunc(x)


def _requant_int(a: torch.Tensor, step, lo: int) -> torch.Tensor:
    """clip((a >> p) * m >> q, lo, 127) with round-to-nearest shift bias on
    int64 values of an int32 accumulator; the pre-shifted value is clamped
    to +-2^15 so that t*m stays inside int32, as the kernels do (JAX
    ``_requant_int``: saturates, never wraps). Returns fp32 values."""
    _, p, q, m = step
    if p > 0:
        a = (a >> p) + ((a >> (p - 1)) & 1)
    a = torch.clamp(a, -(1 << 15), (1 << 15) - 1) * m
    if q > 0:
        a = (a + (1 << (q - 1))) >> q
    return torch.clamp(a, lo, 127).to(torch.float32)


def mlp_plain_q(
    packed: dict,
    cfg: NeRFConfig,
    x_pts: torch.Tensor,
    x_v: torch.Tensor | None,
    sigma_only: bool = False,
    acts: list | None = None,
) -> torch.Tensor:
    """K10's computation in plain PyTorch on the bf16-rounded embeddings
    [M, Cp] and [M, Cv] (as fp32 tensors): raw [M, 4] (rgb logits, sigma),
    or sigma [M] with ``sigma_only`` (trunk and alpha head only). ``acts``,
    where given, receives the int8 activations (fp32 tensors of int8
    values): each trunk layer's hq, then unless ``sigma_only`` fq."""
    strict_fp32()
    f32, i64 = torch.float32, torch.int64
    Cp, Cv = cfg.input_ch, cfg.input_ch_views
    calib: QuantCalib = packed["calib"]

    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(f32)

    def mm_int(x: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
        return mm(x, w_q.T).to(i64)  # w_q is [out, in]; exact: every partial sum is below 2^24

    acts = [] if acts is None else acts
    hq = _requant_fp32(torch.relu(mm(x_pts, packed["w0"][:Cp]) + packed["b0"]), 1.0 / calib.sh0)
    acts.append(hq)
    for i in range(1, cfg.D):
        step = calib.steps[i - 1]
        row = packed["trunk_row"][i - 1]
        if step[0] == "skip":
            zf = mm(hq, packed["trunk_wq"][i - 1].T) * row + mm(x_pts, packed["skip_w"][i][:Cp]) + packed["skip_b"][i]
            hq = _requant_fp32(torch.relu(zf), step[1])
        else:
            hq = _requant_int(torch.clamp(mm_int(hq, packed["trunk_wq"][i - 1]) + row.to(i64), min=0), step, 0)
        acts.append(hq)
    sigma = mm(hq, packed["alpha_w"][:, None]) + packed["alpha_b"]
    if sigma_only:
        return sigma[:, 0]
    fq = _requant_int(mm_int(hq, packed["feature_wq"]) + packed["feature_bz"].to(i64), calib.feat, -127)
    acts.append(fq)
    zv = mm(fq, packed["views_wq"].T) * packed["views_sw"] + mm(x_v, packed["views_ws"][:Cv]) + packed["views_b"]
    hv = torch.relu(zv).to(torch.bfloat16).to(f32)
    rgb_logits = mm(hv, packed["rgb_w"].T) + packed["rgb_b"]
    return torch.cat([rgb_logits, sigma], -1)
