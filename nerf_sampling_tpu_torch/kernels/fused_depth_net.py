"""K1: the DepthNet forward as a hand-written CUDA kernel, with its plain version.

Replaces nerf_sampling_tpu/kernels/fused_depth_net.py::_fused_call. The
kernel source is ``csrc/depth_net.cu``. The wrapper builds the two [N, 128]
bf16 input buffers outside the kernel, as the JAX wrapper does:

    A: origin embedding in columns [0, 63), direction embedding in [63, 126)
    B: embedding of the flattened [N, 6] sphere intersections in [0, 126)

and every concatenation of the DepthNet becomes a sum of products with
zero-padded weights (``pack_depth_net``). ``depth_net_plain`` computes the
same sums in plain PyTorch: with ``dtype=torch.float32`` it is the fp32
reference, with bf16 it rounds weights and activations where the kernel
does, so the kernel can be held to it tightly on the card. The kernel runs
bf16 or, for the COMPARE mode, fp32 (fp32 buffers and weights, no
rounding), chosen by the buffers' dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.core.geometry import find_intersection_points_with_sphere
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels.fused_render import dtype_name
from nerf_sampling_tpu_torch.models.depth_net import DepthNet, DepthNetConfig
from nerf_sampling_tpu_torch.utils.precision import strict_fp32

PAD = 128
KERNEL_HIDDEN = 256  # hidden width the CUDA kernel is built for

# kernel launches since the last reset (see chip_smoke.py), bf16 and fp32
launches = fp32_launches = 0


def _in_out(lin: nn.Linear) -> torch.Tensor:
    return lin.weight.detach().float().T


def _bias(lin: nn.Linear) -> torch.Tensor:
    return lin.bias.detach().float().contiguous()


def pack_depth_net(model: DepthNet, dtype=torch.bfloat16) -> dict:
    """Repack a DepthNet's weights as [in, out] matrices for buffers A and B."""
    cfg = model.cfg
    eo, ed, ei = cfg.origin_dims, cfg.direction_dims, cfg.intersection_dims
    H = cfg.hidden_sizes
    if max(eo + ed, ei) > PAD:
        raise ValueError("embedding widths exceed PAD")
    if len(set(H)) != 1 or len(set(cfg.cat_hidden_sizes)) != 1:
        raise ValueError("the fused DepthNet needs uniform hidden sizes")

    def pad_rows(w: torch.Tensor, off: int) -> torch.Tensor:
        out = torch.zeros((PAD, w.shape[1]), device=w.device)
        out[off : off + w.shape[0]] = w
        return out.to(dtype).contiguous()

    def cast(w: torch.Tensor) -> torch.Tensor:
        return w.to(dtype).contiguous()

    def tower(seq: nn.Sequential, emb_dim: int, off: int) -> dict:
        t = {"e": [], "h": [], "b": [_bias(lin) for lin in seq]}
        for i, lin in enumerate(seq):
            w = _in_out(lin)
            if i == 0:  # cat([emb, emb]) @ W == emb @ (W_top + W_bottom)
                t["e"].append(pad_rows(w[:emb_dim] + w[emb_dim:], off))
            else:  # cat([h, emb]) @ W
                t["h"].append(cast(w[: H[0]]))
                t["e"].append(pad_rows(w[H[0] :], off))
        return t

    lins = [m for m in model.cat_layers if isinstance(m, nn.Linear)]
    w0 = _in_out(lins[0])  # rows [o(H) | d(H) | i(H) | o_emb | d_emb | i_emb]
    Hn = H[-1]
    emb0 = 3 * Hn
    wa = torch.zeros((PAD, w0.shape[1]), device=w0.device)
    wa[:eo] = w0[emb0 : emb0 + eo]
    wa[eo : eo + ed] = w0[emb0 + eo : emb0 + eo + ed]
    head = model.to_depth[0]
    return {
        "o": tower(model.origin_layers, eo, 0),
        "d": tower(model.direction_layers, ed, eo),
        "i": tower(model.intersection_layers, ei, 0),
        "cat0": [
            cast(w0[0:Hn]), cast(w0[Hn : 2 * Hn]), cast(w0[2 * Hn : 3 * Hn]),
            cast(wa), pad_rows(w0[emb0 + eo + ed :], 0),
        ],
        "cat_w": [cast(_in_out(lin)) for lin in lins[1:]],
        "cat_b": [_bias(lin) for lin in lins],
        "head_w": cast(_in_out(head)[:, 0]),
        "head_b": _bias(head),
    }


def depth_net_inputs(
    cfg: DepthNetConfig, rays_o: torch.Tensor, rays_d: torch.Tensor, dtype=torch.bfloat16
) -> tuple[torch.Tensor, torch.Tensor]:
    """Buffers A and B [N, 128] from the rays' encodings and sphere hits."""
    eo, ed, ei = cfg.origin_dims, cfg.direction_dims, cfg.intersection_dims
    n = rays_o.shape[0]
    _, inters = find_intersection_points_with_sphere(rays_o, rays_d, cfg.sphere_radius)
    A = torch.zeros((n, PAD), dtype=dtype, device=rays_o.device)
    A[:, :eo] = positional_encoding(rays_o, cfg.multires).to(dtype)
    A[:, eo : eo + ed] = positional_encoding(rays_d, cfg.multires).to(dtype)
    B = torch.zeros((n, PAD), dtype=dtype, device=rays_o.device)
    B[:, :ei] = positional_encoding(inters.reshape(n, 6), cfg.multires).to(dtype)
    return A, B


def depth_net_plain(
    packed: dict, cfg: DepthNetConfig, A: torch.Tensor, B: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """The kernel's computation in plain PyTorch -> depth [N] fp32."""
    strict_fp32()
    f32 = torch.float32

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype).to(f32)

    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w.to(f32)

    A, B = A.to(f32), B.to(f32)

    def run_tower(t: dict, buf: torch.Tensor) -> torch.Tensor:
        h = None
        for i, b in enumerate(t["b"]):
            z = mm(buf, t["e"][i])
            if i > 0:
                z = z + mm(h, t["h"][i - 1])
            h = rnd(z + b)  # towers: no activation (reference quirk)
        return h

    o, d, i_ = run_tower(packed["o"], A), run_tower(packed["d"], A), run_tower(packed["i"], B)
    c = packed["cat0"]
    z = mm(o, c[0]) + mm(d, c[1]) + mm(i_, c[2]) + mm(A, c[3]) + mm(B, c[4]) + packed["cat_b"][0]
    h = rnd(torch.where(z > 0, z, 0.01 * z))
    for w, b in zip(packed["cat_w"], packed["cat_b"][1:]):
        z = mm(h, w) + b
        h = rnd(torch.where(z > 0, z, 0.01 * z))
    depth = torch.sigmoid(mm(h, packed["head_w"][:, None])[:, 0] + packed["head_b"])
    return cfg.near * (1 - depth) + cfg.far * depth


def _flat_weights(packed: dict, dtype=torch.bfloat16) -> list[torch.Tensor]:
    """Weights in the order nst_depth_net_forward reads them, after checking
    that they are the kernel's layout: ``dtype`` matrices and fp32 biases."""
    f32 = torch.float32
    flat = []
    for t in ("o", "d", "i"):
        flat += [(w, dtype) for w in packed[t]["e"] + packed[t]["h"]]
        flat += [(b, f32) for b in packed[t]["b"]]
    flat += [(w, dtype) for w in packed["cat0"] + packed["cat_w"]]
    flat += [(b, f32) for b in packed["cat_b"]] + [(packed["head_w"], dtype), (packed["head_b"], f32)]
    for w, want in flat:
        if w.dtype != want:
            raise TypeError(f"packed weights must be pack_depth_net(model, {dtype}): {dtype_name(dtype)} "
                            f"matrices and fp32 biases, got a {w.dtype} {want} slot")
    return [w for w, _ in flat]


def depth_net_kernel(
    packed: dict, cfg: DepthNetConfig, A: torch.Tensor, B: torch.Tensor
) -> torch.Tensor:
    """Depth [N] fp32 from buffers A, B [N, 128], both bf16 or both fp32;
    ``packed`` is ``pack_depth_net`` at the same dtype.

    On a CPU tensor this runs ``depth_net_plain`` at that dtype; on a CUDA
    tensor it launches the kernel, or raises on what the kernel does not take.
    """
    global launches, fp32_launches
    n = A.shape[0]
    dtype = A.dtype
    if dtype not in (torch.bfloat16, torch.float32) or B.dtype != dtype:
        raise TypeError("A and B must be both bf16 or both fp32")
    if A.shape != (n, PAD) or B.shape != (n, PAD):
        raise ValueError(f"A and B must be [N, {PAD}], got {tuple(A.shape)} and {tuple(B.shape)}")
    if A.device != B.device:
        raise ValueError("A and B must be on one device")
    weights = _flat_weights(packed, dtype)
    if A.device.type == "cpu":
        return depth_net_plain(packed, cfg, A, B, dtype)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("A and B must be contiguous")
    if cfg.hidden_sizes[0] != KERNEL_HIDDEN or cfg.cat_hidden_sizes[0] != KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel is built for width {KERNEL_HIDDEN}")
    for w in weights:
        if w.device != A.device or not w.is_contiguous():
            raise ValueError("packed weights must be contiguous and on the inputs' device")
    lib = build.load_library()
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    arr, count = build.pointer_array([A, B, out] + weights)
    fp32 = dtype == torch.float32
    rc = lib.nst_depth_net_forward(
        arr, count, n, len(cfg.hidden_sizes), len(cfg.cat_hidden_sizes),
        float(cfg.near), float(cfg.far), int(fp32), build.current_stream(A.device),
    )
    build.check(rc, "depth_net_kernel")
    if fp32:
        fp32_launches += 1
    else:
        launches += 1
    return out


def fused_depth_net_apply(
    packed: dict, cfg: DepthNetConfig, rays_o: torch.Tensor, rays_d: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """Depth [N] of [N, 3] rays through K1; ``packed`` is
    ``pack_depth_net(model, dtype)``, made once per set of weights."""
    A, B = depth_net_inputs(cfg, rays_o, rays_d, dtype)
    return depth_net_kernel(packed, cfg, A, B)
