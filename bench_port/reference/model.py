"""The plain reference of the NeRF and DepthNet renders, from raw arrays.

Plain PyTorch in float32 with TF32 off (``strict_fp32``), written from the
published models, not from the program:

- positional encoding: [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x),
  cos(2^(L-1) x)], each block over all input channels (NeRF, Mildenhall et
  al. 2020, and nerf-pytorch's Embedder);
- the NeRF MLP of nerf-pytorch (``run_nerf_helpers.NeRF``): 8 ReLU layers
  of 256, the embedded point concatenated before layer 5, the density head
  on the trunk, a feature layer, the embedded view direction, one ReLU
  layer of 128 and the rgb head;
- the DepthNet of the reference sampler (``depth_nets/depth_net.py``):
  three towers over the embedded origin, direction and the two ray-sphere
  intersections, each layer fed its tower's embedding again and applied
  without an activation (the reference builds LeakyReLUs there and never
  calls them), a trunk of LeakyReLU(0.01) layers over the towers' outputs
  and the three embeddings, a sigmoid head scaled to [near, far];
- alpha compositing with the reference's constants: a last interval of
  1e10, 1e-10 inside the exclusive transmittance product, white background;
- the uniform population around a depth: the depth and n - 1 evenly spaced
  offsets over [-distance, distance], sorted, clipped to [near, far];
- the hierarchical pass: a stratified coarse grid over [near, far],
  inverse-CDF fine samples from the coarse weights (plus 1e-5) over the
  coarse midpoints, the union sorted, the fine NeRF over it; the argmax
  sample of the fine weights (first maximum).

A network is its raw tree: dicts and lists of {"weight": [in, out],
"bias": [out]} tensors (``to_torch``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def strict_fp32():
    """float32 products with TF32 off, the settings restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd


def to_torch(tree, device, requires_grad: bool = False):
    """The raw tree as float32 tensors on ``device`` (leaves that need a
    gradient with ``requires_grad``)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, requires_grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v, device, requires_grad) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device, requires_grad=requires_grad)


def leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """name -> leaf, named ``<layer>.<index>.<weight|bias>`` as the
    reference modules name them."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def dense(layer: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ layer["weight"] + layer["bias"]


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Positional encoding of [..., d] to [..., d * (1 + 2 n_freqs)]."""
    parts = [x]
    for i in range(n_freqs):
        f = float(2.0**i)
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, -1)


def nerf(net: dict, pts_emb: torch.Tensor, view_emb: torch.Tensor, skip: int = 4) -> torch.Tensor:
    """raw [..., 4] (rgb logits, density) of the embedded points and views."""
    h = pts_emb
    for i, layer in enumerate(net["pts_linears"]):
        h = torch.relu(dense(layer, h))
        if i == skip:
            h = torch.cat([pts_emb, h], -1)
    alpha = dense(net["alpha_linear"], h)
    h = torch.cat([dense(net["feature_linear"], h), view_emb], -1)
    for layer in net["views_linears"]:
        h = torch.relu(dense(layer, h))
    return torch.cat([dense(net["rgb_linear"], h), alpha], -1)


def nerf_density(net: dict, pts_emb: torch.Tensor, skip: int = 4) -> torch.Tensor:
    """The density head alone [...] (what the coarse pass of a render reads)."""
    h = pts_emb
    for i, layer in enumerate(net["pts_linears"]):
        h = torch.relu(dense(layer, h))
        if i == skip:
            h = torch.cat([pts_emb, h], -1)
    return dense(net["alpha_linear"], h)[..., 0]


def query(net: dict, pts: torch.Tensor, viewdirs: torch.Tensor, multires: int, multires_views: int) -> torch.Tensor:
    """raw [N, S, 4] of points [N, S, 3] seen along unit directions [N, 3]."""
    v = viewdirs[:, None, :].expand(pts.shape)
    return nerf(net, encode(pts, multires), encode(v, multires_views))


def sphere_hits(o: torch.Tensor, d: torch.Tensor, radius: float) -> torch.Tensor:
    """The two intersections [N, 6] of rays with the origin-centred sphere
    (near root first); NaN where a ray misses."""
    a = (d * d).sum(-1)
    b = 2.0 * (d * o).sum(-1)
    c = (o * o).sum(-1) - radius * radius
    root = torch.sqrt(b * b - 4.0 * a * c)
    t = torch.stack([(-b - root) / (2.0 * a), (-b + root) / (2.0 * a)], -1)
    return (o[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 6)


def depth_net(net: dict, o: torch.Tensor, d: torch.Tensor, *, multires: int, radius: float,
              near: float, far: float) -> torch.Tensor:
    """Predicted depth [N, 1] of rays [N, 3]."""
    embs = [encode(o, multires), encode(d, multires), encode(sphere_hits(o, d, radius), multires)]
    outs = []
    for tower, emb in zip(("origin_layers", "direction_layers", "intersection_layers"), embs):
        h = emb
        for layer in net[tower]:
            h = dense(layer, torch.cat([h, emb], -1))
        outs.append(h)
    h = torch.cat(outs + embs, -1)
    for layer in net["cat_layers"]:
        h = torch.nn.functional.leaky_relu(dense(layer, h), 0.01)
    s = torch.sigmoid(dense(net["to_depth"], h))
    return near * (1.0 - s) + far * s


def composite(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor, white_bkgd: bool = True) -> dict:
    """rgb [N, 3], depth [N], acc [N] and weights [N, S] of raw [N, S, 4] at z [N, S].

    As in nerf-pytorch's ``raw2outputs``, the last interval takes the shape
    of the first of the S - 1 gaps, so one sample (S = 1) has no interval and
    no weight: its rgb is the sample's colour, with acc 0."""
    delta = z[:, 1:] - z[:, :-1]
    delta = torch.cat([delta, torch.full_like(delta[:, :1], 1e10)], -1)
    delta = delta * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if delta.shape[-1] == 0:
        return {"rgb": torch.sigmoid(raw[..., :3]).sum(1), "depth": torch.zeros_like(z[:, 0]),
                "acc": torch.zeros_like(z[:, 0]), "weights": delta}
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * delta)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(1)
    acc = w.sum(1)
    if white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    return {"rgb": rgb, "depth": (w * z).sum(1), "acc": acc, "weights": w}


def uniform_population(depth: torch.Tensor, n: int, distance: float, near: float, far: float) -> torch.Tensor:
    """z [N, n]: the depth and n - 1 offsets evenly over [-distance, distance], sorted, clipped."""
    offsets = torch.linspace(-distance, distance, n - 1, dtype=torch.float64)
    offsets = torch.sort(torch.cat([offsets, torch.zeros(1, dtype=torch.float64)])).values
    return torch.clamp(depth + offsets.to(depth), near, far)


def grid01(n: int, device) -> torch.Tensor:
    """n points evenly over [0, 1], ends included."""
    return torch.linspace(0.0, 1.0, n, device=device)


def stratified(near: float, far: float, n: int, t_rand: torch.Tensor | None, n_rays: int, device) -> torch.Tensor:
    """The coarse z [N, n]: the grid over [near, far], each sample moved
    within its stratum by ``t_rand`` (the grid itself without draws)."""
    t = grid01(n, device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n)
    if t_rand is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * t_rand


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Samples at uniforms u [N, m] of the piecewise-constant density of
    ``weights`` [N, B - 1] (plus 1e-5) over the bin edges ``bins`` [N, B]."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    b0, b1 = bins.gather(1, lo), bins.gather(1, hi)
    span = c1 - c0
    span = torch.where(span < 1e-5, torch.ones_like(span), span)
    return b0 + (u - c0) / span * (b1 - b0)


def hierarchical(coarse: dict, fine: dict, o: torch.Tensor, d: torch.Tensor, *, n_coarse: int, n_fine: int,
                 near: float, far: float, multires: int, multires_views: int,
                 t_rand: torch.Tensor | None = None, u: torch.Tensor | None = None,
                 coarse_rgb: bool = False) -> dict:
    """The hierarchical pass of rays [N, 3]: with draws (t_rand [N, n_coarse],
    u [N, n_fine]) the training pass, without them the deterministic one.
    Returns the fine maps, the argmax depth ``max_z`` [N] and, with
    ``coarse_rgb``, the coarse net's own rgb ``rgb0`` (the NeRF loss reads it)."""
    n = o.shape[0]
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z_c = stratified(near, far, n_coarse, t_rand, n, o.device)
    pts = o[:, None, :] + d[:, None, :] * z_c[..., None]
    if coarse_rgb:
        raw_c = query(coarse, pts, viewdirs, multires, multires_views)
    else:
        sigma = nerf_density(coarse, encode(pts, multires))
        raw_c = torch.cat([torch.zeros(*sigma.shape, 3, device=o.device), sigma[..., None]], -1)
    out_c = composite(raw_c, z_c, d)
    if u is None:
        u = grid01(n_fine, o.device).expand(n, n_fine)
    mids = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    z_f = inverse_cdf(mids, out_c["weights"][:, 1:-1].detach(), u).detach()
    z = torch.sort(torch.cat([z_c, z_f], -1), dim=-1, stable=True).values
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    out = composite(query(fine, pts, viewdirs, multires, multires_views), z, d)
    top = torch.argmax(out["weights"], 1, keepdim=True)
    out["max_z"] = z.gather(1, top)[:, 0]
    if coarse_rgb:
        out["rgb0"] = out_c["rgb"]
    return out
