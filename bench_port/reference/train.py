"""The plain reference of the two train steps and of Adam, from raw arrays.

- The depth step (the reference sampler's objective, ``bg_depth_loss_weight``
  0 in the recommended module): the frozen NeRFs' hierarchical pass at the
  step's draws gives each ray its target, the depth of the largest fine
  weight, and its foreground flag (fine acc > 0.5); the DepthNet predicts a
  depth, the fine NeRF is queried at that one point, whose colour is the
  ray's (one sample has no interval in nerf-pytorch's compositing); the loss is mse(rgb, target) + mean(fg * (depth -
  target depth)^2), and only the DepthNet is trained.
- The NeRF step (nerf-pytorch's): the hierarchical pass with the coarse
  net's rgb, loss mse(fine rgb, target) + mse(coarse rgb, target), both
  NeRFs trained.
- Adam as optax.adam computes it (b1 0.9, b2 0.999, eps 1e-8): m and v
  moved by the gradient, p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps);
  the NeRF's learning rate lrate * 0.1^(t_before / (decay * 1000)).

Each step returns its losses and the trained leaves' gradients by name;
``Adam.update`` then moves the leaves in place.
"""

from __future__ import annotations

import torch

from bench_port.reference import model as M


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        """``lr``: a float, or a function of the number of updates made before this one."""
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor]) -> None:
        lr = self.lr(self.t) if callable(self.lr) else self.lr
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            p.sub_(lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps))


def nerf_lr(lrate: float, decay: int):
    return lambda t: lrate * 0.1 ** (t / (decay * 1000))


def depth_step(frozen: dict, depth: dict, batch, draws: torch.Tensor, cfg: dict) -> tuple[dict, dict]:
    """(losses and the oracle's targets, gradients by leaf name) of one
    depth step; ``frozen`` holds the coarse and fine NeRFs, ``depth`` the
    DepthNet's leaves (which require grad), ``draws`` [N, n_coarse + n_fine]
    the oracle's uniforms. The targets are ``max_z`` [N] and the fine
    ``acc`` [N] of the oracle's pass."""
    o, d, target = batch
    nc, nf = cfg["N_samples"], cfg["N_importance"]
    kw = dict(multires=cfg["multires"], multires_views=cfg["multires_views"])
    with torch.no_grad():
        hier = M.hierarchical(frozen["coarse"], frozen["fine"], o, d, n_coarse=nc, n_fine=nf,
                              near=cfg["near"], far=cfg["far"], t_rand=draws[:, :nc], u=draws[:, nc:], **kw)
    z = M.depth_net(depth, o, d, multires=cfg["depth_multires"], radius=cfg["sphere_radius"],
                    near=cfg["near"], far=cfg["far"])
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rgb = M.composite(M.query(frozen["fine"], pts, viewdirs, **kw), z, d)["rgb"]
    img = torch.mean((rgb - target) ** 2)
    fg = (hier["acc"] > 0.5).to(z.dtype)[:, None]
    w = fg + cfg["bg_depth_loss_weight"] * (1.0 - fg)
    dep = torch.mean(w * (z - hier["max_z"][:, None]) ** 2)
    names = M.leaves(depth)
    grads = torch.autograd.grad(img + dep, list(names.values()))
    parts = {"img_loss": float(img.detach()), "depth_loss": float(dep.detach()), "max_z": hier["max_z"],
             "acc": hier["acc"]}
    return parts, dict(zip(names, grads))


def nerf_step(nerfs: dict, batch, t_rand: torch.Tensor, u: torch.Tensor, cfg: dict) -> tuple[dict, dict]:
    """(losses, gradients by leaf name ``coarse.*`` / ``fine.*``) of one NeRF step."""
    o, d, target = batch
    out = M.hierarchical(nerfs["coarse"], nerfs["fine"], o, d, n_coarse=cfg["N_samples"], n_fine=cfg["N_importance"],
                         near=cfg["near"], far=cfg["far"], multires=cfg["multires"],
                         multires_views=cfg["multires_views"], t_rand=t_rand, u=u, coarse_rgb=True)
    img = torch.mean((out["rgb"] - target) ** 2)
    img0 = torch.mean((out["rgb0"] - target) ** 2)
    names = M.leaves(nerfs)
    grads = torch.autograd.grad(img + img0, list(names.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(names.values(), grads)]
    return {"img_loss": float(img.detach()), "img_loss0": float(img0.detach())}, dict(zip(names, grads))
