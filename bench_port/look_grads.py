"""The look behind ``train_nerf``'s first-gradient numbers: where each leaf's gap comes from.

    python3 bench_port/look_grads.py --seeds 1,2,3 [--out DIR]

For each seed the cell is set up as a run sets it up (the program's first
step through the window's dispatcher), and every counted leaf's first
gradient is set beside the plain reference's (fp32, TF32 off), by the
check's measure (the gap of the two norms over the larger of the
reference leaf's norm and the median counted leaf's) and by the norm of
the difference over the same:

- ``program``: the program's, from its Adam state, as the check reads it;
- ``witness``: the reference with every product's operands rounded to
  bfloat16, the precision the configuration states for K4 and K5;
- ``k5``: K5 alone, fed the reference's own fine-net points and cotangent
  (dL/draw), against the reference's fp32 gradient of the same query;
  ``k5_plain`` the program's plain bf16 version of K5 on the same.

One JSON line per seed on standard output (the worst leaf of each and the
alpha bias's cancellation: the sum of its per-sample terms' magnitudes over
the magnitude of their sum); with ``--out``, every leaf's readings in
``<out>/<seed>.json``. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gaps(got: dict, ref: dict, names: list[str], floor: float) -> dict[str, tuple[float, float]]:
    """name -> (norm gap, difference norm), each over max(reference norm, floor)."""
    out = {}
    for k in names:
        r = float(ref[k].norm())
        out[k] = (abs(float(got[k].norm()) - r) / max(r, floor), float((got[k] - ref[k]).norm()) / max(r, floor))
    return out


def worst(table: dict[str, tuple[float, float]], i: int = 0) -> tuple[str, float]:
    k = max(table, key=lambda n: table[n][i])
    return k, table[k][i]


def look(seed: int, device: str = "cuda", workload_overrides: dict | None = None,
         config_overrides: dict | None = None) -> dict:
    """One seed's readings (the overrides, merged into the cell's traffic and
    configuration, are for the tests, which run it on the CPU at small sizes)."""
    import numpy as np
    import torch

    from bench_port.drivers import port
    from bench_port.drivers import train_chunks as TC
    from bench_port.harness import Spans, load_json
    from bench_port.reference import model as M
    from nerf_sampling_tpu_torch.kernels.fused_nerf import flat_queries
    from nerf_sampling_tpu_torch.kernels.fused_nerf_vjp import (grads_to_params, nerf_points_bwd_kernel,
                                                                nerf_points_bwd_plain)
    from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf

    class Cell(TC.Cell):
        def _first_grads(self):
            opt = self.state.optimizer
            by_param = {id(p): k for k, p in self.named.items()}
            self.grad1_t = {by_param[id(p)]: (opt.state[p]["exp_avg"] / (1.0 - TC.B1)).detach().clone()
                            for g in opt.param_groups for p in g["params"] if p in opt.state}
            return super()._first_grads()

    wl = load_json("workloads", "train_nerf")
    wl = {**wl, "traffic": {**wl["traffic"], **(workload_overrides or {})}}
    cfg = {**load_json("configs", wl["config"]), **(config_overrides or {})}
    dev = torch.device(device)
    cell = Cell(wl, cfg, seed, dev, Spans())
    cell.setup()
    program = {k: (g.T if g.dim() == 2 else g) for k, g in cell.grad1_t.items()}
    cell.release()
    _, ref, _ = cell._reference_steps()
    _, wit, _ = cell._reference_steps(torch.bfloat16)
    ref_n = {k: float(g.norm()) for k, g in ref.items()}
    g_all = float(np.median(list(ref_n.values())))
    counted = [k for k in ref if ref_n[k] > 0 and ref_n[k] >= 1e-3 * g_all]
    floor = float(np.median([ref_n[k] for k in counted]))
    program = {k: program.get(k, torch.zeros_like(ref[k])).reshape(ref[k].shape) for k in counted}

    # K5 alone on the reference's own step-1 fine query and cotangent
    row, step_seed = cell.batches[0]
    o, d, target = (torch.from_numpy(np.ascontiguousarray(row[:, c:c + 3])).to(dev) for c in (0, 3, 6))
    n = o.shape[0]
    gen = torch.Generator(device=dev).manual_seed(step_seed)
    t_rand = torch.rand((n, cfg["N_samples"]), generator=gen, device=dev)
    u = torch.rand((n, cfg["N_importance"]), generator=gen, device=dev)
    nets = M.to_torch({"coarse": cell.raw["coarse"], "fine": cell.raw["fine"]}, dev, requires_grad=True)
    calls, real = [], M.query

    def recorded(net, pts, viewdirs, *args):
        raw = real(net, pts, viewdirs, *args)
        calls.append((pts, viewdirs, raw))
        return raw

    M.query = recorded
    try:
        with M.strict_fp32():
            out = M.hierarchical(nets["coarse"], nets["fine"], o, d, n_coarse=cfg["N_samples"],
                                 n_fine=cfg["N_importance"], near=cfg["near"], far=cfg["far"],
                                 multires=cfg["nerf"]["multires"], multires_views=cfg["nerf"]["multires_views"],
                                 t_rand=t_rand, u=u, coarse_rgb=True)
            loss = torch.mean((out["rgb"] - target) ** 2) + torch.mean((out["rgb0"] - target) ** 2)
            pts, viewdirs, raw = calls[-1]
            fine_leaves = M.leaves(nets["fine"])
            grads = torch.autograd.grad(loss, [raw] + list(fine_leaves.values()))
    finally:
        M.query = real
    g_raw = grads[0].reshape(-1, 4).contiguous()
    vjp = {f"fine.{k}": g for k, g in zip(fine_leaves, grads[1:])}
    fine = port.modules(port.pipeline(cfg, "cuda"), cell.raw, dev, with_depth=False).fine
    packed = pack_nerf(fine, torch.bfloat16)
    p, dirs = flat_queries(pts.detach(), viewdirs[:, None, :].detach())
    kw = dict(want_dx=False, multires=cfg["nerf"]["multires"], multires_views=cfg["nerf"]["multires_views"])

    def by_leaf(d_packed: dict) -> dict:
        got = grads_to_params(fine, d_packed)
        return {f"fine.{k}": (g.T if g.dim() == 2 else g).reshape(vjp[f"fine.{k}"].shape)
                for (k, _), g in zip(fine.named_parameters(), got)}

    k5 = by_leaf(nerf_points_bwd_kernel(packed, fine.cfg, p, dirs, g_raw, **kw)[0])
    k5_plain = by_leaf(nerf_points_bwd_plain(packed, fine.cfg, p, dirs, g_raw, dtype=torch.bfloat16, **kw)[0])
    fine_counted = [k for k in counted if k.startswith("fine.")]

    tables = {"program": gaps(program, ref, counted, floor), "witness": gaps(wit, ref, counted, floor),
              "k5": gaps(k5, vjp, fine_counted, floor), "k5_plain": gaps(k5_plain, vjp, fine_counted, floor),
              "k5_vs_plain": gaps(k5, k5_plain, fine_counted, floor)}
    sigma = g_raw[:, 3].double()
    line = {"seed": seed, "counted": len(counted), "median_leaf_norm": floor,
            "alpha_b_cancellation": float(sigma.abs().sum() / sigma.sum().abs().clamp(min=1e-300))}
    for name, table in tables.items():
        k, v = worst(table)
        line[name] = {"worst_leaf": k, "gap": v, "median_gap": float(np.median([t[0] for t in table.values()])),
                      "worst_diff_leaf": worst(table, 1)[0], "worst_diff": worst(table, 1)[1]}
    k = line["program"]["worst_leaf"]
    line["program_worst_leaf_in_witness"] = tables["witness"][k][0]
    line["per_leaf"] = {name: {k: list(v) for k, v in table.items()} for name, table in tables.items()}
    line["ref_norm"] = {k: ref_n[k] for k in counted}
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = look(seed)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{seed}.json"), "w") as fp:
                json.dump(line, fp)
        print(json.dumps({k: v for k, v in line.items() if k not in ("per_leaf", "ref_norm")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
