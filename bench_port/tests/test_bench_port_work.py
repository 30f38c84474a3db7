"""The work counts from the configuration's widths against the program's modules at production widths."""

import pytest
import torch

from bench_port.drivers import port
from bench_port.harness import checkpoint, load_json, work
from bench_port.work import depth_net_query, nerf_density, nerf_query


def weights(module) -> int:
    return sum(x.weight.numel() for x in module.modules() if isinstance(x, torch.nn.Linear))


def test_query_counts_are_the_modules_weights():
    cfg = load_json("configs", "lego_depthnet")
    mods = port.modules(port.pipeline(cfg, "plain"), checkpoint(cfg), "cpu",
                        with_depth=True)
    nerf_w, depth_w = weights(mods.fine), weights(mods.depth)
    assert nerf_query.macs(cfg["nerf_fine"]) == nerf_w == 593_408
    assert depth_net_query.macs(cfg["depth_net"]) == depth_w == 3_330_304
    sigma = sum(x.weight.numel() for x in mods.coarse.pts_linears) + mods.coarse.alpha_linear.weight.numel()
    assert nerf_density.macs(cfg["nerf"]) == sigma == 491_264
    assert nerf_query.params(cfg["nerf_fine"]) == sum(p.numel() for p in mods.fine.parameters())
    assert depth_net_query.params(cfg["depth_net"]) == sum(p.numel() for p in mods.depth.parameters())


@pytest.mark.parametrize("cell, flops_per_ray", [
    ("render_depthnet", 2 * (3_330_304 + 64 * 593_408)),
    ("render_full", 2 * (64 * 491_264 + 192 * 593_408)),
    ("train_depthnet", 2 * (64 * 491_264 + 192 * 593_408 + 3 * 3_330_304 + 2 * 593_408)),
    ("train_nerf", 2 * 3 * 256 * 593_408),
])
def test_cell_work_per_ray(cell, flops_per_ray):
    wl = load_json("workloads", cell)
    cfg = load_json("configs", wl["config"])
    flops, nbytes = work(wl["work"], cfg, 1024.0)
    assert flops == pytest.approx(1024 * flops_per_ray, rel=1e-12)
    assert nbytes > 0
