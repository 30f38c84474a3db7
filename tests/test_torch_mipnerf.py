"""mip-NeRF on the port against the plain reference (``bench_port/reference/mipnerf.py``), on the CPU.

The reference is written from mip-NeRF's published code and imports nothing
of the port. At small sizes with seeded random weights the port's plain path
(``core``'s mip-NeRF functions, ``MipNeRF``, ``render_rays_mip``) matches it
at fp32 tolerances part by part and for a whole two-level render; K11's
plain version (``kernels/fused_mip.py``: bf16 activations and encodings)
matches it at bf16 tolerances; K11's pack puts the IPE and view columns
where the kernel's PE tile holds them, with zero rows where a layer must
not read; and mip-NeRF's ``disable_integration`` (the benchmark's
``no_integration`` fault) fails the benchmark cell's comparison.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from bench_port.reference import mipnerf as RM
from bench_port.reference.model import strict_fp32, to_torch
from nerf_sampling_tpu_torch.core.compositing import composite_intervals
from nerf_sampling_tpu_torch.core.encoding import cast_intervals, integrated_pos_enc, mip_pos_enc, safe_sin
from nerf_sampling_tpu_torch.core.rays import get_rays_mip
from nerf_sampling_tpu_torch.core.sampling import (
    blurpool_weights,
    interval_t_vals,
    resample_intervals,
    sorted_piecewise_constant_pdf,
)
from nerf_sampling_tpu_torch.kernels import build, fused_mip, fused_render
from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig, init_glorot, load_raw
from nerf_sampling_tpu_torch.render.engine import (
    EvalMode,
    NeRFParams,
    Pipeline,
    make_nerf_slices,
    pack_kernel_weights,
    render_flat_rays,
    render_image,
)
from nerf_sampling_tpu_torch.render.path import render_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "nerf_sampling_tpu_torch", "kernels", "csrc", "mlp_wgmma.cuh")
WORKLOAD = os.path.join(ROOT, "bench_port", "workloads", "render_mipnerf.json")
SIZE = 12
FOCAL = 0.5 * SIZE / np.tan(0.5 * 0.6911112070083618)
K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1]], np.float32)


def net_widths(W: int = 48, S: int = 16) -> dict:
    return dict(net_depth=8, net_width=W, skip_layer=4, net_depth_condition=1, net_width_condition=W // 2,
                min_deg_point=0, max_deg_point=16, deg_view=4, num_samples=S, num_levels=2, resample_padding=0.01,
                density_bias=-1.0, rgb_padding=0.001)


def pose(theta: float = 30.0, phi: float = -35.0, radius: float = 4.0) -> np.ndarray:
    th, ph = np.deg2rad(theta), np.deg2rad(phi)
    ct, st, cp, sp = np.cos(th), np.sin(th), np.cos(ph), np.sin(ph)
    return np.array([[-ct, st * sp, st * cp, radius * st * cp], [st, ct * sp, ct * cp, radius * ct * cp],
                     [0.0, cp, -sp, -radius * sp], [0.0, 0.0, 0.0, 1.0]], np.float32)


def scene(seed: int = 7, W: int = 48, S: int = 16):
    """(reference tree, the configuration file's dict, the module, rays) of a
    seeded glorot MLP, whose rays come out partly opaque."""
    net = net_widths(W, S)
    tree = RM.glorot(seed, net)
    cfg = {"near": 2.0, "far": 6.0, "white_bkgd": True, "mipnerf": net}
    model = load_raw(MipNeRF(MipNeRFConfig(**net)), tree)
    return tree, cfg, model, RM.rays(SIZE, float(FOCAL), pose(), None, "cpu")


def reference(tree, cfg, rays, **kw) -> dict:
    o, d, vd, rad = rays
    with torch.no_grad(), strict_fp32():
        return RM.render(to_torch(tree, "cpu"), cfg, o, d, vd, rad, **kw)


def gaps(got: dict, want: dict) -> dict:
    fg = want["acc"] > 0.5
    return {"rgb_mse": float(((got["rgb"] - want["rgb"]) ** 2).mean(1).mean()),
            "depth_gap": float((got["depth"][fg] - want["depth"][fg]).abs().mean()),
            "acc_gap": float((got["acc"] - want["acc"]).abs().mean())}


def test_rays_match_the_reference_and_the_radius_is_about_one_over_focal():
    o, d, vd, rad = RM.rays(SIZE, float(FOCAL), pose(), None, "cpu")
    ro, rd, rr = get_rays_mip(SIZE, SIZE, K, pose()[:3, :4])
    torch.testing.assert_close(ro.reshape(-1, 3), o, rtol=0, atol=0)
    torch.testing.assert_close(rd.reshape(-1, 3), d, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(rr.reshape(-1, 1), rad, rtol=1e-5, atol=0)
    assert torch.allclose(rad, torch.full_like(rad, 2 / FOCAL / np.sqrt(12)), rtol=1e-4)


def test_frustum_gaussian_matches_the_reference():
    g = torch.Generator().manual_seed(1)
    d = torch.randn(32, 3, generator=g)
    t = torch.sort(2 + 4 * torch.rand(32, 9, generator=g), -1).values
    radii = 0.001 + 0.05 * torch.rand(32, 1, generator=g)
    o = torch.randn(32, 3, generator=g)
    want = RM.cast_rays(t, o, d, radii)
    got = cast_intervals(t, o, d, radii)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-7)
    assert bool((got[1] > 0).all())


@pytest.mark.parametrize("magnitude", [1.0, 6.0])
def test_ipe_matches_the_reference(magnitude):
    """Means of magnitude up to 6 at 2^15 put most arguments past 100 pi,
    through safe_sin's wrap; negative ones take Python's modulus."""
    g = torch.Generator().manual_seed(2)
    mean = (torch.rand(64, 5, 3, generator=g) * 2 - 1) * magnitude
    cov = torch.rand(64, 5, 3, generator=g) * 1e-4
    got = integrated_pos_enc(mean, cov, 0, 16)
    want = RM.integrated_pos_enc(mean, cov, 0, 16)
    assert got.shape == (64, 5, 96)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    x = torch.tensor([-1000.0, -314.2, -1.0, 0.0, 2.0, 314.2, 5000.0, 1e5])
    torch.testing.assert_close(safe_sin(x), RM.safe_sin(x), rtol=0, atol=0)
    v = torch.nn.functional.normalize(torch.randn(16, 3, generator=g), dim=-1)
    torch.testing.assert_close(mip_pos_enc(v, 4), RM.pos_enc(v, 0, 4), rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", ["zero", "not_flat", "zero_unpadded"])
def test_blurred_pdf_matches_the_reference(case):
    """The blurpool pdf's new t-values: on weights all zero (a flat pdf
    from the padding alone), on a peaked one, and unpadded zeros (the
    sum's eps padding)."""
    g = torch.Generator().manual_seed(3)
    t = interval_t_vals(torch.full((8, 1), 2.0), torch.full((8, 1), 6.0), 16)
    if case == "not_flat":
        w = torch.rand(8, 16, generator=g) ** 4
        w[:, 5] += 2.0
    else:
        w = torch.zeros(8, 16)
    if case == "zero_unpadded":
        got = sorted_piecewise_constant_pdf(t, w, 17)
        want = RM.sorted_piecewise_constant_pdf(t, w, 17)
    else:
        got = resample_intervals(t, w, 0.01)
        o, d, rad = torch.zeros(8, 3), torch.ones(8, 3), torch.full((8, 1), 0.01)
        want = RM.resample_along_rays(o, d, rad, t, w, 0.01)[0]
        assert bool((blurpool_weights(w, 0.01) >= 0.01).all())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    assert bool((got[:, 1:] >= got[:, :-1]).all()) and got.shape == (8, 17)
    if case != "not_flat":  # a flat pdf: the first level's t-values again, up to u's (1 - eps)
        torch.testing.assert_close(got, t, rtol=0, atol=2e-6)


def test_interval_compositing_matches_the_reference():
    g = torch.Generator().manual_seed(4)
    t = torch.sort(2 + 4 * torch.rand(6, 17, generator=g), -1).values
    density = torch.rand(6, 16, generator=g) * 3
    density[0] = 0.0  # no weight: distance 0 / 0 -> the first t-value
    rgb = torch.rand(6, 16, 3, generator=g)
    d = torch.randn(6, 3, generator=g)
    got = composite_intervals(rgb, density, t, d, True)
    want = RM.volumetric_rendering(rgb, density[..., None], t, d, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert float(got[1][0]) == float(t[0, 0]) and float(got[2][0]) == 0.0


def test_glorot_init_and_loader():
    net = net_widths()
    model = init_glorot(MipNeRF(MipNeRFConfig(**net)), torch.Generator().manual_seed(0))
    for layer in model.requires_grad_(False).layers():
        n_out, n_in = layer.weight.shape
        assert float(layer.weight.abs().max()) <= np.sqrt(6 / (n_in + n_out)) and float(layer.bias.abs().max()) == 0
    assert [tuple(l.weight.T.shape) for l in model.layers()] == RM.layer_shapes(net)
    tree = RM.glorot(5, net)
    loaded = load_raw(MipNeRF(MipNeRFConfig(**net)), tree)
    assert torch.equal(loaded.pts_linears[5].weight.T, torch.from_numpy(tree["mlp"][5]["weight"]))
    with pytest.raises(ValueError):
        load_raw(MipNeRF(MipNeRFConfig(**net_widths(W=32))), tree)


@pytest.mark.parametrize("mlp_impl", ["plain", "cuda"])
def test_two_level_render_matches_the_reference(mlp_impl):
    """render_image of a mip-NeRF Pipeline: the plain path at fp32
    tolerances, and under "cuda" on CPU tensors K11's plain version at bf16
    tolerances (no launch)."""
    tree, cfg, model, rays = scene()
    want = reference(tree, cfg, rays)
    assert 0.5 < float(want["acc"].mean()) < 1.0
    pipe = Pipeline(nerf=model.cfg, near=2.0, far=6.0, white_bkgd=True, mlp_impl=mlp_impl)
    params = NeRFParams(coarse=model)
    if mlp_impl == "cuda":
        params = pack_kernel_weights(params)
        make_nerf_slices(params.kernels)
    launches = build.launches.copy()
    maps = render_image(pipe, params, SIZE, SIZE, K, pose()[:3, :4], device="cpu", mode=EvalMode.FULL_NERF)
    assert build.launches == launches
    got = {"rgb": maps["depth_net_rgb_map"].reshape(-1, 3), "depth": maps["depth_net_z_vals"].reshape(-1),
           "acc": maps["depth_net_weights"].reshape(-1)}
    g = gaps(got, want)
    if mlp_impl == "plain":
        assert g["rgb_mse"] < 1e-12 and g["depth_gap"] < 1e-5 and g["acc_gap"] < 1e-6, g
    else:
        assert g["rgb_mse"] < 1e-6 and g["depth_gap"] < 3e-3 and g["acc_gap"] < 1e-3, g
    torch.testing.assert_close(maps["depth_net_disp_map"], 1 / maps["depth_net_z_vals"])


def test_kernel_plain_version_matches_the_reference_and_the_module():
    """K11's plain version over the pack at fp32 is the module's forward (the
    pack's zero rows read nothing they must not), and at bf16 it stays within
    bf16 tolerances of the reference."""
    tree, cfg, model, (o, d, vd, rad) = scene(W=64, S=8)
    pack32 = fused_mip.pack_mip(model, torch.float32)
    t = interval_t_vals(torch.full((o.shape[0], 1), 2.0), torch.full((o.shape[0], 1), 6.0), 8)
    x = fused_mip.pe_rows(model.cfg, *cast_intervals(t, o, d, rad), d, dtype=torch.float32)
    raw, _ = fused_render.mlp_plain(pack32, fused_mip._pe_config(model.cfg), x, x[:, fused_mip.VIEW_PANEL:],
                                    dtype=torch.float32)
    with torch.no_grad(), strict_fp32():
        rgb, dens = model(x[:, :96], x[:, 96:123])
    torch.testing.assert_close(raw, torch.cat([rgb, dens], -1), rtol=1e-5, atol=1e-5)
    got = fused_mip.render_mip_kernel(fused_mip.pack_mip(model), model.cfg, o, d, rad)
    want = reference(tree, cfg, (o, d, vd, rad))
    g = gaps({"rgb": got["rgb_map"], "depth": got["depth_map"], "acc": got["acc_map"]}, want)
    assert g["rgb_mse"] < 1e-6 and g["depth_gap"] < 3e-3 and g["acc_gap"] < 1e-3, g


def _mip_slice_formula():
    text = open(HEADER).read()
    m = re.search(r"inline int mip_forward_slices\(int D, unsigned skip_mask, bool (\w+)\) \{\s*return (.*?);",
                  text, re.S)
    flag, expr = m.group(1), " ".join(m.group(2).split())
    expr = expr.replace("popcount_u(skip_mask)", "n_skips")
    expr = re.sub(r"\((\w+) \? ([^:()]+) : ([^()]+)\)", r"((\2) if \1 else (\3))", expr)
    return lambda D, skip_mask, value: eval(expr, {}, {"D": D, "n_skips": bin(skip_mask).count("1"), flag: value})


def test_pack_layout_puts_ipe_and_view_columns_in_the_pe_panels():
    net = net_widths(W=256, S=128)
    tree = RM.glorot(11, net)
    model = load_raw(MipNeRF(MipNeRFConfig(**net)), tree)
    pack = fused_mip.pack_mip(model)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    L = tree["mlp"]
    assert pack["w0"].shape == (128, 256) and torch.equal(pack["w0"][:96], bf(L[0]["weight"]))
    assert not pack["w0"][96:].any()
    assert sorted(pack["skip_w"]) == [5] and torch.equal(pack["skip_w"][5][:96], bf(L[5]["weight"][256:]))
    assert not pack["skip_w"][5][96:].any() and torch.equal(pack["trunk_w"][4], bf(L[5]["weight"][:256]))
    assert pack["views_ws"].shape == (64, 128) and torch.equal(pack["views_ws"][32:59], bf(L[10]["weight"][256:]))
    assert not pack["views_ws"][:32].any() and not pack["views_ws"][59:].any()
    assert torch.equal(pack["feature_w"], bf(L[9]["weight"])) and torch.equal(pack["alpha_w"], bf(L[8]["weight"][:, 0]))
    full, sigma = fused_render.pack_slices(pack), fused_render.pack_slices(pack, sigma_only=True)
    count = _mip_slice_formula()
    assert full.shape[0] == count(8, 1 << 5, False) == 77 and sigma.shape[0] == count(8, 1 << 5, True) == 64
    assert torch.equal(full[:64], sigma)  # one image serves both levels: the first streams its prefix
    t = torch.linspace(2, 6, 129).expand(2, 129)
    gauss = cast_intervals(t, torch.zeros(2, 3), torch.ones(2, 3), torch.full((2, 1), 1e-3))
    rows = fused_mip.pe_rows(model.cfg, *gauss, torch.ones(2, 3))
    assert rows.shape == (256, 128) and not rows[:, 123:].any()
    torch.testing.assert_close(rows[:, 96:99], torch.full((256, 3), 3 ** -0.5).to(torch.bfloat16).float())


def test_no_integration_fails_the_cells_comparison():
    """mip-NeRF's disable_integration in K11's plain version (the IPE without
    the variances, the benchmark's ``no_integration``) pushes a compared
    number over the cell's limit and ten times the sound run's."""
    limits = json.load(open(WORKLOAD))["limits"]
    tree, cfg, model, (o, d, vd, rad) = scene(W=64, S=16)
    pack = fused_mip.pack_mip(model)
    want = reference(tree, cfg, (o, d, vd, rad))

    def run(cfg):
        got = fused_mip.render_mip_kernel(pack, cfg, o, d, rad)
        return gaps({"rgb": got["rgb_map"], "depth": got["depth_map"], "acc": got["acc_map"]}, want)

    sound, fault = run(model.cfg), run(dataclasses.replace(model.cfg, disable_integration=True))
    assert all(sound[n] <= lim for n, lim in limits.items()), sound
    assert any(fault[n] > lim and fault[n] > 10 * sound[n] for n, lim in limits.items()), (fault, sound)
    ref_fault = reference(tree, cfg, (o, d, vd, rad), disable_integration=True)
    assert float((ref_fault["rgb"] - want["rgb"]).abs().max()) > 1e-2


def test_the_envelope_raises():
    tree, cfg, model, (o, d, vd, rad) = scene()
    params = NeRFParams(coarse=model)
    pipe = Pipeline(nerf=model.cfg, mlp_impl="plain")
    with pytest.raises(ValueError, match="FULL_NERF"):
        render_flat_rays(pipe, params, o, d, mode=EvalMode.DEPTH_NET, radii=rad)
    with pytest.raises(ValueError, match="radius"):
        render_flat_rays(pipe, params, o, d, mode=EvalMode.FULL_NERF)
    with pytest.raises(ValueError, match="per-sample"):
        render_flat_rays(pipe, params, o, d, mode=EvalMode.FULL_NERF, radii=rad, full_outputs=True)
    with pytest.raises(ValueError, match="plain' or 'cuda'"):
        Pipeline(nerf=model.cfg, mlp_impl="cuda_int8")
    with pytest.raises(ValueError, match="256"):
        fused_mip.check_mip_kernel(model.cfg)
    fused_mip.check_mip_kernel(MipNeRFConfig())


def test_render_path_renders_a_mip_pipeline(tmp_path):
    """The render CLI's render_path over two poses: PNGs, PSNR and
    disparities from a mip-NeRF Pipeline, as from the other modes."""
    tree, cfg, model, _ = scene()
    pipe = Pipeline(nerf=model.cfg, near=2.0, far=6.0, white_bkgd=True, mlp_impl="cuda")
    params = pack_kernel_weights(NeRFParams(coarse=model))
    poses = np.stack([pose(10.0), pose(200.0)])
    gt = np.ones((2, SIZE, SIZE, 3), np.float32)
    rgbs, disps, psnr = render_path(pipe, params, poses, (SIZE, SIZE, float(FOCAL)), K, device="cpu",
                                    mode=EvalMode.FULL_NERF, gt_imgs=gt, savedir=str(tmp_path), verbose=False)
    assert rgbs.shape == (2, SIZE, SIZE, 3) and disps.shape == (2, SIZE, SIZE) and np.isfinite(psnr)
    assert sorted(os.listdir(tmp_path)) == ["000.png", "001.png", "psnr.txt"]
