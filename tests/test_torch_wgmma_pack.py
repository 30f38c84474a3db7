"""The weight slices of the wgmma MLP core (csrc/mlp_wgmma.cuh), on CPU.

``fused_render.wgmma_slices`` writes the byte image of every shared-memory
slice the kernels' producer warp bulk-copies: 128 output columns x 64 of
depth, 128-byte swizzled, K-major. The card reads that image blind, so these
tests hold it here: unpacked by an index formula of their own, the slices
give back every matrix of K6/K7's and K5's programs exactly, forward and
transposed; their count and byte size are what the kernel header reads; an
emulation of the kernel's forward over the unpacked slices agrees with the
plain MLP; and ``pack_nerf``'s layout, which the other kernels read, is
unchanged.

The bf16 render kernels (K2, K3, K8, K9) take a pack's full-forward slices
after their outputs (``pack_args``): the slices cached in the pack (``pack_slices``) are
kept apart per program, follow a re-pack of new weights, reach every
launch (bf16, fp32 and int8 packs, each its own image), and, run through
the emulated forward and composited as K2 and K3 composite, give the plain
versions' maps.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from nerf_sampling_tpu_torch.kernels import fused_render as fr
from nerf_sampling_tpu_torch.kernels import quant
from nerf_sampling_tpu_torch.kernels.fused_nerf import point_embeddings
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.render import NeRFParams, pack_kernel_weights

HEADER = os.path.join(os.path.dirname(fr.__file__), "csrc", "mlp_wgmma.cuh")
W = 256


def small_nerf(D: int = 4, skips=(1,), seed: int = 0) -> NeRF:
    """A W=256 NeRF (the width the kernels take) with seeded weights."""
    model = NeRF(NeRFConfig(D=D, W=W, input_ch=63, input_ch_views=27, skips=skips, use_viewdirs=True))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)))
    return model


def unpack(image: torch.Tensor, program) -> list[torch.Tensor]:
    """Each product's B ([K, N]: W, or W^T when transposed) from the slices,
    walked as the kernel walks them: k panels outer, 128-column halves
    inner; element (n, k) of a slice at n*64 + ((k//8) ^ (n%8))*8 + k%8."""
    img = image.float().numpy().reshape(-1, 128, 64)
    n = np.arange(128)[:, None]
    chunk = np.arange(64)[None, :] // 8
    logical_k = ((chunk ^ (n % 8)) * 8 + np.arange(64)[None, :] % 8)
    s, out = 0, []
    for w, transposed in program:
        K, N = (w.shape[1], w.shape[0]) if transposed else tuple(w.shape)
        kp_n, h_n = -(-K // 64), -(-N // 128)
        B = np.zeros((kp_n * 64, h_n * 128), np.float32)
        for kp in range(kp_n):
            for h in range(h_n):
                tile = np.zeros((64, 128), np.float32)  # [k, n]
                tile[logical_k, n] = img[s]
                B[kp * 64:(kp + 1) * 64, h * 128:(h + 1) * 128] = tile
                s += 1
        assert not B[K:].any() and not B[:, N:].any(), "padding of a slice is not zero"
        out.append(torch.from_numpy(B[:K, :N]))
    assert s == img.shape[0], "slices left over"
    return out


@pytest.mark.parametrize("kw", [dict(sigma_only=True), dict(), dict(backward=True),
                                dict(backward=True, want_dx=True)],
                         ids=["sigma_only", "forward", "backward", "backward_dx"])
def test_slices_unpack_to_every_matrix(kw):
    packed = fr.pack_nerf(small_nerf())
    program = fr.wgmma_program(packed, **kw)
    image = fr.wgmma_slices(program)
    assert image.dtype == torch.bfloat16 and image.shape[1] == 128 * 64
    for (w, transposed), B in zip(program, unpack(image, program)):
        want = w.float().T if transposed else w.float()
        assert torch.equal(B, want)


def test_program_names_every_matrix_in_kernel_order():
    """K5's row pass (nerf_points_bwd.cu): the forward, then d_zv16's two
    products, then down the trunk d_z16_i = mask_i * (x @ next^T), each
    followed at a skip layer and at layer 0 by its dL/dPE product."""
    packed = fr.pack_nerf(small_nerf(D=4, skips=(1,)))
    prog = fr.wgmma_program(packed, backward=True, want_dx=True)
    names = {id(v): k for k, v in packed.items() if isinstance(v, torch.Tensor)}
    names.update({id(w): f"trunk_w{i + 1}" for i, w in enumerate(packed["trunk_w"])})
    names.update({id(w): f"skip_w{i}" for i, w in packed["skip_w"].items()})
    got = [names[id(w)] + ("^T" if t else "") for w, t in prog]
    assert got == ["w0", "trunk_w1", "trunk_w2", "skip_w2", "trunk_w3", "feature_w", "views_wf", "views_ws",
                   "views_ws^T", "views_wf^T", "feature_w^T", "trunk_w3^T", "skip_w2^T", "trunk_w2^T",
                   "trunk_w1^T", "w0^T"]


def _header_formula(name: str):
    """forward_slices / backward_slices of mlp_wgmma.cuh as a Python function."""
    text = open(HEADER).read()
    m = re.search(rf"inline int {name}\(int D, unsigned skip_mask, bool (\w+)\) \{{\s*return (.*?);", text, re.S)
    flag, expr = m.group(1), " ".join(m.group(2).split())
    expr = expr.replace("popcount_u(skip_mask)", "n_skips")
    expr = re.sub(r"\((\w+) \? ([^:()]+) : ([^()]+)\)", r"((\2) if \1 else (\3))", expr)
    return lambda D, skip_mask, value: eval(expr, {}, {"D": D, "n_skips": bin(skip_mask).count("1"), flag: value})


@pytest.mark.parametrize("D,skips", [(1, ()), (4, (1,)), (8, (4,)), (8, (2, 5))])
def test_slice_counts_and_sizes_match_the_kernel_header(D, skips):
    fwd, bwd = _header_formula("forward_slices"), _header_formula("backward_slices")
    packed = fr.pack_nerf(small_nerf(D=D, skips=skips))
    mask = sum(1 << i for i in packed["skip_w"])
    for sigma_only in (True, False):
        n = fr.wgmma_slices(fr.wgmma_program(packed, sigma_only=sigma_only)).shape[0]
        assert n == fwd(D, mask, sigma_only)
    for want_dx in (False, True):
        n = fr.wgmma_slices(fr.wgmma_program(packed, backward=True, want_dx=want_dx)).shape[0]
        assert n == fwd(D, mask, False) + bwd(D, mask, want_dx)
    text = open(HEADER).read()
    slice_bytes = eval(re.search(r"kSliceBytes = ([\d *]+);", text).group(1))
    assert slice_bytes == fr.WG_SLICE_N * fr.WG_SLICE_K * 2 == 16384
    # every slice, ring stage and tile panel, and warpgroup 1's half of a
    # panel, starts on the 1024 bytes over which the swizzle repeats
    rows = int(re.search(r"kRows = (\d+);", text).group(1))
    panel = eval(re.search(r"kPanelBytes = ([\w *]+);", text).group(1), {}, {"kRows": rows})
    assert rows == 128 and panel == rows * 128
    assert slice_bytes % 1024 == 0 and panel % 1024 == 0 and (panel // 2) % 1024 == 0


def emulated_forward(packed: dict, slices: torch.Tensor, x_pts: torch.Tensor, x_v: torch.Tensor) -> torch.Tensor:
    """The kernel's forward (nerf_forward in mlp_wgmma.cuh) written over
    the unpacked full-forward ``slices`` of ``packed``: PE panel 0 then the
    activation tile, the skip rows as a second product into the same sums,
    the views layer reading PE panel 1 through the zero-padded views_ws
    slice; raw [M, 4] (rgb logits, sigma)."""
    program = fr.wgmma_program(packed)
    Bs = iter(unpack(slices, program))
    M = x_pts.shape[0]
    pe0 = torch.cat([x_pts, torch.zeros(M, 1)], 1)  # [pts emb 63 | 0]
    pe1 = torch.cat([x_v, torch.zeros(M, 5)], 1)  # [view emb 27 | 0 x 5]: the 32 rows views_ws has

    def rnd(z):
        return z.to(torch.bfloat16).float()

    h = rnd(torch.relu(pe0 @ next(Bs) + packed["trunk_b"][0]))
    for i in range(1, len(packed["trunk_b"])):
        z = h @ next(Bs)
        if i in packed["skip_w"]:
            z = z + pe0 @ next(Bs)
        h = rnd(torch.relu(z + packed["trunk_b"][i]))
    sigma = h @ packed["alpha_w"].float() + packed["alpha_b"]
    feature = rnd(h @ next(Bs) + packed["feature_b"])
    hv = rnd(torch.relu(feature @ next(Bs) + pe1 @ next(Bs) + packed["views_b"]))
    rgb = hv @ packed["rgb_w"].float().T + packed["rgb_b"]
    return torch.cat([rgb, sigma[:, None]], -1)


def test_emulated_forward_over_the_slices_matches_mlp_plain():
    model = small_nerf(D=4, skips=(1,))
    packed = fr.pack_nerf(model)
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (96, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(96, 3)).astype(np.float32)), dim=-1)
    x_pts, x_v = point_embeddings(pts, dirs, 10, 4, torch.bfloat16)
    got = emulated_forward(packed, fr.wgmma_slices(fr.wgmma_program(packed)), x_pts, x_v)
    want, _ = fr.mlp_plain(packed, model.cfg, x_pts, x_v, torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# --- the render kernels' slices (K2, K3, K8, K9 in bf16) ---------------------------------------


def header_count(D: int, skips, sigma_only: bool = False) -> int:
    return _header_formula("forward_slices")(D, sum(1 << i for i in skips), sigma_only)


@pytest.mark.parametrize("D,skips", [(8, (4,)), (4, (1,))], ids=["production", "small"])
def test_render_launch_takes_the_full_forward_slices(D, skips):
    """What a bf16 render launch hands the kernel after its outputs: one
    image of the full forward, as many slices as the header's
    forward_slices(D, skip_mask, false) reads, unpacking to every matrix,
    made once and kept in the pack."""
    model = small_nerf(D=D, skips=skips)
    packed = fr.pack_nerf(model)
    image = fr.pack_args(packed, model.cfg).slices
    assert image.shape == (header_count(D, skips), fr.WG_SLICE_N * fr.WG_SLICE_K)
    program = fr.wgmma_program(packed)
    for (w, _), B in zip(program, unpack(image, program)):
        assert torch.equal(B, w.float())
    assert fr.pack_args(packed, model.cfg).slices is image


@pytest.mark.parametrize("first", ["sigma_only", "full"])
def test_slice_cache_keeps_each_program_apart(first):
    """One pack asked for both programs, in either order, keeps both: the
    sigma-only image (K6/K7's coarse pass) and the full one (the render
    kernels, K6/K7's fine pass) have their own counts and contents."""
    packed = fr.pack_nerf(small_nerf(D=8, skips=(4,)))
    order = (True, False) if first == "sigma_only" else (False, True)
    got = {so: fr.pack_slices(packed, sigma_only=so) for so in order}
    for so in (True, False):
        assert got[so].shape[0] == header_count(8, (4,), so)
        assert torch.equal(got[so], fr.wgmma_slices(fr.wgmma_program(packed, sigma_only=so)))
        assert fr.pack_slices(packed, sigma_only=so) is got[so]
    assert got[True].shape[0] < got[False].shape[0]


def test_slices_follow_a_repack_of_new_weights():
    """The Trainer re-packs before an eval (pack_kernel_weights on params
    without kernels): the new packs' slices are the new weights', in the
    render pack and in both nets of the hier pack."""
    coarse, fine = small_nerf(D=4, skips=(1,), seed=3), small_nerf(D=4, skips=(1,), seed=4)
    params = pack_kernel_weights(NeRFParams(coarse, fine), with_hier=True)
    old = fr.pack_args(params.kernels.nerf, fine.cfg).slices.clone()
    fr.pack_slices(params.kernels.hier["coarse"], sigma_only=True)
    fr.pack_slices(params.kernels.hier["fine"])
    with torch.no_grad():
        for m in (coarse, fine):
            for p in m.parameters():
                p.mul_(-0.5)
    params = pack_kernel_weights(params._replace(kernels=None), with_hier=True)
    new = fr.pack_args(params.kernels.nerf, fine.cfg).slices
    assert torch.equal(new, fr.wgmma_slices(fr.wgmma_program(fr.pack_nerf(fine))))
    assert not torch.equal(new, old)
    hier = params.kernels.hier
    assert torch.equal(fr.pack_slices(hier["coarse"], sigma_only=True),
                       fr.wgmma_slices(fr.wgmma_program(fr.pack_nerf(coarse), sigma_only=True)))
    assert torch.equal(fr.pack_slices(hier["fine"]), new)


@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8"])
def test_only_bf16_launches_take_slices(kind):
    """Every render kernel runs the wgmma core and takes its pack's slices:
    bf16 images, the fp32 path's hi and lo (COMPARE), or for the int8 (K10)
    kernel the int8 program's byte image (bf16 and s8 slices), kept in the
    pack."""
    model = small_nerf(D=4, skips=(1,))
    if kind == "int8":
        rng = np.random.default_rng(2)
        ro = torch.tensor([[0.0, 0.0, 4.0]]).repeat(64, 1)
        rd = torch.from_numpy((rng.normal(size=(64, 3)) * 0.2).astype(np.float32))
        rd[:, 2] = -1.0
        packed = quant.qpack_nerf(model, quant.calibrate_nerf_quant(model, ro, rd, n_rays=64, n_z=9))
    else:
        packed = fr.pack_nerf(model, torch.float32 if kind == "fp32" else torch.bfloat16)
    image = fr.pack_args(packed, model.cfg, dtype=torch.float32 if kind == "fp32" else torch.bfloat16).slices
    if kind == "bf16":
        assert torch.equal(image, fr.wgmma_slices(fr.wgmma_program(packed)))
    elif kind == "fp32":
        assert torch.equal(image, fr.wgmma_slices32(fr.wgmma_program(packed)))
    else:
        assert torch.equal(image, fr.wgmma_qslices(fr.wgmma_qprogram(packed)))
        assert image is packed["wg_slices"]["full"]


def composite_in_order(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor) -> dict[str, torch.Tensor]:
    """K2's compositing as the kernel runs it: one ray's samples in order,
    a running transmittance, a white background."""
    dn = torch.sqrt((rays_d * rays_d).sum(-1))
    n, S = z.shape
    T = torch.ones(n)
    acc, dep, c = torch.zeros(n), torch.zeros(n), torch.zeros(n, 3)
    rgb = torch.sigmoid(raw[..., :3])
    for s in range(S):
        dist = ((z[:, s + 1] - z[:, s]) if s < S - 1 else torch.full((n,), 1e10)) * dn
        alpha = 1.0 - torch.exp(-torch.relu(raw[:, s, 3]) * dist)
        w = alpha * T
        acc, dep, c = acc + w, dep + w * z[:, s], c + w[:, None] * rgb[:, s]
        T = T * (1.0 - alpha + 1e-10)
    q = dep / (acc + 1e-10)
    disp = 1.0 / torch.where(q < 1e-10, torch.full_like(q, 1e-10), q)
    return {"rgb_map": c + (1.0 - acc)[:, None], "disp_map": disp, "acc_map": acc, "depth_map": dep}


def rank_sort(v: np.ndarray) -> np.ndarray:
    """nerf_mlp.cuh::sort_rows: each element's rank in its ray, ascending,
    NaN last, ties by index."""
    out = np.empty_like(v)
    for r in range(v.shape[0]):
        for i, a in enumerate(v[r]):
            def before(b, j):
                if np.isnan(a) or np.isnan(b):
                    return np.isnan(a) and (not np.isnan(b) or j < i)
                return b < a or (b == a and j < i)
            out[r, sum(before(b, j) for j, b in enumerate(v[r]))] = a
    return out


@pytest.mark.parametrize("population", ["uniform", "gaussian"])
def test_emulated_render_over_the_slices_matches_the_plain_version(population):
    """K2 (uniform, clipped to [2, 6]) and K3 (gaussian with injected noise,
    rank-sorted) written as the bf16 kernel runs them: the population, the
    fp32 PE of o + d*z, the forward over the pack's launch slices and the
    in-order compositing give the plain versions' maps at bf16, NaN where
    the depth is NaN."""
    model = small_nerf(D=4, skips=(1,), seed=5)
    packed = fr.pack_nerf(model)
    rng = np.random.default_rng(6)
    n, S, std = 12, 16, 0.5
    ro = torch.tensor([[0.0, 0.0, 4.0]]).repeat(n, 1)
    rd = torch.from_numpy((rng.normal(size=(n, 3)) * 0.3).astype(np.float32))
    rd[:, 2] = -1.0
    depth = torch.from_numpy(rng.uniform(3.0, 5.0, n).astype(np.float32))
    depth[5] = float("nan")
    if population == "uniform":
        offsets = torch.from_numpy(fr.uniform_population_offsets(S, 1.0))
        v = depth[:, None] + offsets[None, :]
        z = torch.where(torch.isnan(v), v, v.clamp(2.0, 6.0))
        want = fr.render_around_depth_plain(packed, model.cfg, ro, rd, depth, offsets, dtype=torch.bfloat16)
    else:
        noise = torch.from_numpy(rng.normal(size=(n, S - 1)).astype(np.float32))
        v = torch.cat([depth[:, None] + std * noise, depth[:, None]], 1)
        z = torch.from_numpy(rank_sort(v.numpy()))
        want = fr.render_gaussian_plain(packed, model.cfg, ro, rd, depth, noise, std=std, dtype=torch.bfloat16)
    pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = rd / torch.sqrt((rd * rd).sum(-1, keepdim=True))
    x_pts, x_v = point_embeddings(pts, dirs, 10, 4, torch.bfloat16)
    raw = emulated_forward(packed, fr.pack_args(packed, model.cfg).slices, x_pts, x_v).reshape(n, S, 4)
    got = composite_in_order(raw, z, rd)
    ok = ~torch.isnan(depth)
    assert float(want["acc_map"][ok].mean()) > 0.1  # a field with density: the maps say something
    for name in ("rgb_map", "acc_map", "depth_map", "disp_map"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5, equal_nan=True)
        assert bool(torch.isnan(got[name]).reshape(n, -1).all(1).eq(~ok).all()), name


def test_pack_nerf_layout_is_unchanged():
    """pack_nerf's [in, out] layout, which K1-K4, K8, K9 and the fp32/int8
    kernels read, is what it was; making slices leaves a pack as it is."""
    model = small_nerf(D=8, skips=(4,))
    packed = fr.pack_nerf(model)
    shapes = {k: tuple(v.shape) for k, v in packed.items() if isinstance(v, torch.Tensor)}
    assert shapes == {"w0": (64, W), "feature_w": (W, W), "feature_b": (W,), "alpha_w": (W,), "alpha_b": (1,),
                      "views_wf": (W, W // 2), "views_ws": (32, W // 2), "views_b": (W // 2,),
                      "rgb_w": (3, W // 2), "rgb_b": (3,)}
    assert [tuple(w.shape) for w in packed["trunk_w"]] == [(W, W)] * 7
    assert [tuple(b.shape) for b in packed["trunk_b"]] == [(W,)] * 8
    assert {i: tuple(w.shape) for i, w in packed["skip_w"].items()} == {5: (64, W)}
    lin = model.pts_linears
    assert torch.equal(packed["trunk_w"][0], lin[1].weight.detach().T.bfloat16())
    assert torch.equal(packed["skip_w"][5][:63], lin[5].weight.detach().T[:63].bfloat16())
    assert torch.equal(packed["trunk_w"][4], lin[5].weight.detach().T[63:].bfloat16())
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in packed.items()}
    fr.wgmma_slices(fr.wgmma_program(packed, backward=True, want_dx=True))
    assert packed.keys() == before.keys()
    for k, v in before.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(packed[k], v)


@pytest.mark.parametrize("K,N,skip", [(64, 256, False), (256, 128, True)])
def test_wgmma_dense_plain_version_on_cpu(K, N, skip):
    g = torch.Generator().manual_seed(2)
    a = torch.randn(40, K, generator=g).bfloat16()
    w = (torch.randn(K, N, generator=g) / 8).bfloat16()
    b = torch.randn(N, generator=g)
    a2 = torch.randn(40, 64, generator=g).bfloat16() if skip else None
    w2 = (torch.randn(64, N, generator=g) / 8).bfloat16() if skip else None
    got = fr.wgmma_dense(a, w, b, a2=a2, w2=w2)
    want = a.float() @ w.float() + b + (a2.float() @ w2.float() if skip else 0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.relu(want).bfloat16())
    with pytest.raises(ValueError, match="together"):
        fr.wgmma_dense(a, w, b, a2=a2 if skip else a[:, :64])
