"""The int8 program of the wgmma MLP core (csrc/mlp_wgmma.cuh), on CPU.

K6 and K7 in int8 (K10, W8A8) run the wgmma core with s8 products. The
card reads the host's byte image of their weight slices blind, so these
tests hold it here:

- ``fused_render.wgmma_qslices`` unpacked by an inverse formula of the
  test's own (the byte at (n, b) of an int8 slice holds depth ((b // 16) ^
  (n % 8)) * 16 + b % 16, of a bf16 slice's element e ((e // 8) ^ (n % 8))
  * 8 + e % 8) gives back every matrix of the program exactly, the halves
  of the skip layers included, with zero padding;
- ``wgmma_qprogram`` names the matrices in the order the kernel's int8
  forward consumes them, and the slice counts are the header's
  ``forward_qslices`` (parsed from the header);
- a forward written over the unpacked slices as the kernel runs it (int64
  products of the int8 bytes, ``kernels/quant.py``'s requants, the skip and
  views layers as an int32 and an fp32 sum merged per 128-column half)
  gives ``mlp_plain_q``'s int8 activations bit for bit; sigma and rgb within
  1e-5 of the largest |raw| (the same fp32 products, summed in one order);
- both match JAX's ``mlp_forward_affine_q`` on the same numpy inputs within
  1e-5 of the largest |raw| (``tests/test_torch_quant.py``'s bound, where
  its measurement reads equal);
- an int8 hierarchical launch, against a mocked library, hands the kernel
  both int8 packs' slices after its outputs: the coarse net's sigma-only
  image, then the fine net's full one, then both packs' epilogue vectors;
  an int8 K2, K3, K8 or K9 launch hands its pack's full image, and one
  whose pack holds another program's slices is refused before the call;
- the [core] check's s8 layer (``wgmma_dense_q``) on CPU is the int64
  product.

The kernel runs only on the card: ``chip_smoke.py`` holds it there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant import jax_s_matrix, nerf_pair, rays_np, to_jax
from test_torch_wgmma_pack import _header_formula, small_nerf

from nerf_sampling_tpu.kernels import quant as jquant
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_hier as k67
from nerf_sampling_tpu_torch.kernels import fused_render as fr
from nerf_sampling_tpu_torch.kernels import quant

RAW_TOL = 1e-5  # of the largest |raw|: sigma and rgb logits, fp32 sums in other orders


def qpack(model, seed: int = 0):
    """An int8 pack of ``model`` calibrated on 64 seeded rays."""
    ro, rd = rays_np(64, np.random.default_rng(seed))
    calib = quant.calibrate_nerf_quant(model, torch.from_numpy(ro), torch.from_numpy(rd), n_rays=64, n_z=9)
    return quant.qpack_nerf(model, calib)


def unpack_q(image: torch.Tensor, program) -> list[torch.Tensor]:
    """Each entry's B ([K, N], or its 128 columns of ``half``) from the
    slices, walked as the kernel walks them: k panels outer, halves inner;
    the storage position of each element turned back into its depth."""
    img = image.numpy()
    assert img.dtype == np.uint8 and img.shape[1] == 16384
    n = np.arange(128)[:, None]
    s, out = 0, []
    for w, transposed, half in program:
        int8 = w.dtype == torch.int8
        K, N = (w.shape[1], w.shape[0]) if transposed else tuple(w.shape)
        depth = 128 if int8 else 64
        halves = range(-(-N // 128)) if half is None else (half,)
        B = np.zeros((-(-K // depth) * depth, 128 * len(halves)), np.float64)
        for kp in range(-(-K // depth)):
            for j, _ in enumerate(halves):
                raw = img[s]
                s += 1
                if int8:
                    vals = raw.view(np.int8).reshape(128, 128)
                    b = np.arange(128)[None, :]
                    k = ((b // 16) ^ (n % 8)) * 16 + b % 16
                else:
                    vals = torch.from_numpy(raw.copy()).view(torch.bfloat16).float().numpy().reshape(128, 64)
                    e = np.arange(64)[None, :]
                    k = ((e // 8) ^ (n % 8)) * 8 + e % 8
                tile = np.zeros((depth, 128))
                tile[k, np.broadcast_to(n, k.shape)] = vals
                B[kp * depth:(kp + 1) * depth, 128 * j:128 * (j + 1)] = tile
        width = N if half is None else 128
        assert not B[K:].any() and not B[:, width:].any(), "padding of a slice is not zero"
        out.append(torch.from_numpy(B[:K, :width]))
    assert s == img.shape[0], "slices left over"
    return out


def want_matrix(w: torch.Tensor, transposed: bool, half) -> torch.Tensor:
    B = w.double().T if transposed else w.double()
    return B if half is None else B[:, 128 * half:128 * (half + 1)]


@pytest.mark.parametrize("sigma_only", [True, False], ids=["sigma_only", "full"])
@pytest.mark.parametrize("D,skips", [(4, (1,)), (8, (4,))], ids=["small", "production"])
def test_qslices_unpack_to_every_matrix(D, skips, sigma_only):
    packed = qpack(small_nerf(D=D, skips=skips, seed=D))
    program = fr.wgmma_qprogram(packed, sigma_only=sigma_only)
    image = fr.wgmma_qslices(program)
    assert image.dtype == torch.uint8 and image.shape[1] == fr.WG_SLICE_BYTES == 16384
    for (w, transposed, half), B in zip(program, unpack_q(image, program)):
        assert torch.equal(B, want_matrix(w, transposed, half))


def test_qprogram_names_every_matrix_in_kernel_order():
    """Layer 0's bf16 w0; the int8 trunk matrices [out, in] (x @ W^T); at
    the skip layer per 128-column half its int8 half, then skip_w's half;
    the feature and views layers' int8 matrices, then views_ws in bf16."""
    packed = qpack(small_nerf(D=4, skips=(1,)))
    names = {id(v): k for k, v in packed.items() if isinstance(v, torch.Tensor)}
    names.update({id(w): f"trunk_wq{i + 1}" for i, w in enumerate(packed["trunk_wq"])})
    names.update({id(w): f"skip_w{i}" for i, w in packed["skip_w"].items()})

    def named(prog):
        return [names[id(w)] + ("^T" if t else "") + ("" if h is None else f"[h{h}]") for w, t, h in prog]

    full = named(fr.wgmma_qprogram(packed))
    assert full == ["w0", "trunk_wq1^T", "trunk_wq2^T[h0]", "skip_w2[h0]", "trunk_wq2^T[h1]", "skip_w2[h1]",
                    "trunk_wq3^T", "feature_wq^T", "views_wq^T", "views_ws"]
    assert named(fr.wgmma_qprogram(packed, sigma_only=True)) == full[:7]
    kinds = [w.dtype for w, _, _ in fr.wgmma_qprogram(packed)]
    assert kinds == [torch.bfloat16, torch.int8, torch.int8, torch.bfloat16, torch.int8, torch.bfloat16,
                     torch.int8, torch.int8, torch.int8, torch.bfloat16]


@pytest.mark.parametrize("D,skips", [(1, ()), (4, (1,)), (8, (4,)), (8, (2, 5))])
def test_qslice_counts_match_the_kernel_header(D, skips):
    fwd = _header_formula("forward_qslices")
    packed = qpack(small_nerf(D=D, skips=skips))
    mask = sum(1 << i for i in packed["skip_w"])
    for sigma_only in (True, False):
        n = fr.wgmma_qslices(fr.wgmma_qprogram(packed, sigma_only=sigma_only)).shape[0]
        assert n == fwd(D, mask, sigma_only)
    # the production coarse pass (D 8, one skip): half the bf16 program's slices
    if (D, skips) == (8, (4,)):
        bf16 = fr.wgmma_slices(fr.wgmma_program(fr.pack_nerf(small_nerf(D=D, skips=skips)), sigma_only=True))
        assert (fwd(D, mask, True), bf16.shape[0]) == (32, 60)


def test_int8_pack_slices_are_cached_per_program():
    model = small_nerf(D=8, skips=(4,))
    packed = qpack(model)
    so, full = fr.pack_slices(packed, sigma_only=True), fr.pack_slices(packed)
    assert fr.pack_slices(packed, sigma_only=True) is so and fr.pack_slices(packed) is full
    assert torch.equal(full, fr.wgmma_qslices(fr.wgmma_qprogram(packed)))
    assert torch.equal(so, fr.wgmma_qslices(fr.wgmma_qprogram(packed, sigma_only=True)))
    assert torch.equal(full[:so.shape[0]], so)  # the sigma-only program is the full one's head
    assert fr.pack_args(packed, model.cfg).slices is full  # the int8 render kernels take the full forward's image


def emulated_qforward(packed: dict, slices: torch.Tensor, x_pts: torch.Tensor, x_v: torch.Tensor | None,
                      sigma_only: bool = False, acts: list | None = None) -> torch.Tensor:
    """The kernel's int8 forward (mlp_wgmma.cuh, nerf_forward on
    NerfWeightsQ) over the unpacked ``slices`` of ``packed``: the int8
    products as int64 matmuls of the slices' bytes, the bf16 products in
    fp32 on the PE rows, the skip layer half by half (int32 sums * sw + the
    PE product + b, rounded step by step, relu, requant), the views layer
    the same way, then relu, bf16 and the rgb head; ``acts`` gets the int8
    activations."""
    program = fr.wgmma_qprogram(packed, sigma_only=sigma_only)
    Bs = iter(unpack_q(slices, program))
    calib = packed["calib"]
    acts = [] if acts is None else acts
    Cp = x_pts.shape[1]

    def mm_q(h, B):  # int8 values x int8 bytes, exact
        return (h.long() @ B.long()).double()

    def mm_f(x, B):  # the bf16 product on the PE rows (the padding rows are zero)
        return x @ B[:x.shape[1]].float()

    hq = quant._requant_fp32(torch.relu(mm_f(x_pts, next(Bs)) + packed["b0"]), 1.0 / calib.sh0)
    acts.append(hq)
    for i in range(1, len(packed["trunk_wq"]) + 1):
        step = calib.steps[i - 1]
        row = packed["trunk_row"][i - 1]
        if step[0] == "skip":
            halves = []
            for h in (0, 1):
                z, zf = mm_q(hq, next(Bs)).float(), mm_f(x_pts, next(Bs))
                cols = slice(128 * h, 128 * (h + 1))
                halves.append(z * row[cols] + zf + packed["skip_b"][i][cols])
            hq = quant._requant_fp32(torch.relu(torch.cat(halves, 1)), step[1])
        else:
            hq = quant._requant_int(torch.clamp(mm_q(hq, next(Bs)).long() + row.long(), min=0), step, 0)
        acts.append(hq)
    sigma = hq @ packed["alpha_w"].float() + packed["alpha_b"]
    if sigma_only:
        return sigma
    fq = quant._requant_int(mm_q(hq, next(Bs)).long() + packed["feature_bz"].long(), calib.feat, -127)
    acts.append(fq)
    zv = mm_q(fq, next(Bs)).float() * packed["views_sw"] + mm_f(x_v, next(Bs)) + packed["views_b"]
    hv = torch.relu(zv).to(torch.bfloat16).float()
    rgb = hv @ packed["rgb_w"].float().T + packed["rgb_b"]
    assert next(Bs, None) is None
    return torch.cat([rgb, sigma[:, None]], -1)


def embeddings(n_rays: int, seed: int):
    """bf16-rounded embeddings of n_rays x 16 points along seeded rays
    into the field, and of their directions."""
    ro, rd = rays_np(n_rays, np.random.default_rng(seed))
    z = np.linspace(2.5, 5.5, 16, dtype=np.float32)
    pts = (ro[:, None] + z[None, :, None] * rd[:, None]).reshape(-1, 3)
    dirs = np.repeat(rd / np.linalg.norm(rd, axis=1, keepdims=True), 16, 0)
    x_pts = positional_encoding(torch.from_numpy(pts), 10).to(torch.bfloat16).float()
    x_v = positional_encoding(torch.from_numpy(dirs), 4).to(torch.bfloat16).float()
    return x_pts, x_v


@pytest.mark.parametrize("sigma_only", [True, False], ids=["sigma_only", "full"])
@pytest.mark.parametrize("D,skips", [(4, (1,)), (8, (4,))], ids=["small", "production"])
def test_emulated_int8_forward_over_the_slices_matches_mlp_plain_q(D, skips, sigma_only):
    model = small_nerf(D=D, skips=skips, seed=7)
    packed = qpack(model, seed=8)
    x_pts, x_v = embeddings(24, seed=9)
    got_acts, want_acts = [], []
    got = emulated_qforward(packed, fr.pack_slices(packed, sigma_only), x_pts, x_v, sigma_only, got_acts)
    want = quant.mlp_plain_q(packed, model.cfg, x_pts, x_v, sigma_only, acts=want_acts)
    assert len(got_acts) == len(want_acts) == D + (0 if sigma_only else 1)
    for i, (g, w) in enumerate(zip(got_acts, want_acts)):
        assert torch.equal(g, w), f"int8 activation {i}"
        assert float(w.abs().max()) > 10  # the layer uses its int8 range
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=RAW_TOL * scale)


@pytest.mark.parametrize("heads", ["full", "sigma"])
def test_int8_forward_and_plain_version_match_jax(heads):
    """The emulated kernel forward and mlp_plain_q against JAX's
    mlp_forward_affine_q at the kernels' width, on the same numpy inputs
    (the port's embeddings in JAX's S layout)."""
    jp, jcfg, model = nerf_pair(3, D=4, W=256, skips=(1,))
    ro, rd = rays_np(64, np.random.default_rng(4))
    calib = quant.calibrate_nerf_quant(model, torch.from_numpy(ro), torch.from_numpy(rd), n_rays=64, n_z=9)
    packed = quant.qpack_nerf(model, calib)
    x_pts, x_v = embeddings(16, seed=5)
    jc = to_jax(calib)
    w = jquant.unpack_qwrefs(jcfg, jquant.flatten_qpacked(jquant.qpack_nerf_params(jp, jcfg, jc)), jc)
    want = np.asarray(jquant.mlp_forward_affine_q(jcfg, jnp.bfloat16, jax_s_matrix(x_pts.numpy(), x_v.numpy()),
                                                  w, heads=heads))
    sigma_only = heads == "sigma"
    if sigma_only:
        want = want[:, 3]
    scale = np.abs(want).max()
    assert scale > 1.0  # a real field
    emu = emulated_qforward(packed, fr.pack_slices(packed, sigma_only), x_pts, x_v, sigma_only)
    plain = quant.mlp_plain_q(packed, model.cfg, x_pts, x_v, sigma_only)
    for got in (emu, plain):
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=RAW_TOL * scale)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("seeded", [True, False], ids=["K6", "K7"])
def test_hier_launch_passes_both_packs_slices(monkeypatch, kind, seeded):
    """What render_hier_kernel hands nst_render_hier, against a mocked
    library: rays_o, rays_d, draws (null), out, the coarse net's sigma-only
    slices and the fine net's full ones (int8: wgmma_qslices' images, as
    many as the header's forward_qslices reads), then the coarse net's
    sigma-only epilogue vectors and the fine net's, and the int8 plans."""
    coarse, fine = small_nerf(D=4, skips=(1,), seed=3), small_nerf(D=8, skips=(4,), seed=4)
    if kind == "int8":
        packed = k67.qpack_hier(coarse, fine, (qpack(coarse)["calib"], qpack(fine, seed=1)["calib"]))
    else:
        packed = k67.pack_hier(coarse, fine)
    from test_torch_wgmma_tf32 import mocked_library

    seen = mocked_library(monkeypatch, k67, "nst_render_hier")
    n = 40
    ro, rd = torch.zeros(n, 3, device="meta"), torch.zeros(n, 3, device="meta")
    before = build.launches.copy()
    out = k67.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro, rd, n_coarse=8, n_importance=16,
                                 seed=5 if seeded else None)
    assert out["rgb_map"].shape == (n, 3)
    v_c = fr.epilogue_vectors(packed["coarse"], sigma_only=True)
    v_f = fr.epilogue_vectors(packed["fine"])
    ptrs = seen["ptrs"]
    assert seen["count"] == len(ptrs) == 4 + 2 + len(v_c) + len(v_f)
    assert ptrs[0] is ro and ptrs[1] is rd and ptrs[2] is None and tuple(ptrs[3].shape) == (11, n)
    assert all(a is b for a, b in zip(ptrs[6:], v_c + v_f))
    s_c, s_f = ptrs[4:6]
    assert s_c is fr.pack_slices(packed["coarse"], sigma_only=True) and s_f is fr.pack_slices(packed["fine"])
    if kind == "int8":
        fwd = _header_formula("forward_qslices")
        assert s_c.dtype == s_f.dtype == torch.uint8
        assert s_c.shape[0] == fwd(4, 0b10, True) and s_f.shape[0] == fwd(8, 0b100000, False)
        assert torch.equal(s_f, fr.wgmma_qslices(fr.wgmma_qprogram(packed["fine"])))
        assert seen["args"][-3] is not None and seen["args"][-2] is not None  # plan_c, plan_f
    else:
        fwd = _header_formula("forward_slices")
        assert s_c.dtype == s_f.dtype == torch.bfloat16
        assert s_c.shape[0] == fwd(4, 0b10, True) and s_f.shape[0] == fwd(8, 0b100000, False)
        assert seen["args"][-3] is None and seen["args"][-2] is None
    assert build.launches - before == {("K6" if seeded else "K7", kind): 1}


def _render(entry: str, packed: dict, cfg, n: int, S: int = 16):
    """One int8 render launch of ``entry`` on meta tensors (K2, K3, K8, K9)."""
    ro, rd = torch.zeros(n, 3, device="meta"), torch.zeros(n, 3, device="meta")
    if entry == "nst_render_around_depth":
        return fr.render_around_depth_kernel(packed, cfg, ro, rd, torch.zeros(n, device="meta"),
                                             torch.zeros(S, device="meta"))
    if entry == "nst_render_gaussian":
        return fr.render_gaussian_kernel(packed, cfg, ro, rd, torch.zeros(n, device="meta"), n_samples=S, std=1.0, seed=1)
    if entry == "nst_render_linspace":
        return fr.fused_render(packed, cfg, ro, rd, n_samples=S)
    return fr.fused_shade(packed, cfg, ro, rd, torch.zeros(n, S, device="meta"))


RENDER_ENTRIES = ["nst_render_around_depth", "nst_render_gaussian", "nst_render_linspace", "nst_shade"]


@pytest.mark.parametrize("entry", RENDER_ENTRIES, ids=["K2", "K3", "K8", "K9"])
def test_int8_render_launch_hands_the_qslices(monkeypatch, entry):
    """An int8 render launch hands the kernel, after its outputs, its pack's
    full-forward image (bf16 and s8 slices, as many as the header's
    forward_qslices reads), then the pack's epilogue vectors, and the int8
    plan."""
    from test_torch_wgmma_tf32 import mocked_library

    model = small_nerf(D=8, skips=(4,))
    packed = qpack(model)
    seen = mocked_library(monkeypatch, fr, entry)
    out = _render(entry, packed, model.cfg, 40)
    assert out["rgb_map"].shape == (40, 3)
    vectors = fr.epilogue_vectors(packed)
    ptrs = seen["ptrs"]
    assert seen["count"] == len(ptrs) == 5 + 1 + len(vectors)
    assert all(a is b for a, b in zip(ptrs[6:], vectors))
    assert ptrs[5] is fr.pack_slices(packed) and ptrs[5].dtype == torch.uint8
    assert ptrs[5].shape[0] == _header_formula("forward_qslices")(8, 0b10000, False)
    assert seen["args"][-2] is not None  # the plan


@pytest.mark.parametrize("entry", RENDER_ENTRIES, ids=["K2", "K3", "K8", "K9"])
def test_int8_render_launch_with_another_programs_slices_is_refused(monkeypatch, entry):
    """An int8 pack whose cached full-forward slices are another program's
    (its own sigma-only image, or the bf16 image of the same NeRF) is
    refused before any launch."""
    from test_torch_wgmma_tf32 import mocked_library

    model = small_nerf(D=4, skips=(1,))
    for other in ("sigma_only", "bf16"):
        packed = qpack(model)
        image = fr.pack_slices(packed, sigma_only=True) if other == "sigma_only" else \
            fr.pack_slices(fr.pack_nerf(model))
        packed["wg_slices"] = {"full": image}
        seen = mocked_library(monkeypatch, fr, entry)
        with pytest.raises(ValueError, match="slices"):
            _render(entry, packed, model.cfg, 8)
        assert "count" not in seen


def test_wgmma_dense_q_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (40, 256)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (128, 256)).astype(np.int8))
    got = fr.wgmma_dense_q(a, wq)
    assert got.dtype == torch.int32
    want = a.numpy().astype(np.int64) @ wq.numpy().astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="int8"):
        fr.wgmma_dense_q(a.float(), wq)
