"""The fp32 path of the wgmma MLP core (csrc/mlp_wgmma.cuh): K7 in fp32 with 3xTF32 products, on CPU.

K7 in fp32 (the COMPARE mode's hierarchical render) runs its products on
the tf32 tensor cores as hi @ w_hi + hi @ w_lo + lo @ w_hi, each operand
split as hi = tf32(x), lo = tf32(x - hi). The card reads the host's image
of the weights' hi and lo slices blind, so these tests hold it here:

- ``fused_render.tf32_split``: hi and lo carry no bits below tf32's, hi is
  the nearest tf32 with ties away from zero (an independent formula), and
  |hi + lo - w| is within 2^-22 |w|;
- ``fused_render.wgmma_slices32`` unpacked by an inverse formula of the
  test's own (element (n, e) of a slice holds depth ((e // 4) ^ (n % 8)) *
  4 + e % 4, which is row 8 (k // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[k % 8] of
  the panel) gives back the hi and the lo image of every matrix of the
  program, slice after slice (hi, then lo) with zero padding, and the
  counts are the header's ``forward_slices32`` (parsed from the header);
- a forward written over the unpacked slices as the kernel sums it (per
  32-deep panel the three tf32 products, exact, then rounded fp32 sums of
  the panels, fp32 bias and activation), run inside K7's plain version,
  matches the JAX fp32 ``fused_render_hier`` (interpret mode) on a small
  random NeRF at 3e-4 (``tests/test_torch_eval_modes.py``'s tolerance),
  and the plain fp32 K7 on the committed checkpoint's NeRFs over 300 rays
  of test view 0 at ``chip_smoke.py``'s gates (max_z within 1e-3 on the
  rays that hit the sphere, rgb within 3e-4): 3xTF32 can hold them;
- an fp32 K7 launch, against a mocked library, hands the kernel both fp32
  packs' slices after its outputs, then their epilogue vectors, and a
  launch whose pack holds slices of
  another program is refused;
- the [core] check's fp32 layer (``wgmma_dense32``) on CPU is the fp32
  matmul.

The kernel runs only on the card: ``chip_smoke.py`` holds it there.
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import nerf_pair
from test_torch_nerf_train import committed_pair_and_rays
from test_torch_train import NC, NF, rays_np
from test_torch_wgmma_pack import _header_formula, small_nerf

from nerf_sampling_tpu.kernels.fused_hier import fused_render_hier as jax_fused_hier
from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_hier as k67
from nerf_sampling_tpu_torch.kernels import fused_render as fr

PERM = (0, 2, 4, 6, 1, 3, 5, 7)
K7_Z_TOL, K7_RGB_TOL = 1e-3, 3e-4  # chip_smoke.py's K7_FP32_Z_TOL and FP32_RGB_TOL


def unpack32(image: torch.Tensor, program) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(B_hi, B_lo) of each product's B ([K, N]: W, or W^T when transposed)
    from the fp32 slices, walked as the kernel walks them: 32-deep k panels
    outer, 128-column halves inner, the hi slice then the lo slice; the
    storage position of each element turned back into its depth, and the
    depth into its row through the k group's permutation."""
    img = image.double().numpy()
    assert image.dtype == torch.float32 and img.shape[1] == 4096
    n = np.arange(128)[:, None]
    e = np.arange(32)[None, :]
    k = ((e // 4) ^ (n % 8)) * 4 + e % 4  # depth held at (n, e)
    row = 8 * (k // 8) + np.asarray(PERM)[k % 8]
    s, out = 0, []
    for w, transposed in program:
        K, N = (w.shape[1], w.shape[0]) if transposed else tuple(w.shape)
        kp_n, h_n = -(-K // 32), -(-N // 128)
        pair = []
        for part in range(2):
            pair.append(np.zeros((kp_n * 32, h_n * 128)))
        for kp in range(kp_n):
            for h in range(h_n):
                for part in range(2):
                    tile = np.zeros((32, 128))
                    tile[row, np.broadcast_to(n, row.shape)] = img[s].reshape(128, 32)
                    pair[part][kp * 32:(kp + 1) * 32, h * 128:(h + 1) * 128] = tile
                    s += 1
        for B in pair:
            assert not B[K:].any() and not B[:, N:].any(), "padding of a slice is not zero"
        out.append(tuple(torch.from_numpy(B[:K, :N]) for B in pair))
    assert s == img.shape[0], "slices left over"
    return out


def test_tf32_split():
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(0, 1, 4000), rng.normal(0, 1e-3, 1000) * 10.0 ** rng.integers(-20, 20, 1000),
                        [1.0, -1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12, 3.0e38]]).astype(np.float32)
    hi, lo = fr.tf32_split(torch.from_numpy(w))
    for x in (hi, lo):
        assert not (x.view(torch.int32) & 0x1FFF).any(), "bits below tf32's"
    # the nearest tf32, ties away from zero: |w| scaled to 11 significant bits, rounded half up
    m, ex = np.frexp(np.abs(w).astype(np.float64))
    want = np.sign(w) * np.floor(m * 2.0 ** 11 + 0.5) * 2.0 ** (ex - 11)
    np.testing.assert_array_equal(hi.double().numpy(), want)
    assert hi[-4] == 1 + 2 ** -10 and hi[-3] == -(1 + 2 ** -10)  # ties go away from zero
    err = np.abs(hi.double().numpy() + lo.double().numpy() - w.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(w)).all()


@pytest.mark.parametrize("D,skips,sigma_only", [(4, (1,), False), (8, (4,), True), (8, (4,), False), (1, (), False)])
def test_slices32_unpack_to_the_hi_and_lo_of_every_matrix(D, skips, sigma_only):
    packed = fr.pack_nerf(small_nerf(D=D, skips=skips), torch.float32)
    program = fr.wgmma_program(packed, sigma_only=sigma_only)
    image = fr.wgmma_slices32(program)
    assert image.shape[0] == _header_formula("forward_slices32")(D, sum(1 << i for i in skips), sigma_only)
    for (w, transposed), (b_hi, b_lo) in zip(program, unpack32(image, program)):
        hi, lo = fr.tf32_split(w.T if transposed else w)
        assert torch.equal(b_hi, hi.double()) and torch.equal(b_lo, lo.double())
    assert fr.pack_slices(packed, sigma_only) is fr.pack_slices(packed, sigma_only)
    assert torch.equal(fr.pack_slices(packed, sigma_only), image)
    with pytest.raises(TypeError, match="fp32"):
        fr.wgmma_slices32(fr.wgmma_program(fr.pack_nerf(small_nerf(D=2, skips=()))))


def mm3(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor) -> list[torch.Tensor]:
    """The kernel's product of one operand a [M, K] with B = b_hi + b_lo,
    as fp64 sums of each 32-deep panel: a_hi @ b_hi + a_hi @ b_lo + a_lo @
    b_hi of tf32 values (exact in fp64)."""
    a_hi, a_lo = (x.double() for x in fr.tf32_split(a))
    return [a_hi[:, k:k + 32] @ b_hi[k:k + 32] + a_hi[:, k:k + 32] @ b_lo[k:k + 32] + a_lo[:, k:k + 32] @ b_hi[k:k + 32]
            for k in range(0, a.shape[1], 32)]


def layer(ops, bias, act=True) -> torch.Tensor:
    """act(sum of the operands' products + bias) in fp32: the panel sums
    rounded to fp32 and added in order in rounded fp32 (the kernel's
    accumulators), then the fp32 bias."""
    acc = None
    for a, (b_hi, b_lo) in ops:
        for part in mm3(a, b_hi, b_lo):
            acc = part.float() if acc is None else acc + part.float()
    z = acc + bias
    return torch.relu(z) if act else z


def emulated_forward32(packed: dict, slices: torch.Tensor, x_pts: torch.Tensor, x_v: torch.Tensor | None,
                       sigma_only: bool) -> torch.Tensor:
    """The kernel's fp32 forward (nerf_forward on NerfWeightsT<float>) over
    the unpacked slices: the PE as two operands [pts emb | 0] and [view emb |
    0], each trunk layer (and its skip rows) with 3xTF32 products, the alpha
    and rgb heads in fp32 on the fp32 weights; raw [M, 4], or sigma [M]."""
    program = fr.wgmma_program(packed, sigma_only=sigma_only)
    Bs = iter(unpack32(slices, program))
    M = x_pts.shape[0]
    pe0 = torch.cat([x_pts, torch.zeros(M, 64 - x_pts.shape[1])], 1)
    h = layer([(pe0, next(Bs))], packed["trunk_b"][0])
    for i in range(1, len(packed["trunk_b"])):
        ops = [(h, next(Bs))] + ([(pe0, next(Bs))] if i in packed["skip_w"] else [])
        h = layer(ops, packed["trunk_b"][i])
    sigma = h @ packed["alpha_w"] + packed["alpha_b"]
    if sigma_only:
        return sigma
    feature = layer([(h, next(Bs))], packed["feature_b"], act=False)
    pe1 = torch.cat([x_v, torch.zeros(M, 32 - x_v.shape[1])], 1)
    hv = layer([(feature, next(Bs)), (pe1, next(Bs))], packed["views_b"])
    assert next(Bs, None) is None
    rgb = hv @ packed["rgb_w"].T + packed["rgb_b"]
    return torch.cat([rgb, sigma[:, None]], -1)


def emulated_raw(packed, cfg, rays_o, rays_d, z, *, multires=10, multires_views=4, dtype=torch.bfloat16,
                 sigma_only=False):
    """``fused_render.nerf_raw_plain`` at fp32 with the kernel's 3xTF32 MLP
    (``emulated_forward32`` over the pack's slices) in place of mlp_plain."""
    assert dtype == torch.float32
    n, S = z.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    x_pts = positional_encoding(pts, multires).reshape(n * S, -1)
    x_v = None
    if not sigma_only:
        vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        x_v = positional_encoding(vd, multires_views)[:, None, :].expand(n, S, -1).reshape(n * S, -1)
    out = emulated_forward32(packed, fr.pack_slices(packed, sigma_only), x_pts, x_v, sigma_only)
    return out.reshape(n, S) if sigma_only else out.reshape(n, S, 4)


def test_emulated_3xtf32_k7_matches_jax_fp32(rng, monkeypatch):
    jc, jcfg, coarse = nerf_pair(7)
    jf, _, fine = nerf_pair(8)
    ro, rd = rays_np(130, rng)
    want = jax_fused_hier(jc, jcfg, jf, jcfg, jnp.asarray(ro), jnp.asarray(rd), n_coarse=NC, n_importance=NF,
                          dtype=jnp.float32, interpret=True)
    packed = k67.pack_hier(coarse, fine, torch.float32)
    plain = k67.render_hier_plain(packed, coarse.cfg, fine.cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                  n_coarse=NC, n_importance=NF, dtype=torch.float32)
    monkeypatch.setattr(k67, "nerf_raw_plain", emulated_raw)
    got = k67.render_hier_plain(packed, coarse.cfg, fine.cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                n_coarse=NC, n_importance=NF, dtype=torch.float32)
    assert not torch.equal(got["rgb_map"], plain["rgb_map"])  # the emulation ran
    for name in ("rgb_map", "max_z", "max_w", "max_rgb"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=3e-4, atol=3e-4, err_msg=name)


def test_emulated_3xtf32_k7_holds_the_chip_gates_on_the_committed_nerfs(rng, monkeypatch):
    """The emulated 3xTF32 K7 against the plain fp32 K7 on the committed
    checkpoint's NeRFs (8x256), 300 rays of test view 0 at 64 + 128
    samples: max_z within 1e-3 on the rays that hit the sphere, rgb within
    3e-4 (chip_smoke.py's [fp32] gates)."""
    _, params, (ro, rd, _) = committed_pair_and_rays(rng, n=300)
    packed = k67.pack_hier(params.coarse, params.fine, torch.float32)
    kw = dict(n_coarse=64, n_importance=128, dtype=torch.float32)
    want = k67.render_hier_plain(packed, params.coarse.cfg, params.fine.cfg, ro, rd, **kw)
    monkeypatch.setattr(k67, "nerf_raw_plain", emulated_raw)
    got = k67.render_hier_plain(packed, params.coarse.cfg, params.fine.cfg, ro, rd, **kw)
    b = (ro * rd).sum(-1)
    hit = b * b - (rd * rd).sum(-1) * ((ro * ro).sum(-1) - 4.0) > 0  # the rays that meet the r = 2 sphere
    assert int(hit.sum()) > 100 and float(want["acc_map"][hit].max()) > 0.5
    dz = (got["max_z"] - want["max_z"]).abs()[hit]
    drgb = (got["rgb_map"] - want["rgb_map"]).abs()
    assert float(dz.max()) <= K7_Z_TOL and float(drgb.max()) <= K7_RGB_TOL, (float(dz.max()), float(drgb.max()))
    assert float(drgb.max()) > 0  # the emulation ran


def mocked_library(monkeypatch, module, entry: str, **run):
    """Replace the kernel library on a 132-SM card (``build``'s loader,
    pointer array, stream and SM count) with one whose C entries record
    their calls: ``entry``, and each entry of ``run`` (which runs its
    function on the call's arguments); ``module``'s ``check_cuda``, if a
    module is given, passes the meta tensors that stand for the card's. Returns the record: the
    last call of ``entry``'s pointers, count and arguments (the stream,
    0, last), and every call as (entry, arguments)."""
    seen = {"calls": []}

    class Lib:
        def __getattr__(self, name):
            assert name == entry or name in run

            def call(*args):
                seen["calls"].append((name, args))
                if name in run:
                    return run[name](*args)
                seen["count"], seen["args"] = args[1], args[2:]
                return 0
            return call

    def pointer_array(tensors):
        seen["ptrs"] = tensors
        return None, len(tensors)

    monkeypatch.setattr(build, "load_library", Lib)
    monkeypatch.setattr(build, "pointer_array", pointer_array)
    monkeypatch.setattr(build, "current_stream", lambda device: 0)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    if module is not None:
        monkeypatch.setattr(module, "check_cuda", lambda *a: None)  # the meta tensors below stand for the card's
    return seen


def test_fp32_k7_launch_passes_both_packs_slices(monkeypatch):
    """What an fp32 K7 launch hands nst_render_hier: rays_o, rays_d, no
    draws, out, both nets' fp32 slices (wgmma_slices32's hi and lo images,
    as many as the header's forward_slices32 reads), then the epilogue
    vectors of the coarse net's sigma-only pass and of the fine net, no int8
    plans, fp32 set."""
    coarse, fine = small_nerf(D=4, skips=(1,), seed=3), small_nerf(D=8, skips=(4,), seed=4)
    packed = k67.pack_hier(coarse, fine, torch.float32)
    seen = mocked_library(monkeypatch, k67, "nst_render_hier")
    n = 40
    ro, rd = torch.zeros(n, 3, device="meta"), torch.zeros(n, 3, device="meta")
    before = build.launches["K7", "fp32"]
    out = k67.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro, rd, n_coarse=8, n_importance=16,
                                 dtype=torch.float32)
    assert out["rgb_map"].shape == (n, 3) and build.launches["K7", "fp32"] == before + 1
    v_c = fr.epilogue_vectors(packed["coarse"], sigma_only=True, dtype=torch.float32)
    v_f = fr.epilogue_vectors(packed["fine"], dtype=torch.float32)
    ptrs = seen["ptrs"]
    assert seen["count"] == len(ptrs) == 4 + 2 + len(v_c) + len(v_f)
    assert ptrs[0] is ro and ptrs[1] is rd and ptrs[2] is None and tuple(ptrs[3].shape) == (11, n)
    assert all(a is b for a, b in zip(ptrs[6:], v_c + v_f))
    s_c, s_f = ptrs[4:6]
    fwd = _header_formula("forward_slices32")
    assert s_c.dtype == s_f.dtype == torch.float32
    assert s_c.shape == (fwd(4, 0b10, True), 4096) and s_f.shape == (fwd(8, 0b100000, False), 4096)
    assert torch.equal(s_f, fr.wgmma_slices32(fr.wgmma_program(packed["fine"])))
    assert s_c is fr.pack_slices(packed["coarse"], sigma_only=True)
    args = seen["args"]
    assert args[-5] == 1 and args[-3] is None and args[-2] is None  # det, fp32 set, no plans
    assert args[-4] == 1


def test_fp32_k7_launch_without_its_slices_is_refused(monkeypatch):
    """A pack whose cached slices are not its fp32 program's (here the bf16
    image of another pack) is refused before any launch."""
    coarse, fine = small_nerf(D=4, skips=(1,), seed=3), small_nerf(D=4, skips=(1,), seed=4)
    packed = k67.pack_hier(coarse, fine, torch.float32)
    packed["fine"]["wg_slices"] = {"full": fr.pack_slices(fr.pack_nerf(fine))}
    seen = mocked_library(monkeypatch, k67, "nst_render_hier")
    ro, rd = torch.zeros(8, 3, device="meta"), torch.zeros(8, 3, device="meta")
    with pytest.raises(ValueError, match="slices"):
        k67.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro, rd, n_coarse=8, n_importance=16,
                               dtype=torch.float32)
    assert "count" not in seen


def test_wgmma_dense32_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(40, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(96, 128)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    np.testing.assert_allclose(fr.wgmma_dense32(a, w, b, act=1).numpy(),
                               np.maximum(a.numpy().astype(np.float64) @ w.numpy() + b.numpy(), 0), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(TypeError, match="fp32"):
        fr.wgmma_dense32(a.bfloat16(), w, b)
