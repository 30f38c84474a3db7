"""K1 and K8/K9 in fp32 on the wgmma core's 3xTF32 path (csrc/mlp_wgmma.cuh), on CPU.

K1 in fp32 (the COMPARE mode's DepthNet) and K8/K9 in fp32 (its shading)
run their products on the tf32 tensor cores as hi @ w_hi + hi @ w_lo + lo @
w_hi, from the host's image of the weights' hi and lo slices, which the card
reads blind. These tests hold what the card cannot show here:

- ``fused_depth_net.wgmma_depth_program`` and its slice image, unpacked by
  ``tests/test_torch_wgmma_tf32.py``'s inverse formula, give back the hi and
  lo of every DepthNet matrix in the kernel's order (per tower, layer by
  layer, the embedding matrix then the hidden one, then the tower's rows of
  trunk layer 0; trunk layer 0's A and B rows; trunk layers 1..C-1) with
  zero padding; the count is the header's ``depth_slices32`` (parsed from
  the header); ``fragment_tiles`` puts every element of A and B where an
  independent formula of the thread fragment says;
- an emulated 3xTF32 K1 (exact tf32 products per 32-deep panel, the panels
  joined in rounded fp32, trunk layer 0's five products summed in the
  kernel's order onto one partial), run in place of ``depth_net_plain``,
  matches the JAX ``fused_depth_net_apply`` at fp32 in interpret mode on a
  small 256-wide DepthNet at ``test_torch_eval_modes.py``'s fp32 tolerance,
  and the plain fp32 K1 on the committed DepthNet over 300 rays of test
  view 0 and rays that miss the sphere at ``chip_smoke.py``'s gate (depth
  within 1e-4, the NaN mask equal);
- the emulated fp32 K9 (``emulated_raw`` in ``shade_plain``) matches the JAX
  ``fused_shade`` at fp32 in interpret mode;
- against a mocked library: an fp32 K1 launch and an fp32 K8/K9 launch hand
  their pack's fp32 slices after their outputs, then the pack's epilogue
  vectors; a launch whose pack holds
  another program's slices is refused before the call; bf16 and int8
  launches hand their pack's own images (bf16 K1 its bf16 slices, int8
  K8/K9 the int8 program's).

The kernels run only on the card: ``chip_smoke.py`` holds them there.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import depth_pair, nerf_pair
from test_torch_kernels import rays_np as rays_np_miss
from test_torch_nerf_train import committed_pair_and_rays
from test_torch_wgmma_pack import HEADER, small_nerf
from test_torch_wgmma_tf32 import emulated_raw, mm3, mocked_library, unpack32

from nerf_sampling_tpu.kernels.fused_depth_net import fused_depth_net_apply as jax_fused_depth_net
from nerf_sampling_tpu.kernels.fused_render import fused_shade as jax_fused_shade
from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
from nerf_sampling_tpu_torch.kernels import fused_render as k89
from nerf_sampling_tpu_torch.kernels import quant

F32 = torch.float32
K1_FP32_TOL = 1e-4  # chip_smoke.py's K1_FP32_TOL, and test_torch_eval_modes.py's fp32 K1 tolerance


def header_depth_slices32(n_layers: int, n_cat: int) -> int:
    """mlp_wgmma.cuh's depth_slices32 as a Python function."""
    text = open(HEADER).read()
    m = re.search(r"inline int depth_slices32\(int n_layers, int n_cat\) \{\s*return (.*?);", text, re.S)
    return eval(" ".join(m.group(1).split()), {}, {"n_layers": n_layers, "n_cat": n_cat})


def depth_model(layers: int, seed: int = 0):
    """A 256-wide DepthNet (the width the kernel takes) in both packages."""
    return depth_pair(seed, width=256, layers=layers)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_depth_slices_unpack_to_the_hi_and_lo_of_every_matrix(layers):
    packed = k1.pack_depth_net(depth_model(layers)[2], F32)
    program = k1.wgmma_depth_program(packed)
    image = k1.depth_slices(packed)
    assert image.shape[0] == header_depth_slices32(layers, layers) == k1.depth_slices32(layers, layers)
    # the kernel's order, matrix by matrix
    want = []
    for k, name in enumerate("odi"):
        t = packed[name]
        want += [t["e"][0]] + [w for i in range(1, layers) for w in (t["e"][i], t["h"][i - 1])]
        want.append(packed["cat0"][k])
    want += packed["cat0"][3:] + packed["cat_w"]
    assert len(program) == len(want) and all(w is v and not tr for (w, tr), v in zip(program, want))
    for (w, _), (b_hi, b_lo) in zip(program, unpack32(image, program)):
        hi, lo = k89.tf32_split(w)
        assert torch.equal(b_hi, hi.double()) and torch.equal(b_lo, lo.double())
    assert k1.depth_slices(packed) is image
    k1.check_depth_slices(image, packed)
    with pytest.raises(ValueError, match="slices"):
        k1.check_depth_slices(image[1:], packed)


def test_committed_depth_net_takes_1760_slices():
    """The committed 10x256 DepthNet: 1,760 slices (28.8 MB), as the header counts."""
    _, params, _ = committed_pair_and_rays(np.random.default_rng(0), n=4)
    packed = k1.pack_depth_net(params.depth, F32)
    assert header_depth_slices32(10, 10) == 1760
    assert k1.depth_slices(packed).shape == (1760, 4096)


@pytest.mark.parametrize("n", [1, 64, 150])
def test_fragment_tiles_puts_each_element_where_its_thread_reads_it(n):
    x = torch.arange(n * 128, dtype=F32).reshape(n, 128) + 1.0
    got = k1.fragment_tiles(x)
    tiles = -(-n // 64)
    assert got.shape == (tiles, 16, 128, 4) and got.is_contiguous()
    g = got.numpy()
    for t in range(tiles):
        for grp in range(16):
            for i in range(128):
                w, lane = divmod(i, 32)
                r, c = 16 * w + lane // 4, 8 * grp + 2 * (lane % 4)
                for e, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
                    row = 64 * t + r + dr
                    assert g[t, grp, i, e] == (x[row, c + dc].item() if row < n else 0.0)


def emulated_depth_plain(packed, cfg, A, B, dtype=torch.bfloat16):
    """The fp32 kernel's DepthNet (mlp_wgmma.cuh::depth_forward32) over the
    unpacked slices: every product 3xTF32 per 32-deep panel (exact), the
    panels joined in rounded fp32 onto one sum; each tower's rows of trunk
    layer 0 joined onto the partial as the tower ends, then A's and B's;
    biases, LeakyReLU and the head in fp32 on the fp32 weights."""
    assert dtype == F32
    program = k1.wgmma_depth_program(packed)
    slices = iter(unpack32(k1.depth_slices(packed), program))

    def prod(a, acc=None):
        b_hi, b_lo = next(slices)
        for part in mm3(a, b_hi, b_lo):
            acc = part.float() if acc is None else acc + part.float()
        return acc

    def leaky(z):
        return torch.where(z > 0, z, 0.01 * z)

    part = None
    for k, name in enumerate("odi"):
        emb = A if k < 2 else B
        h = None
        for i, b in enumerate(packed[name]["b"]):
            z = prod(emb)
            h = (z if i == 0 else prod(h, z)) + b
        part = prod(h, part)
    h = leaky(prod(B, prod(A, part)) + packed["cat_b"][0])
    for b in packed["cat_b"][1:]:
        h = leaky(prod(h) + b)
    assert next(slices, None) is None
    depth = torch.sigmoid(h @ packed["head_w"] + packed["head_b"])
    return cfg.near * (1 - depth) + cfg.far * depth


def test_emulated_3xtf32_k1_matches_jax_fp32(rng, monkeypatch):
    params, jcfg, model = depth_model(2, seed=3)
    ro, rd = rays_np_miss(96, rng, miss=3)
    want = np.asarray(jax_fused_depth_net(params, jcfg, jnp.asarray(ro), jnp.asarray(rd), dtype=jnp.float32,
                                          interpret=True))[:, 0]
    packed = k1.pack_depth_net(model, F32)
    plain = k1.fused_depth_net_apply(packed, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), F32)
    monkeypatch.setattr(k1, "depth_net_plain", emulated_depth_plain)
    got = k1.fused_depth_net_apply(packed, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), F32)
    assert not torch.equal(got, plain)  # the emulation ran
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-3:]).all() and not np.isnan(got[:-3]).any()
    np.testing.assert_allclose(got, want, rtol=K1_FP32_TOL, atol=K1_FP32_TOL, equal_nan=True)


def test_emulated_3xtf32_k1_holds_the_chip_gate_on_the_committed_depth_net(rng):
    """The committed DepthNet (10x256) over 300 rays of test view 0 and 16
    that miss the sphere (perpendicular to their origin, 4 from the
    centre): depth within 1e-4 of the plain fp32 K1, NaN on exactly the
    missing rays ([fp32]'s K1 gate)."""
    _, params, (ro, rd, _) = committed_pair_and_rays(rng, n=300)
    d = torch.cross(ro[:16], torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32)), dim=1)
    ro, rd = torch.cat([ro, ro[:16]]), torch.cat([rd, d / d.norm(dim=1, keepdim=True)])
    model, cfg = params.depth, params.depth.cfg
    packed = k1.pack_depth_net(model, F32)
    A, B = k1.depth_net_inputs(cfg, ro, rd, F32)
    want = k1.depth_net_plain(packed, cfg, A, B, F32)
    got = emulated_depth_plain(packed, cfg, A, B, F32)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[-16:]).all() and not torch.isnan(got[:-16]).any()
    err = float((got - want).abs()[:-16].max())
    assert 0 < err <= K1_FP32_TOL, err


@pytest.mark.parametrize("assume_sorted", [True, False])
def test_emulated_3xtf32_k9_matches_jax_fp32(rng, monkeypatch, assume_sorted):
    params, jcfg, model = nerf_pair(5, 2, (4,))
    n, S = 130, 16
    ro, rd = rays_np_miss(n, rng)
    z = np.sort((4.0 + 0.5 * rng.standard_normal((n, S))).astype(np.float32), -1)
    if not assume_sorted:
        z = np.take_along_axis(z, rng.permuted(np.tile(np.arange(S), (n, 1)), axis=1), 1)
    want = jax_fused_shade(params, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), dtype=jnp.float32,
                           interpret=True, assume_sorted=assume_sorted)
    packed = k89.pack_nerf(model, F32)
    args = (packed, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(z))
    plain = k89.fused_shade(*args, assume_sorted=assume_sorted, dtype=F32)
    monkeypatch.setattr(k89, "nerf_raw_plain", emulated_raw)
    got = k89.fused_shade(*args, assume_sorted=assume_sorted, dtype=F32)
    assert not torch.equal(got["rgb_map"], plain["rgb_map"])  # the emulation ran
    for name in ("rgb_map", "acc_map", "depth_map"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=3e-4, atol=3e-4, err_msg=name)


def meta(*shape):
    return torch.zeros(*shape, device="meta")


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
def test_k1_launch_hands_the_fp32_slices_after_the_weights(monkeypatch, dtype):
    """fp32: A and B in fragment order, out, the pack's fp32 slices, then
    its epilogue vectors; the fp32 flag and the tiles a block walks. bf16
    (on the core's bf16 products since the bf16 DepthNet program): A and B
    as they are, out, the pack's bf16 slices, then its vectors; the tiles
    too."""
    model = depth_model(2)[2]
    packed = k1.pack_depth_net(model, dtype)
    seen = mocked_library(monkeypatch, k1, "nst_depth_net_forward")
    n = 200
    A, B = meta(n, 128).to(dtype), meta(n, 128).to(dtype)
    before = build.launches.copy()
    out = k1.depth_net_kernel(packed, model.cfg, A, B)
    assert out.shape == (n,)
    vectors = k1.epilogue_vectors(packed, dtype)
    ptrs, args = seen["ptrs"], seen["args"]
    fp32 = dtype == F32
    assert seen["count"] == len(ptrs) == 3 + 1 + len(vectors)
    assert all(a is b for a, b in zip(ptrs[4:], vectors))
    assert ptrs[3] is k1.depth_slices(packed)
    assert args[-2] == k1.tiles_per_block(n, 132) == 1
    assert build.launches - before == {("K1", "fp32" if fp32 else "bf16"): 1}
    if fp32:
        assert ptrs[0].shape == ptrs[1].shape == (4, 16, 128, 4)
        assert ptrs[3].shape == (header_depth_slices32(2, 2), 4096) and args[-3] == 1
    else:
        assert ptrs[0] is A and ptrs[1] is B
        assert ptrs[3].dtype == torch.bfloat16 and ptrs[3].shape == (k1.depth_slices16(2, 2), 8192)
        assert args[-3] == 0
    assert k1.tiles_per_block(160_064, 132) == 19


def test_k1_fp32_launch_with_another_programs_slices_is_refused(monkeypatch):
    model = depth_model(2)[2]
    packed = k1.pack_depth_net(model, F32)
    packed["wg_slices"] = {"depth": k89.pack_slices(k89.pack_nerf(small_nerf(D=2, skips=()), F32))}
    seen = mocked_library(monkeypatch, k1, "nst_depth_net_forward")
    with pytest.raises(ValueError, match="slices"):
        k1.depth_net_kernel(packed, model.cfg, meta(8, 128), meta(8, 128))
    assert "count" not in seen


def int8_pack(model):
    rng = np.random.default_rng(2)
    ro = torch.tensor([[0.0, 0.0, 4.0]]).repeat(64, 1)
    rd = torch.from_numpy((rng.normal(size=(64, 3)) * 0.2).astype(np.float32))
    rd[:, 2] = -1.0
    return quant.qpack_nerf(model, quant.calibrate_nerf_quant(model, ro, rd, n_rays=64, n_z=9))


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("entry", ["nst_shade", "nst_render_linspace"])
def test_k8_k9_launch_hands_the_packs_slices(monkeypatch, kind, entry):
    """K9 (fused_shade) and K8 (fused_render) hand the kernel the pack's
    full-forward slices after its outputs, then the pack's epilogue vectors:
    the fp32 path's hi and lo image for an fp32 pack, the bf16 image for a
    bf16 one, the int8 program's byte image (bf16 and s8 slices) for an int8
    one."""
    model = small_nerf(D=4, skips=(1,))
    dtype = F32 if kind == "fp32" else torch.bfloat16
    packed = int8_pack(model) if kind == "int8" else k89.pack_nerf(model, dtype)
    seen = mocked_library(monkeypatch, k89, entry)
    n, S = 40, 16
    ro, rd = meta(n, 3), meta(n, 3)
    if entry == "nst_shade":
        out = k89.fused_shade(packed, model.cfg, ro, rd, meta(n, S), dtype=dtype)
    else:
        out = k89.fused_render(packed, model.cfg, ro, rd, n_samples=S, dtype=dtype)
    assert out["rgb_map"].shape == (n, 3)
    vectors = k89.epilogue_vectors(packed, dtype=dtype)
    ptrs = seen["ptrs"]
    assert all(a is b for a, b in zip(ptrs[6:], vectors))
    assert seen["count"] == len(ptrs) == 5 + 1 + len(vectors)
    if kind == "int8":
        want = k89.wgmma_qslices(k89.wgmma_qprogram(packed))
    else:
        program = k89.wgmma_program(packed)
        want = k89.wgmma_slices32(program) if kind == "fp32" else k89.wgmma_slices(program)
    assert ptrs[5] is k89.pack_slices(packed) and torch.equal(ptrs[5], want)
    assert seen["args"][-3] == (kind == "fp32")  # the fp32 flag, before the plan and the stream


@pytest.mark.parametrize("entry", ["nst_shade", "nst_render_linspace"])
def test_k8_k9_fp32_launch_with_another_programs_slices_is_refused(monkeypatch, entry):
    """An fp32 pack whose cached slices are another program's (the bf16
    image of the same NeRF) is refused before any launch."""
    model = small_nerf(D=4, skips=(1,))
    packed = k89.pack_nerf(model, F32)
    packed["wg_slices"] = {"full": k89.pack_slices(k89.pack_nerf(model))}
    seen = mocked_library(monkeypatch, k89, entry)
    ro, rd = meta(8, 3), meta(8, 3)
    with pytest.raises(ValueError, match="slices"):
        if entry == "nst_shade":
            k89.fused_shade(packed, model.cfg, ro, rd, meta(8, 16), dtype=F32)
        else:
            k89.fused_render(packed, model.cfg, ro, rd, n_samples=16, dtype=F32)
    assert "count" not in seen
