"""K1 in bf16 on the wgmma core (csrc/mlp_wgmma.cuh::depth_forward), on CPU.

The bf16 DepthNet runs its products on the bf16 tensor cores from the
host's image of its weight slices, which the card reads blind, one consumer
warpgroup on 64-row tiles. These tests hold what the card cannot show here:

- ``fused_depth_net.depth_slices`` of a bf16 pack, unpacked by
  ``tests/test_torch_wgmma_pack.py``'s inverse formula, gives back every
  DepthNet matrix exactly, in the kernel's order (per tower, layer by layer,
  the embedding matrix then the hidden one, then the tower's rows of trunk
  layer 0; trunk layer 0's A and B rows; trunk layers 1..C-1), with zero
  padding; the count is the header's ``depth_slices16`` (parsed from the
  header): 440 for the committed 10x256 net, a quarter of the fp32 path's
  1,760;
- the bf16 kernel reads A and B as the wrapper builds them: no host
  permutation (the launch below hands the tensors themselves);
- an emulated bf16 K1 (each 64-deep panel's bf16 products summed exactly
  and joined in rounded fp32, the fp32 bias and a bf16 round per layer,
  each tower's rows of trunk layer 0 summed onto one fp32 partial as the
  tower ends, then A's and B's), run in place of ``depth_net_plain``,
  matches the JAX ``fused_depth_net_apply`` at bf16 in interpret mode as
  ``tests/test_torch_kernels.py`` holds the plain bf16 version to it, and
  the plain bf16 K1 on the committed DepthNet within ``chip_smoke.py``'s
  K1 gates (K1_MEAN_TOL / K1_MAX_TOL, NaN on exactly the missing rays);
- against a mocked library: a bf16 launch whose pack holds another
  program's slices is refused before the call.

The kernel runs only on the card: ``chip_smoke.py`` [K1] holds it there.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import rays_np as rays_np_miss
from test_torch_nerf_train import committed_pair_and_rays
from test_torch_wgmma_depth32 import depth_model, meta
from test_torch_wgmma_pack import HEADER, small_nerf, unpack
from test_torch_wgmma_tf32 import mocked_library

from nerf_sampling_tpu.kernels.fused_depth_net import fused_depth_net_apply as jax_fused_depth_net
from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
from nerf_sampling_tpu_torch.kernels import fused_render as k289

BF16 = torch.bfloat16
K1_MEAN_TOL, K1_MAX_TOL = 1e-3, 5e-2  # chip_smoke.py's [K1] gates: |depth| on rays that hit, depth in [2, 6]
JAX_BF16_MEAN_TOL = 2e-2  # tests/test_torch_kernels.py's plain bf16 K1 against the Pallas K1 at bf16


def header_depth_slices16(n_layers: int, n_cat: int) -> int:
    """mlp_wgmma.cuh's depth_slices16 as a Python function."""
    text = open(HEADER).read()
    m = re.search(r"inline int depth_slices16\(int n_layers, int n_cat\) \{\s*return (.*?);", text, re.S)
    return eval(" ".join(m.group(1).split()), {}, {"n_layers": n_layers, "n_cat": n_cat})


def kernel_order(packed: dict, layers: int) -> list[torch.Tensor]:
    """The DepthNet's matrices in the order the kernel consumes them, listed
    apart from ``wgmma_depth_program``."""
    want = []
    for k, name in enumerate("odi"):
        t = packed[name]
        want += [t["e"][0]] + [w for i in range(1, layers) for w in (t["e"][i], t["h"][i - 1])]
        want.append(packed["cat0"][k])
    return want + packed["cat0"][3:] + packed["cat_w"]


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_bf16_depth_slices_unpack_to_every_matrix_in_kernel_order(layers):
    packed = k1.pack_depth_net(depth_model(layers)[2])
    program = k1.wgmma_depth_program(packed)
    image = k1.depth_slices(packed)
    assert image.dtype == BF16 and image.shape == (header_depth_slices16(layers, layers), 8192)
    assert image.shape[0] == k1.depth_slices16(layers, layers)
    want = kernel_order(packed, layers)
    assert len(program) == len(want) and all(w is v and not tr for (w, tr), v in zip(program, want))
    for w, B in zip(want, unpack(image, program)):
        assert torch.equal(B, w.float())
    assert k1.depth_slices(packed) is image
    k1.check_depth_slices(image, packed)
    with pytest.raises(ValueError, match="slices"):
        k1.check_depth_slices(image[1:], packed)


def test_committed_depth_net_takes_440_bf16_slices():
    """The committed 10x256 DepthNet: 440 bf16 slices (7.2 MB) a tile, as
    the header counts: a quarter of the fp32 path's 1,760 (hi and lo of a
    32-deep panel against one 64-deep bf16 panel)."""
    _, params, _ = committed_pair_and_rays(np.random.default_rng(0), n=4)
    packed = k1.pack_depth_net(params.depth)
    assert header_depth_slices16(10, 10) == k1.depth_slices16(10, 10) == 440
    assert 4 * 440 == k1.depth_slices32(10, 10)
    image = k1.depth_slices(packed)
    assert image.shape == (440, 8192) and image.numel() * 2 == 440 * 16384


def emulated_depth_plain(packed, cfg, A, B, dtype=BF16):
    """The bf16 kernel's DepthNet (mlp_wgmma.cuh::depth_forward) over the
    unpacked slices: per 64-deep panel the bf16 products summed exactly
    (fp64) and joined onto the layer's fp32 sum in rounded fp32, the
    operands of a layer in the kernel's order (embedding, then hidden); the
    fp32 bias, then a bf16 round; each tower's rows of trunk layer 0 summed
    onto one fp32 partial as the tower ends, then A's and B's, the bias and
    LeakyReLU; the head an fp32 dot of the bf16 activations."""
    assert dtype == BF16
    program = k1.wgmma_depth_program(packed)
    mats = iter(unpack(k1.depth_slices(packed), program))
    f32 = torch.float32

    def prod(a, acc=None):
        w = next(mats).double()
        for kp in range(0, w.shape[0], 64):
            part = (a[:, kp:kp + 64].double() @ w[kp:kp + 64]).to(f32)
            acc = part if acc is None else acc + part
        return acc

    def rnd(x):
        return x.to(BF16).to(f32)

    def leaky(z):
        return torch.where(z > 0, z, 0.01 * z)

    A, B = A.to(f32), B.to(f32)
    part = None
    for k, name in enumerate("odi"):
        emb = A if k < 2 else B
        h = None
        for i, b in enumerate(packed[name]["b"]):
            z = prod(emb)
            h = rnd((z if i == 0 else prod(h, z)) + b)
        part = prod(h, part)
    h = rnd(leaky(prod(B, prod(A, part)) + packed["cat_b"][0]))
    for b in packed["cat_b"][1:]:
        h = rnd(leaky(prod(h) + b))
    assert next(mats, None) is None
    depth = torch.sigmoid(h @ packed["head_w"].to(f32) + packed["head_b"])
    return cfg.near * (1 - depth) + cfg.far * depth


def test_emulated_bf16_k1_matches_jax_bf16(rng, monkeypatch):
    params, jcfg, model = depth_model(2, seed=3)
    ro, rd = rays_np_miss(96, rng, miss=3)
    want = np.asarray(jax_fused_depth_net(params, jcfg, jnp.asarray(ro), jnp.asarray(rd), dtype=jnp.bfloat16,
                                          interpret=True))[:, 0]
    packed = k1.pack_depth_net(model)
    plain = k1.fused_depth_net_apply(packed, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd))
    monkeypatch.setattr(k1, "depth_net_plain", emulated_depth_plain)
    got = k1.fused_depth_net_apply(packed, model.cfg, torch.from_numpy(ro), torch.from_numpy(rd))
    assert not torch.equal(got, plain)  # the emulation ran
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-3:]).all() and not np.isnan(got[:-3]).any()
    assert np.nanmean(np.abs(got - want)) < JAX_BF16_MEAN_TOL


def test_emulated_bf16_k1_holds_the_chip_gate_on_the_committed_depth_net(rng):
    """The committed DepthNet (10x256) over 300 rays of test view 0 and 16
    that miss the sphere (perpendicular to their origin): depth within
    [K1]'s gates of the plain bf16 K1, NaN on exactly the missing rays."""
    _, params, (ro, rd, _) = committed_pair_and_rays(rng, n=300)
    d = torch.cross(ro[:16], torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32)), dim=1)
    ro, rd = torch.cat([ro, ro[:16]]), torch.cat([rd, d / d.norm(dim=1, keepdim=True)])
    model, cfg = params.depth, params.depth.cfg
    packed = k1.pack_depth_net(model)
    A, B = k1.depth_net_inputs(cfg, ro, rd)
    want = k1.depth_net_plain(packed, cfg, A, B)
    got = emulated_depth_plain(packed, cfg, A, B)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[-16:]).all() and not torch.isnan(got[:-16]).any()
    err = (got - want).abs()[:-16]
    assert float(err.mean()) <= K1_MEAN_TOL and float(err.max()) <= K1_MAX_TOL, (float(err.mean()), float(err.max()))


def test_bf16_k1_launch_with_another_programs_slices_is_refused(monkeypatch):
    """A bf16 pack whose cached slices are another program's (the fp32
    image of the same DepthNet, or a NeRF's bf16 image) is refused before
    any launch."""
    model = depth_model(2)[2]
    for other in (k1.depth_slices(k1.pack_depth_net(model, torch.float32)),
                  k289.pack_slices(k289.pack_nerf(small_nerf(D=2, skips=())))):
        packed = k1.pack_depth_net(model)
        packed["wg_slices"] = {"depth": other}
        seen = mocked_library(monkeypatch, k1, "nst_depth_net_forward")
        with pytest.raises(ValueError, match="slices"):
            k1.depth_net_kernel(packed, model.cfg, meta(8, 128).to(BF16), meta(8, 128).to(BF16))
        assert "count" not in seen
