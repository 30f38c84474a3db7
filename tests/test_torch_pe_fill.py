"""The render kernels' PE fill (csrc/mlp_wgmma.cuh::stage_views, pe_fill), on CPU.

The kernels fill each 128-row PE tile with two threads a row: thread h
computes one sine and cosine per (frequency 5h + j, axis k) and writes the
point columns [32h, 32h + 32), column 32 coming from its partner by a
shuffle; the view columns are a copy of the ray's staged embedding. The
card holds the fill to the per-column formula it replaced byte for byte
(chip_smoke.py [core], ``fused_render.pe_fill_check``); these tests hold,
here, the column map that the fill's two halves assemble to the per-column
order of ``nerf_mlp.cuh::embed``, and the check's row layout and padding
on its plain path.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import fused_render as fr


def embed_column(v: np.ndarray, col: int) -> np.ndarray:
    """nerf_mlp.cuh::embed: column col of [x, sin(x 2^0), cos(x 2^0), ...]."""
    if col < 3:
        return v[..., col]
    c = col - 3
    f, k = c // 6, c % 6
    a = v[..., k % 3] * np.float32(2.0 ** f)
    return np.sin(a) if k < 3 else np.cos(a)


def halves_as_the_kernel_assembles_them(u: np.ndarray) -> np.ndarray:
    """The 64 point columns of rows u [M, 3] as pe_fill's two threads of a
    row write them: each half its own 15 (sin, cos) pairs, h = 1 taking
    column 32 from h = 0."""
    out = np.full((u.shape[0], 64), np.nan, np.float32)
    sn = {h: {(j, k): np.sin(u[:, k] * np.float32(2.0 ** (5 * h + j))) for j in range(5) for k in range(3)}
          for h in (0, 1)}
    cs = {h: {(j, k): np.cos(u[:, k] * np.float32(2.0 ** (5 * h + j))) for j in range(5) for k in range(3)}
          for h in (0, 1)}
    for h in (0, 1):
        v = {}
        for j in range(5):
            for k in range(3):
                if h == 0:
                    v[3 + 6 * j + k] = sn[0][j, k]
                    if 6 + 6 * j + k < 32:
                        v[6 + 6 * j + k] = cs[0][j, k]
                else:
                    v[1 + 6 * j + k] = sn[1][j, k]
                    v[4 + 6 * j + k] = cs[1][j, k]
        if h == 0:
            v.update({0: u[:, 0], 1: u[:, 1], 2: u[:, 2]})
        else:
            v.update({0: cs[0][4, 2], 31: np.zeros(u.shape[0], np.float32)})
        assert sorted(v) == list(range(32)), f"half {h} leaves columns unwritten or writes past 32"
        for i, col in v.items():
            out[:, 32 * h + i] = col
    return out


def test_two_halves_give_the_per_column_order():
    u = np.random.default_rng(0).normal(0, 3, (257, 3)).astype(np.float32)
    got = halves_as_the_kernel_assembles_them(u)
    want = np.stack([embed_column(u, c) for c in range(63)] + [np.zeros(257, np.float32)], -1)
    np.testing.assert_array_equal(got, want)


def test_per_column_order_is_the_plain_encoding():
    u = np.random.default_rng(1).normal(0, 3, (64, 3)).astype(np.float32)
    want = positional_encoding(torch.from_numpy(u), 10).numpy()
    got = np.stack([embed_column(u, c) for c in range(63)], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("S,R,n", [(64, 3, 7), (2, 64, 65), (192, 5, 11)])
def test_check_layout_on_the_plain_path(S, R, n):
    g = torch.Generator().manual_seed(S)
    ro = torch.randn(n, 3, generator=g) * 2
    rd = torch.randn(n, 3, generator=g)
    z = torch.rand(n, S, generator=g) * 8
    z[1] = float("nan")
    fill, ref = fr.pe_fill_check(ro, rd, z, R)
    tiles, blocks = -(-R * S // 128), -(-n // R)
    assert fill.shape == ref.shape == (blocks * tiles * 128, 128) and fill.dtype == torch.bfloat16
    assert torch.equal(fill.view(torch.int16), ref.view(torch.int16))
    pts = positional_encoding(ro[:, None, :] + rd[:, None, :] * z[..., None], 10).to(torch.bfloat16)
    vd = positional_encoding(rd / torch.linalg.norm(rd, dim=-1, keepdim=True), 4).to(torch.bfloat16)
    per_block = ref.reshape(blocks, tiles * 128, 128)
    for i in range(n):
        b, j = divmod(i, R)
        rows = per_block[b, j * S:(j + 1) * S]
        assert torch.equal(rows[:, :63].view(torch.int16), pts[i].view(torch.int16))
        assert torch.equal(rows[:, 64:91].view(torch.int16), vd[i].expand(S, 27).view(torch.int16))
        assert not rows[:, 63].any() and not rows[:, 91:].any()
    assert torch.isnan(per_block[0, S:2 * S, :63].float()).all()  # ray 1's NaN depth, point columns only
    last = n - (blocks - 1) * R  # the last block's rays; its rows past them, and every block's past R S, zero
    assert not per_block[-1, last * S:].any() and not per_block[:, R * S:].any()


def test_check_sigma_only_leaves_the_view_panel():
    g = torch.Generator().manual_seed(3)
    ro, rd, z = torch.randn(4, 3, generator=g), torch.randn(4, 3, generator=g), torch.rand(4, 64, generator=g) * 8
    fill, ref = fr.pe_fill_check(ro, rd, z, 2, sigma_only=True)
    assert torch.equal(fill[:, :64], ref[:, :64])
    assert bool((fill[:, 64:].view(torch.int16) == -1).all())


def test_check_refuses_a_block_past_the_kernels_rows():
    ro, rd, z = torch.zeros(4, 3), torch.ones(4, 3), torch.ones(4, 512)
    with pytest.raises(ValueError):
        fr.pe_fill_check(ro, rd, z, 4)
