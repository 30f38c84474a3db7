"""The kernels' PE fills (csrc/mlp_wgmma.cuh: stage_views and pe_fill, the render
kernels'; stage_point_views and point_fill, K4's and K5's), on CPU.

The kernels fill each 128-row PE tile with two threads a row: thread h
computes one sine and cosine per (frequency 5h + j, axis k) and writes the
point columns [32h, 32h + 32), column 32 coming from its partner by a
shuffle; the view columns are a copy of the ray's staged embedding. The
card holds the fill to the per-column formula it replaced byte for byte
(chip_smoke.py [core], ``fused_render.pe_fill_check``); these tests hold,
here, the column map that the fill's two halves assemble to the per-column
order of ``nerf_mlp.cuh::embed``, and the check's row layout and padding
on its plain path. The point-query fill assembles its rows alike from the
points and, per tile, the staged view embedding of each ray the tile
touches (``fused_nerf.point_fill_check`` on the card); these tests hold
that assembly to ``fused_nerf.point_embeddings``, the count of staged rays
to ``fused_nerf.staged_view_rays``, and the point check's layout.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from nerf_sampling_tpu_torch.core.encoding import positional_encoding
from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
from nerf_sampling_tpu_torch.kernels import fused_render as fr
from nerf_sampling_tpu_torch.utils import profiling


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


def staged_view_as_the_kernel_stages_it(d: np.ndarray) -> np.ndarray:
    """stage_point_views' 32 columns of one ray's direction d [3]: item p <
    12 is frequency p // 3 and axis p % 3, one (sin, cos) pair written to
    columns 3 + 6f + k and 6 + 6f + k; items 12-14 the identity, item 15
    the zeros from column 27."""
    out = np.full(32, np.nan, np.float32)
    for p in range(16):
        if p < 12:
            f, k = p // 3, p % 3
            a = d[k] * np.float32(2.0 ** f)
            out[3 + 6 * f + k], out[6 + 6 * f + k] = np.sin(a), np.cos(a)
        elif p < 15:
            out[p - 12] = d[p - 12]
        else:
            out[27:] = 0.0
    assert not np.isnan(out).any(), "a staged column is left unwritten"
    return out


def point_tile_as_the_kernel_fills_it(pts: np.ndarray, dirs: np.ndarray, row0: int) -> np.ndarray:
    """point_fill's 128-row tile from row0 of points [M, 3] with directions
    [M / S, 3]: each row's two halves, the view rows copied from the rays
    staged once for the tile, rows past M zero."""
    m, S = pts.shape[0], pts.shape[0] // dirs.shape[0]
    valid = min(128, m - row0)
    ra, rb = row0 // S, (row0 + valid - 1) // S
    staged = np.stack([staged_view_as_the_kernel_stages_it(dirs[r]) for r in range(ra, rb + 1)])
    tile = np.zeros((128, 128), np.float32)
    tile[:valid, :64] = halves_as_the_kernel_assembles_them(pts[row0:row0 + valid])
    tile[:valid, 64:96] = staged[np.arange(row0, row0 + valid) // S - ra]
    return tile, rb - ra + 1


# (S, rays, tile): whole rays in a tile, tiles that start mid-ray or end one,
# a short last tile, and a direction a row
@pytest.mark.parametrize("S,n,t", [(1, 300, 0), (1, 300, 2), (64, 7, 0), (64, 7, 3), (192, 5, 1), (192, 5, 2),
                                   (192, 5, 7)])
def test_point_fill_assembles_the_plain_embedding(S, n, t):
    rng = np.random.default_rng(S + t)
    pts = rng.uniform(-6, 6, (n * S, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    tile, nr = point_tile_as_the_kernel_fills_it(pts, dirs, 128 * t)
    x_pts, x_v = k4.point_embeddings(torch.from_numpy(pts), torch.from_numpy(dirs), 10, 4, torch.float32)
    rows = slice(128 * t, min(128 * (t + 1), n * S))
    valid = rows.stop - rows.start
    np.testing.assert_allclose(tile[:valid, :63], x_pts[rows].numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tile[:valid, 64:91], x_v[rows].numpy(), rtol=0, atol=2e-6)
    assert not tile[:valid, 63].any() and not tile[:valid, 91:].any() and not tile[valid:].any()
    assert nr == (rows.stop - 1) // S - rows.start // S + 1 <= (2 if S >= 64 else 128)


@pytest.mark.parametrize("m,S,want", [(65536, 64, 1024), (196608, 192, 2048), (20001, 1, 20001), (960, 192, 10),
                                      (7007, 7, 1048)])
def test_staged_view_rays_counts_each_ray_once_a_tile(m, S, want):
    rays = {(row // 128, row // S) for row in range(m)}  # (tile, ray) pairs the rows touch
    assert k4.staged_view_rays(m, S) == len(rays) == want


def test_the_fill_counts_while_the_recorder_is_on():
    k4.count_fill("k4", 65536, 64)  # off: nothing
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        k4.count_fill("k4", 65536, 64)
        k4.count_fill("k5", 196608, 192)
        table = profiling.recorded()
    assert table["nst.k4.rows"]["total"] == 65536 and table["nst.k4.view_rays"]["total"] == 1024
    assert table["nst.k5.rows"]["total"] == 196608 and table["nst.k5.view_rays"]["total"] == 2048
    profiling.reset()


@pytest.mark.parametrize("S,n", [(1, 300), (7, 50), (64, 3), (192, 2)])
def test_point_check_layout_on_the_plain_path(S, n):
    g = torch.Generator().manual_seed(S)
    pts = (torch.rand(n * S, 3, generator=g) * 2 - 1) * 6
    pts[1] = float("nan")
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    fill, ref, q_fill, q_ref = k4.point_fill_check(pts, dirs, tiles_per_block=2)
    m, mp = n * S, -(-n * S // 128) * 128
    assert fill.shape == ref.shape == (mp, 128) and fill.dtype == torch.bfloat16 and q_fill.shape == (mp, 8)
    assert torch.equal(fill.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(q_fill.view(torch.int32), q_ref.view(torch.int32))
    x_pts = positional_encoding(pts, 10).to(torch.bfloat16)
    x_v = positional_encoding(dirs, 4).to(torch.bfloat16).repeat_interleave(S, 0)
    assert torch.equal(ref[:m, :63].view(torch.int16), x_pts.view(torch.int16))
    assert torch.equal(ref[:m, 64:91].view(torch.int16), x_v.view(torch.int16))
    assert not ref[:, 63].any() and not ref[:, 91:].any() and not ref[m:].any()
    assert torch.isnan(ref[1, :63].float()).all() and not torch.isnan(ref[1, 64:].float()).any()
    assert torch.equal(q_ref[:m, :3].view(torch.int32), pts.view(torch.int32))
    assert torch.equal(q_ref[:m, 3:6], dirs.repeat_interleave(S, 0)) and not q_ref[m:].any() and not q_ref[:, 6:].any()


def test_point_check_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        k4.point_fill_check(torch.zeros(10, 3), torch.ones(3, 3))  # 10 rows do not split into 3 rays
    with pytest.raises(ValueError):
        k4.point_fill_check(torch.zeros(10, 3), torch.ones(5, 3), tiles_per_block=0)
