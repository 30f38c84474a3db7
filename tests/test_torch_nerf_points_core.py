"""K4 (the point-query NeRF) on the wgmma core and its slices shared with K5, on CPU.

K4 runs the core's bf16 forward from the pack's full-forward weight slices,
which the nerf step's Function makes once, in its forward, and hands K5's
recompute too. These tests hold, against a mocked library (the kernels
run only on the card, where ``chip_smoke.py`` [k4] holds them):

- what a K4 launch hands ``nst_nerf_points``: pts, dirs, out, the slices
  (as many as the header's ``forward_slices`` reads), then the pack's
  epilogue vectors, and
  the 128-row tiles a block walks at the train step's two query sizes (4
  at 65,536 rows and 12 at 196,608 on 132 SMs: 128 blocks each);
- a K4 launch without the slices, or with another program's, is refused
  before any launch;
- a K5 launch hands ``nst_nerf_points_bwd`` the forward slices it is given
  and the backward's own (the program's tail past the forward), then the
  pack's epilogue vectors;
- one forward and backward of ``fused_nerf_train_apply`` builds the
  forward slices once (``wgmma_slices`` on the forward program) and hands
  the same image to K4 and K5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_wgmma_pack import _header_formula, small_nerf
from test_torch_wgmma_tf32 import mocked_library

from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
from nerf_sampling_tpu_torch.kernels import fused_nerf_vjp as k5
from nerf_sampling_tpu_torch.kernels import fused_render as fr


@pytest.mark.parametrize("M,S,tiles", [(65536, 64, 4), (196608, 192, 12)], ids=["coarse", "fine"])
def test_k4_launch_takes_the_forward_slices_and_sizes_its_blocks(monkeypatch, M, S, tiles):
    model = small_nerf(D=8, skips=(4,))
    packed = fr.pack_nerf(model)
    slices = fr.pack_slices(packed)
    seen = mocked_library(monkeypatch, k4, "nst_nerf_points")
    pts, dirs = torch.zeros(M, 3, device="meta"), torch.zeros(M // S, 3, device="meta")
    before = build.launches["K4", "bf16"]
    out = k4.nerf_points_kernel(packed, model.cfg, pts, dirs, slices=slices)
    assert tuple(out.shape) == (M, 4) and build.launches["K4", "bf16"] == before + 1
    ptrs = seen["ptrs"]
    vectors = fr.epilogue_vectors(packed)
    assert len(ptrs) == 3 + 1 + len(vectors)
    assert ptrs[0] is pts and ptrs[1] is dirs and ptrs[2] is out
    assert ptrs[3] is slices and all(a is b for a, b in zip(ptrs[4:], vectors))
    assert slices.shape[0] == _header_formula("forward_slices")(8, 0b100000, False)
    ((name, args),) = seen["calls"]
    assert name == "nst_nerf_points" and args[1] == len(ptrs)
    assert args[2:7] == (M, S, 8, 0b100000, tiles)  # rows, rows per direction, D, skip mask, tiles per block
    assert -(-M // (128 * tiles)) == 128  # 128 blocks: one wave at one block per SM on 132 SMs


def test_k4_launch_without_its_slices_is_refused(monkeypatch):
    model = small_nerf(D=4, skips=(1,))
    packed = fr.pack_nerf(model)
    seen = mocked_library(monkeypatch, k4, "nst_nerf_points")
    pts, dirs = torch.zeros(256, 3, device="meta"), torch.zeros(4, 3, device="meta")
    for bad in (None, fr.pack_slices(packed, sigma_only=True), fr.pack_slices(packed).float()):
        with pytest.raises(ValueError, match="slices"):
            k4.nerf_points_kernel(packed, model.cfg, pts, dirs, slices=bad)
    assert seen["calls"] == []


def test_k5_launch_takes_the_forward_and_the_backward_slices(monkeypatch):
    model = small_nerf(D=4, skips=(1,))
    packed = fr.pack_nerf(model)
    fwd = fr.pack_slices(packed)
    header_fwd, header_bwd = _header_formula("forward_slices"), _header_formula("backward_slices")

    def sizes(m, D, skip_mask, total, slice_rows, out):
        for i, v in enumerate((1, 1, 1, 1, 1, 1, header_bwd(D, skip_mask, False), header_bwd(D, skip_mask, True),
                               header_fwd(D, skip_mask, False))):
            out[i] = v
        return 0

    seen = mocked_library(monkeypatch, k5, "nst_nerf_points_bwd", nst_nerf_points_bwd_sizes=sizes)
    m, S = 512, 8
    pts, dirs, g = (torch.zeros(*shape, device="meta") for shape in ((m, 3), (m // S, 3), (m, 4)))
    monkeypatch.setattr(k5, "_unflatten_grads", lambda packed, dw, db: {})
    for want_dx in (False, True):
        k5.nerf_points_bwd_kernel(packed, model.cfg, pts, dirs, g, want_dx=want_dx, fwd_slices=fwd)
        ptrs = seen["ptrs"]
        program = fr.wgmma_program(packed, backward=True, want_dx=want_dx)
        assert ptrs[11] is fwd
        assert torch.equal(ptrs[12], fr.wgmma_slices(program[len(fr.wgmma_program(packed)):]))
        assert ptrs[12].shape[0] == header_bwd(4, 0b10, want_dx)
        assert len(ptrs) == 13 + len(fr.epilogue_vectors(packed))
        assert all(a is b for a, b in zip(ptrs[13:], fr.epilogue_vectors(packed)))
        assert (ptrs[3] is None) == (not want_dx)
    with pytest.raises(ValueError, match="slices"):
        k5.nerf_points_bwd_kernel(packed, model.cfg, pts, dirs, g, want_dx=False,
                                  fwd_slices=fr.pack_slices(packed, sigma_only=True))


def test_train_apply_builds_the_forward_slices_once(monkeypatch):
    """One forward and backward of fused_nerf_train_apply: the forward
    program's slices are built once (in the forward) and the same image
    reaches K4 and K5 (here their wrappers, recording, run the plain
    versions)."""
    model = small_nerf(D=4, skips=(1,), seed=2)
    forward_builds = []
    real_slices = fr.wgmma_slices

    def counting(program):
        if len(program) == len(fr.wgmma_program(fr.pack_nerf(model))):
            forward_builds.append(program)
        return real_slices(program)

    monkeypatch.setattr(fr, "wgmma_slices", counting)
    monkeypatch.setattr(k5, "wgmma_slices", counting)
    got = {}
    real_k4, real_k5 = k5.nerf_points_kernel, k5.nerf_points_bwd_kernel

    def k4_rec(packed, cfg, pts, dirs, *, slices=None, **kw):
        got["k4"] = slices
        return real_k4(packed, cfg, pts, dirs, slices=slices, **kw)

    def k5_rec(packed, cfg, pts, dirs, g, *, want_dx, fwd_slices=None, **kw):
        got["k5"] = fwd_slices
        return real_k5(packed, cfg, pts, dirs, g, want_dx=want_dx, fwd_slices=fwd_slices, **kw)

    monkeypatch.setattr(k5, "nerf_points_kernel", k4_rec)
    monkeypatch.setattr(k5, "nerf_points_bwd_kernel", k5_rec)
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-1, 1, (4, 16, 3)).astype(np.float32)).requires_grad_()
    dirs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(4, 1, 3)).astype(np.float32)), dim=-1)
    raw = k5.fused_nerf_train_apply(model, model.cfg, pts, dirs)
    raw.square().sum().backward()
    assert len(forward_builds) == 1
    assert got["k4"] is got["k5"] and got["k4"].shape[0] == _header_formula("forward_slices")(4, 0b10, False)
    assert pts.grad is not None and all(p.grad is not None for p in model.parameters())
