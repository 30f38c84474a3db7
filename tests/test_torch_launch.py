"""Every C entry's launch against a mocked library, on CPU: what it is handed and what it counts.

A pack's matrices reach the card once, as its wgmma slice image. For each C
entry and precision (K1 bf16 and fp32; K2 and K3 bf16 and int8; K8 and K9
bf16, fp32 and int8; K4; K5; K6 bf16 and int8; K7 bf16, int8 and fp32; K11)
a launch through ``build.launch`` hands the entry its inputs and outputs,
then the slice images, then the vectors its epilogues read, named here
from the pack's keys, and nothing else: no matrix of the pack. It adds one
to ``build.launches[kernel, precision]`` (K5 one for each of its three
passes) and to no other key. Every ``kernel_occupancy`` asks its C entry
through ``build.occupancy``, with the SM count of the card in use.
"""

from __future__ import annotations

import pytest
import torch
from test_torch_wgmma_depth32 import depth_model
from test_torch_wgmma_int8 import qpack
from test_torch_wgmma_pack import small_nerf
from test_torch_wgmma_tf32 import mocked_library

from nerf_sampling_tpu_torch.kernels import build
from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
from nerf_sampling_tpu_torch.kernels import fused_hier as k67
from nerf_sampling_tpu_torch.kernels import fused_mip as k11
from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
from nerf_sampling_tpu_torch.kernels import fused_nerf_vjp as k5
from nerf_sampling_tpu_torch.kernels import fused_render as fr
from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig

BF16, F32 = torch.bfloat16, torch.float32
N, S = 40, 16  # rays and samples of a launch


def meta(*shape, dtype=F32) -> torch.Tensor:
    return torch.zeros(*shape, dtype=dtype, device="meta")


class Out:
    """A pointer the wrapper allocates (an output or a reordered input): its shape."""

    def __init__(self, *shape):
        self.shape = shape


class Equal:
    """A pointer the wrapper makes anew each launch: its contents."""

    def __init__(self, t: torch.Tensor):
        self.t = t


def nerf_vectors(p: dict, sigma_only: bool = False) -> list[torch.Tensor]:
    """The epilogue vectors of a NeRF pack in nerf_mlp.cuh::read_pack's order."""
    if "calib" in p:  # int8: b0, the trunk rows, the skip layers' biases
        head = [p["b0"], *p["trunk_row"], *(p["skip_b"][i] for i in sorted(p["skip_b"]))]
        tail = ["feature_bz", "alpha_w", "alpha_b", "views_sw", "views_b", "rgb_w", "rgb_b"]
    else:
        head = list(p["trunk_b"])
        tail = ["feature_b", "alpha_w", "alpha_b", "views_b", "rgb_w", "rgb_b"]
    return head + [p[k] for k in (["alpha_w", "alpha_b"] if sigma_only else tail)]


def nerf_matrices(p: dict) -> list[torch.Tensor]:
    program = fr.wgmma_qprogram(p) if "calib" in p else fr.wgmma_program(p)
    return [w for w, *_ in program]


def nerf_pack(precision: str, seed: int = 0):
    model = small_nerf(D=4, skips=(1,), seed=seed)
    return model, (qpack(model, seed) if precision == "int8" else fr.pack_nerf(model, F32 if precision == "fp32"
                                                                               else BF16))


def case_k1(precision):
    model = depth_model(2)[2]
    dtype = F32 if precision == "fp32" else BF16
    packed = k1.pack_depth_net(model, dtype)
    A, B = meta(N, 128, dtype=dtype), meta(N, 128, dtype=dtype)
    k1.depth_net_kernel(packed, model.cfg, A, B)
    ins = [Out(1, 16, 128, 4), Out(1, 16, 128, 4)] if dtype == F32 else [A, B]
    vectors = [*packed["o"]["b"], *packed["d"]["b"], *packed["i"]["b"], *packed["cat_b"], packed["head_w"],
               packed["head_b"]]
    return ins + [Out(N), k1.depth_slices(packed)] + vectors, [w for w, _ in k1.wgmma_depth_program(packed)]


def render_case(kernel):
    def case(precision):
        model, packed = nerf_pack(precision)
        ro, rd, dtype = meta(N, 3), meta(N, 3), F32 if precision == "fp32" else BF16
        if kernel == "K2":
            depth, z = meta(N), meta(S)
            fr.render_around_depth_kernel(packed, model.cfg, ro, rd, depth, z)
        elif kernel == "K3":
            depth, z = meta(N), None
            fr.render_gaussian_kernel(packed, model.cfg, ro, rd, depth, n_samples=S, std=1.0, seed=3)
        elif kernel == "K8":
            depth, z = None, None
            fr.fused_render(packed, model.cfg, ro, rd, n_samples=S, dtype=dtype)
        else:
            depth, z = None, meta(N, S)
            fr.fused_shade(packed, model.cfg, ro, rd, z, dtype=dtype)
        want = [ro, rd, depth, z, Out(6, N), fr.pack_slices(packed), *nerf_vectors(packed)]
        return want, nerf_matrices(packed)
    return case


def case_k4(precision):
    model, packed = nerf_pack(precision)
    pts, dirs, slices = meta(N * S, 3), meta(N, 3), fr.pack_slices(packed)
    k4.nerf_points_kernel(packed, model.cfg, pts, dirs, slices=slices)
    return [pts, dirs, Out(N * S, 4), slices, *nerf_vectors(packed)], nerf_matrices(packed)


def case_k5(precision, monkeypatch):
    model, packed = nerf_pack(precision)
    pts, dirs, g = meta(N * S, 3), meta(N, 3), meta(N * S, 4)
    monkeypatch.setattr(k5, "_unflatten_grads", lambda packed, dw, db: {})
    k5.nerf_points_bwd_kernel(packed, model.cfg, pts, dirs, g, want_dx=True)
    program = fr.wgmma_program(packed, backward=True, want_dx=True)
    bwd = fr.wgmma_slices(program[len(fr.wgmma_program(packed)):])
    # pts, dirs, g, dx, the workspace, the bias and weight-grad partials, dw, db, the masks, dL/dPE
    want = [pts, dirs, g, Out(N * S, 6), *(Out(1) for _ in range(7)), fr.pack_slices(packed), Equal(bwd)]
    return want + nerf_vectors(packed), [w for w, _ in program]


def hier_case(kernel):
    def case(precision):
        coarse, fine = small_nerf(D=4, skips=(1,), seed=3), small_nerf(D=4, skips=(1,), seed=4)
        if precision == "int8":
            packed = k67.qpack_hier(coarse, fine, (qpack(coarse)["calib"], qpack(fine, seed=1)["calib"]))
        else:
            packed = k67.pack_hier(coarse, fine, F32 if precision == "fp32" else BF16)
        ro, rd = meta(N, 3), meta(N, 3)
        k67.render_hier_kernel(packed, coarse.cfg, fine.cfg, ro, rd, n_coarse=8, n_importance=8,
                               seed=5 if kernel == "K6" else None, dtype=F32 if precision == "fp32" else BF16)
        c, f = packed["coarse"], packed["fine"]
        want = [ro, rd, None, Out(11, N), fr.pack_slices(c, sigma_only=True), fr.pack_slices(f),
                *nerf_vectors(c, sigma_only=True), *nerf_vectors(f)]
        return want, nerf_matrices(f) + [w for w, *_ in (fr.wgmma_qprogram(c, sigma_only=True) if precision == "int8"
                                                         else fr.wgmma_program(c, sigma_only=True))]
    return case


def case_k11(precision):
    cfg = MipNeRFConfig(num_samples=S)
    packed = k11.pack_mip(MipNeRF(cfg).to("meta"))  # on the rays' device, which K11 checks
    ro, rd, radii = meta(N, 3), meta(N, 3), meta(N)
    k11.render_mip_kernel(packed, cfg, ro, rd, radii)
    return [ro, rd, Out(N), Out(5, N), fr.pack_slices(packed), *nerf_vectors(packed)], nerf_matrices(packed)


CASES = {  # (kernel, precision): (C entry, the module whose check_cuda the meta tensors pass, the launch)
    ("K1", "bf16"): ("nst_depth_net_forward", k1, case_k1),
    ("K1", "fp32"): ("nst_depth_net_forward", k1, case_k1),
    **{(k, p): (e, fr, render_case(k)) for k, e, ps in (
        ("K2", "nst_render_around_depth", ("bf16", "int8")), ("K3", "nst_render_gaussian", ("bf16", "int8")),
        ("K8", "nst_render_linspace", ("bf16", "fp32", "int8")), ("K9", "nst_shade", ("bf16", "fp32", "int8")))
       for p in ps},
    ("K4", "bf16"): ("nst_nerf_points", k4, case_k4),
    ("K5", "bf16"): ("nst_nerf_points_bwd", k5, case_k5),
    ("K6", "bf16"): ("nst_render_hier", k67, hier_case("K6")),
    ("K6", "int8"): ("nst_render_hier", k67, hier_case("K6")),
    ("K7", "bf16"): ("nst_render_hier", k67, hier_case("K7")),
    ("K7", "int8"): ("nst_render_hier", k67, hier_case("K7")),
    ("K7", "fp32"): ("nst_render_hier", k67, hier_case("K7")),
    ("K11", "bf16"): ("nst_render_mip", None, case_k11),
}


def _bwd_sizes(m, D, skip_mask, total, slice_rows, out):
    """nst_nerf_points_bwd_sizes of the mocked library: the slice counts the wrapper checks."""
    model, packed = nerf_pack("bf16")
    out[6], out[7] = (len(fr.wgmma_slices(fr.wgmma_program(packed, backward=True, want_dx=dx)[
        len(fr.wgmma_program(packed)):])) for dx in (False, True))
    out[8] = fr.pack_slices(packed).shape[0]
    for i in range(6):
        out[i] = 1
    return 0


@pytest.mark.parametrize("key", list(CASES), ids=[f"{k}-{p}" for k, p in CASES])
def test_launch_passes_slices_then_epilogue_vectors_and_counts_once(monkeypatch, key):
    entry, module, case = CASES[key]
    seen = mocked_library(monkeypatch, module, entry, nst_nerf_points_bwd_sizes=_bwd_sizes)
    before = build.launches.copy()
    want, matrices = case(key[1], monkeypatch) if key[0] == "K5" else case(key[1])
    calls = [args for name, args in seen["calls"] if name == entry]
    assert len(calls) == (3 if key[0] == "K5" else 1)
    assert build.launches - before == {key: len(calls)}
    ptrs = seen["ptrs"]
    assert seen["count"] == len(ptrs) == len(want)
    for i, (got, w) in enumerate(zip(ptrs, want)):
        if isinstance(w, Out):
            assert got is not None and (len(w.shape) == 1 or tuple(got.shape) == w.shape), i
        elif isinstance(w, Equal):
            assert torch.equal(got, w.t), i
        else:
            assert got is w, i
    assert not any(p is m for p in ptrs for m in matrices)  # the slices are the matrices' only copy
    assert calls[-1][-1] == 0  # the current stream, appended by build.launch


OCCUPANCY = {  # the wrapper's kernel_occupancy call: (C entry, its arguments, the fields its out holds)
    "K1": (lambda: k1.kernel_occupancy(160_064, fp32=True), "nst_depth_net_occupancy", (1,), 3),
    "K2": (lambda: fr.kernel_occupancy(64, int8=True), "nst_render_around_depth_occupancy", (64, 1), 4),
    "K4": (lambda: k4.kernel_occupancy(196_608), "nst_nerf_points_occupancy", (), 3),
    "K6": (lambda: k67.kernel_occupancy(64, 128, fp32=True), "nst_render_hier_occupancy", (64, 128, 2), 4),
    "K11": (lambda: k11.kernel_occupancy(128), "nst_render_mip_occupancy", (128,), 4),
}


@pytest.mark.parametrize("kernel", list(OCCUPANCY))
def test_kernel_occupancy_goes_through_build_occupancy_on_the_card_in_use(monkeypatch, kernel):
    """Every kernel_occupancy asks its C entry through ``build.occupancy``:
    blocks per SM first, then the entry's other fields, and the SM count of
    the current card (here device 1 of 114 SMs), not of device 0."""
    run, entry, args, n_fields = OCCUPANCY[kernel]

    def fill(*call):
        assert call[:-1] == args and len(call[-1]) == n_fields
        for i in range(n_fields):
            call[-1][i] = 10 + i
        return 0

    mocked_library(monkeypatch, None, entry, **{entry: fill})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(build, "sm_count", lambda device: {1: 114}[torch.device(device).index])
    occ = run()
    assert occ["blocks_per_sm"] == 10 and occ["sms"] == 114
    fields = ("threads", "smem_bytes") if n_fields == 3 else ("rays_per_block", "threads", "smem_bytes")
    assert [occ[f] for f in fields] == list(range(11, 10 + n_fields))
    if kernel in ("K1", "K4"):  # the tiles a block walks, sized for the card in use
        tiles = k1.tiles_per_block(160_064, 114) if kernel == "K1" else k4.tiles_per_block(196_608, 114)
        assert occ["tiles_per_block"] == tiles == (22 if kernel == "K1" else 14)  # 19 and 12 on 132 SMs
