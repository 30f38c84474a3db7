"""K6 and K7: the hierarchical pass as a hand-written CUDA kernel, with its plain version.

Replaces nerf_sampling_tpu/kernels/fused_hier.py::_call in both modes of
``fused_render_hier``: with a seed (K6), the frozen-NeRF target pass of
every depth-net train step; without (K7), the deterministic FULL_NERF eval
render. The kernel source is ``csrc/render_hier.cu``. Per ray:

1. coarse z: the [near, far] linspace (or lindisp) grid, jittered within
   each stratum by ``t_rand``;
2. the coarse NeRF's trunk and alpha head at those z (no rgb: only the
   weights are read), then the coarse weights;
3. ``u`` inverted through the CDF of ``weights[1:-1] + 1e-5`` over the
   coarse midpoints (``sample_pdf``);
4. the union of coarse and fine z, sorted stably (ties: coarse first), the
   full fine NeRF over it, compositing over a white background;
5. the argmax of the fine weights, first maximum in sorted order (the XLA
   path's rule, ``render/engine.py::_argmax_depth``): max_z, max_w, max_rgb.

In det mode (K7) the coarse z is the grid itself and u is the det
linspace; otherwise the draws come from Philox keyed by (seed, global ray
index) (``philox.hier_draws``), the global index of a launch's row r being
``ray_base + r`` (a rank's first row under data parallelism, 0 on one
device), or are injected. The seed is an int, or a 0-d integer tensor
on the rays' device: K6 then reads it from device memory at launch
(``seed_ptr`` of ``nst_render_hier``), so that a CUDA graph holding the
launch draws, at each replay, the seed written there before it
(train/dispatch.py); both give the same draws. ``render_hier_plain`` computes the
same in plain PyTorch: fp32 is the reference, bf16 rounds where the kernel
rounds; with draws of ``None`` it runs det mode, which the tests hold
against the Pallas kernel. K7 also runs fp32 (the COMPARE mode's kernels,
``pack_hier(..., torch.float32)``); K6 runs bf16 only. Both run int8 (W8A8,
K10) with ``qpack_hier``'s packs: the coarse sigma-only pass on the coarse
NeRF's int8 pack under its calib, the fine pass on the fine NeRF's under
its own (JAX ``fused_hier.py:136-139``); the plain version then runs
``quant.mlp_plain_q``. In every type the kernel's MLP is the wgmma core
(``csrc/mlp_wgmma.cuh``; int8 with s8 products, fp32 with 3xTF32 products
on one consumer warpgroup), fed each net's weight slices
(``fused_render.pack_slices``: sigma-only for the coarse net, the full
forward for the fine one; an int8 pack's are ``wgmma_qslices``' images, an
fp32 pack's ``wgmma_slices32``' hi and lo images), made once per pack and
kept in it; a launch hands them over before both packs' epilogue vectors
(``fused_render.pack_args``). A launch without them is refused.
"""

from __future__ import annotations

import torch

from nerf_sampling_tpu_torch.core.compositing import raw2outputs
from nerf_sampling_tpu_torch.core.sampling import sample_pdf, stratified_z_vals
from nerf_sampling_tpu_torch.kernels import build, philox, quant
from nerf_sampling_tpu_torch.kernels.fused_render import (
    MAX_SAMPLES,
    check_cuda,
    check_rays,
    dtype_name,
    epilogue_vectors,
    nerf_raw_plain,
    pack_args,
    pack_nerf,
    precision,
)
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig

_SIGMA_KEYS = ("w0", "trunk_w", "trunk_b", "skip_w", "alpha_w", "alpha_b")
_SIGMA_KEYS_Q = ("w0", "b0", "trunk_wq", "trunk_row", "skip_w", "skip_b", "alpha_w", "alpha_b", "calib")
HIER_OUTPUTS = ("rgb_map", "disp_map", "acc_map", "depth_map", "max_z", "max_w", "max_rgb")


def pack_hier(coarse: NeRF, fine: NeRF | None, dtype=torch.bfloat16) -> dict:
    """Both NeRFs in ``pack_nerf``'s layout: the coarse trunk and alpha head
    only, the whole fine net (the coarse net again when ``fine`` is None)."""
    c = pack_nerf(coarse, dtype)
    return {
        "coarse": {k: c[k] for k in _SIGMA_KEYS},
        "fine": pack_nerf(fine if fine is not None else coarse, dtype),
    }


def qpack_hier(coarse: NeRF, fine: NeRF | None, calib: tuple) -> dict:
    """``pack_hier``'s int8 counterpart: the coarse NeRF's trunk and alpha
    head under the coarse calib, the whole fine NeRF (the coarse one again
    when ``fine`` is None) under the fine calib; ``calib`` is the
    (coarse, fine) pair of ``quant.QuantCalib``s."""
    qc, qf = calib
    c = quant.qpack_nerf(coarse, qc)
    return {
        "coarse": {k: c[k] for k in _SIGMA_KEYS_Q},
        "fine": quant.qpack_nerf(fine if fine is not None else coarse, qf),
    }


def _seed_word(seed: int | torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    """``seed`` when it is a device seed (a 0-d int32 or int64 tensor on
    ``device``; the kernel reads its low 32 bits), None for an int or
    None; raises on any other tensor."""
    if not isinstance(seed, torch.Tensor):
        return None
    if seed.dim() != 0 or seed.dtype not in (torch.int32, torch.int64) or seed.device != device:
        raise ValueError(f"a device seed is a 0-d int32 or int64 tensor on {device}, got a {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return seed


def _check_envelope(n_coarse: int, n_importance: int) -> None:
    if n_coarse < 4:
        raise ValueError("the hierarchical pass needs n_coarse >= 4")
    if not 1 <= n_importance <= MAX_SAMPLES - n_coarse:
        raise ValueError(f"n_importance must be in [1, {MAX_SAMPLES - n_coarse}]")


def render_hier_plain(
    packed: dict,
    cfg_c: NeRFConfig,
    cfg_f: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    n_coarse: int = 64,
    n_importance: int = 128,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    lindisp: bool = False,
    t_rand: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    seed: int | torch.Tensor | None = None,
    ray_base: int = 0,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K6's computation in plain PyTorch; ``t_rand`` [N, Nc] and ``u`` [N, Nf]
    are the draws, or with ``seed`` (an int or a 0-d integer tensor, read
    here) they are K6's Philox draws of the global rays ``ray_base ..
    ray_base + N - 1`` (neither: det mode). Returns the maps and argmax
    diagnostics."""
    _check_envelope(n_coarse, n_importance)
    if seed is not None:
        if t_rand is not None or u is not None:
            raise ValueError("give a seed or the draws, not both")
        _seed_word(seed, rays_o.device)
        draws = philox.hier_draws(int(seed), rays_o.shape[0], n_coarse + n_importance,
                                  ray0=ray_base).to(rays_o.device)
        t_rand, u = draws[:, :n_coarse], draws[:, n_coarse:]
    if (t_rand is None) != (u is None):
        raise ValueError("give both draws (t_rand and u) or neither (det mode)")
    kw = dict(multires=multires, multires_views=multires_views, dtype=dtype)
    near_t = torch.full_like(rays_o[:, :1], near)
    far_t = torch.full_like(rays_o[:, :1], far)
    z_c = stratified_z_vals(near_t, far_t, n_coarse, perturb=1.0 if t_rand is not None else 0.0,
                            lindisp=lindisp, t_rand=t_rand)
    sigma_c = nerf_raw_plain(packed["coarse"], cfg_c, rays_o, rays_d, z_c, sigma_only=True, **kw)
    # raw2outputs reads only the sigma channel for the weights
    raw_c = torch.cat([torch.zeros_like(sigma_c)[..., None].expand(*sigma_c.shape, 3),
                       sigma_c[..., None]], -1)
    weights_c = raw2outputs(raw_c, z_c, rays_d, 0.0, white_bkgd).weights
    mids = 0.5 * (z_c[..., 1:] + z_c[..., :-1])
    z_f = sample_pdf(mids, weights_c[..., 1:-1], n_importance, det=u is None, u=u)
    z = torch.sort(torch.cat([z_c, z_f], -1), dim=-1, stable=True).values
    raw = nerf_raw_plain(packed["fine"], cfg_f, rays_o, rays_d, z, **kw)
    out = raw2outputs(raw, z, rays_d, 0.0, white_bkgd)
    top = torch.argmax(out.weights, dim=1, keepdim=True)  # first maximum in sorted order
    rgb = torch.sigmoid(raw[..., :3])
    return {
        "rgb_map": out.rgb_map,
        "disp_map": out.disp_map,
        "acc_map": out.acc_map,
        "depth_map": out.depth_map,
        "max_z": torch.gather(z, 1, top)[:, 0],
        "max_w": torch.gather(out.weights, 1, top)[:, 0],
        "max_rgb": torch.gather(rgb, 1, top[..., None].expand(-1, 1, 3))[:, 0],
    }


def render_hier_kernel(
    packed: dict,
    cfg_c: NeRFConfig,
    cfg_f: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    n_coarse: int = 64,
    n_importance: int = 128,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    lindisp: bool = False,
    seed: int | torch.Tensor | None = None,
    ray_base: int = 0,
    draws: torch.Tensor | None = None,
    multires: int = 10,
    multires_views: int = 4,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """K6 over N rays [N, 3]: draws from Philox keyed by (``seed``, global
    ray index), the launch's row r being global ray ``ray_base + r``, the
    seed an int or a device seed (a 0-d int32 or int64 tensor on the rays'
    device, which the kernel reads at launch), or the
    injected ``draws`` [N, Nc + Nf] (t_rand, then u, by local row); K7 (det mode)
    when both are None, at ``dtype`` (``packed`` is ``pack_hier`` at it), or
    in int8 when ``packed`` is ``qpack_hier``'s (with the default dtype).

    On a CPU tensor this runs ``render_hier_plain`` at ``dtype`` with the
    same draws; on a CUDA tensor it launches the kernel, or raises on what
    it does not take.
    """
    _check_envelope(n_coarse, n_importance)
    det = seed is None and draws is None
    fp32 = dtype_name(dtype) == "fp32"
    if quant.is_int8(packed["fine"]) != quant.is_int8(packed["coarse"]):
        raise TypeError("the coarse and fine packs must both be int8 (qpack_hier) or neither")
    if fp32 and not det:
        raise ValueError("the seeded hierarchical pass (K6) runs bf16 only; fp32 is K7's det mode")
    seed_ptr = _seed_word(seed, rays_o.device) if draws is None else None
    n = rays_o.shape[0]
    n_draws = n_coarse + n_importance
    per_ray = {} if draws is None else {"draws": (draws, (n, n_draws))}
    check_rays(rays_o, rays_d, **per_ray)
    if rays_o.device.type == "cpu":
        epilogue_vectors(packed["coarse"], sigma_only=True, dtype=dtype)
        epilogue_vectors(packed["fine"], dtype=dtype)
        return render_hier_plain(
            packed, cfg_c, cfg_f, rays_o, rays_d, n_coarse=n_coarse, n_importance=n_importance,
            near=near, far=far, white_bkgd=white_bkgd, lindisp=lindisp,
            t_rand=None if draws is None else draws[:, :n_coarse], u=None if draws is None else draws[:, n_coarse:],
            seed=seed if draws is None else None, ray_base=ray_base,
            multires=multires, multires_views=multires_views, dtype=dtype,
        )
    c = pack_args(packed["coarse"], cfg_c, sigma_only=True, dtype=dtype)
    f = pack_args(packed["fine"], cfg_f, dtype=dtype)
    inputs = [rays_o, rays_d] + ([draws] if draws is not None else [])
    check_cuda(cfg_c, multires, multires_views, inputs, [c.slices, *c.vectors])
    check_cuda(cfg_f, multires, multires_views, inputs, [f.slices, *f.vectors])
    out = torch.empty((11, n), dtype=torch.float32, device=rays_o.device)
    build.launch(
        "K7" if det else "K6", precision(packed["fine"], dtype), "nst_render_hier",
        [rays_o, rays_d, draws, out, c.slices, f.slices, *c.vectors, *f.vectors], n, n_coarse, n_importance,
        cfg_c.D, c.skip_mask, cfg_f.D, f.skip_mask, float(near), float(far), int(bool(lindisp)),
        int(bool(white_bkgd)), None if seed_ptr is None else seed_ptr.data_ptr(),
        0 if seed is None or isinstance(seed, torch.Tensor) else int(seed) & 0xFFFFFFFF,
        int(ray_base), int(det), int(fp32), build.host_pointer(c.plan), build.host_pointer(f.plan),
    )
    return {
        "rgb_map": out[0:3].T, "disp_map": out[3], "acc_map": out[4], "depth_map": out[5],
        "max_z": out[6], "max_w": out[7], "max_rgb": out[8:11].T,
    }


def kernel_occupancy(n_coarse: int = 64, n_importance: int = 128, int8: bool = False,
                     fp32: bool = False) -> dict[str, int]:
    """The launch shape of K6/K7 in bf16, of the int8 kernel with ``int8``
    or of the fp32 one (K7 in COMPARE) with ``fp32``, at ``n_coarse +
    n_importance`` samples: resident blocks per SM, rays per block, threads
    per block, dynamic shared memory (bytes), and the card's SM count (for
    the wave count)."""
    if int8 and fp32:
        raise ValueError("one kernel: int8 or fp32")
    return build.occupancy("nst_render_hier_occupancy", n_coarse, n_importance, 1 if int8 else 2 if fp32 else 0)


def fused_render_hier(
    packed: dict,
    cfg_c: NeRFConfig,
    cfg_f: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    seed: int | torch.Tensor | None,
    ray_base: int = 0,
    n_coarse: int = 64,
    n_importance: int = 128,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    lindisp: bool = False,
    multires: int = 10,
    multires_views: int = 4,
    draws: torch.Tensor | None = None,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """The hierarchical pass of [N, 3] rays
    (nerf_sampling_tpu/kernels/fused_hier.py::fused_render_hier): seeded
    through K6 (its rows being the global rays from ``ray_base`` on; the
    seed an int or a 0-d integer tensor on the rays' device), or
    deterministic through K7 with ``seed=None``; ``packed``
    is ``pack_hier(coarse, fine, dtype)`` of the NeRFs as they are now, or
    ``qpack_hier`` for int8."""
    return render_hier_kernel(
        packed, cfg_c, cfg_f, rays_o.contiguous(), rays_d.contiguous(), n_coarse=n_coarse,
        n_importance=n_importance, near=near, far=far, white_bkgd=white_bkgd, lindisp=lindisp,
        seed=seed, ray_base=ray_base, draws=draws, multires=multires, multires_views=multires_views, dtype=dtype,
    )
