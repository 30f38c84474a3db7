"""Scene-level calibration for ``mlp_impl="cuda_int8"`` (nerf_sampling_tpu/render/quantize.py).

Bridges the loaded NeRFs and a scene to the static ``QuantCalib``s that the
int8 kernels need (``kernels/quant.py``): the rays come from the scene's
first train view, through the port's own ``get_rays``, so the calibrated
activation ranges cover the points the kernels will query. The Trainer
(and through it both CLIs) runs this once after restore, then carries the
returned Pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerf_sampling_tpu_torch.core.rays import get_rays
from nerf_sampling_tpu_torch.kernels.quant import calibrate_nerf_quant
from nerf_sampling_tpu_torch.render.engine import CUDA_INT8, NeRFParams, Pipeline


def scene_rays(scene, n_rays: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_rays`` rays [n, 3] spread evenly over the pixels of the scene's
    first train view (view 0 when it has no train views), on the CPU."""
    H, W, focal = scene.hwf
    H, W = int(H), int(W)
    K = scene.K
    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    view = int(scene.i_train[0]) if len(scene.i_train) else 0
    ro, rd = get_rays(H, W, K, np.asarray(scene.poses[view][:3, :4], np.float32))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    idx = torch.from_numpy(np.linspace(0, ro.shape[0] - 1, min(n_rays, ro.shape[0])).astype(int))
    return ro[idx], rd[idx]


def calibrate_pipeline(pipeline: Pipeline, params: NeRFParams, scene, n_rays: int = 512) -> Pipeline:
    """``pipeline`` with the (coarse, fine) QuantCalibs of ``params`` from the
    scene's first train view in ``quant_calib``.

    A no-op unless ``pipeline.mlp_impl`` is "cuda_int8". The calibration is
    tied to the weights of ``params``: calibrate again after loading others.
    """
    if pipeline.mlp_impl != CUDA_INT8:
        return pipeline
    ro, rd = scene_rays(scene, n_rays)
    kw = dict(near=pipeline.near, far=pipeline.far, multires=pipeline.multires,
              multires_views=pipeline.multires_views)
    qc = calibrate_nerf_quant(params.coarse, ro, rd, **kw)
    qf = calibrate_nerf_quant(params.fine, ro, rd, **kw) if params.fine is not None else qc
    return dataclasses.replace(pipeline, quant_calib=(qc, qf))
