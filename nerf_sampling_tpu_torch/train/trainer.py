"""Training on one device or data-parallel over ranks (nerf_sampling_tpu/train/trainer.py).

``Trainer`` runs the three train modes of the JAX Trainer:

- ``"depth_net"``: the DepthNet against a frozen NeRF (``ft_path`` or the
  newest NeRF checkpoint of the experiment); the DepthNet from
  ``depth_net_path``, the newest ``depth_*.npz``, a DepthNet inside the
  ``ft_path`` checkpoint, or a fresh one from ``seed``. Checkpoints
  ``depth_{i:06d}.npz``; evals DEPTH_NET (FULL_NERF with ``use_full_nerf``).
- ``"nerf"``: coarse and fine NeRFs from ``seed`` or restored (``ft_path``
  or the newest ``{i:06d}.npz``, whose Adam moments and step come back
  with them). Checkpoints ``{i:06d}.npz``; evals FULL_NERF.
- ``"joint"``: the NeRFs and the DepthNet together, restored as in nerf
  mode (a joint ``.npz`` carries the DepthNet and its Adam state), with
  ``joint_depth_warmup``. Evals DEPTH_NET.

Around the loop: the scene (``dataset_type`` blender, llff, LINEMOD or
deepvoxels; the llff, LINEMOD and deepvoxels loaders set ``cfg.near`` and
``cfg.far``, and an NDC pipeline takes the scene's H, W and focal),
``args.txt``, the periodic
checkpoint, test-set eval (in the eval mode the config names: DEPTH_NET,
FULL_NERF, COMPARE_NERF or NERF_MAX), ``keep_best``, early stop, the
train-set render and the spiral video of the JAX Trainer (:719-831,
:922-945); ``render_only`` renders the test views or the spiral path
instead of training (:951-993). Checkpoints are the JAX package's ``.npz``
layout, readable by both packages, with the Adam moments, so a resume is
exact; with ``export_torch_ckpt`` (the default, as in JAX) each one also
gets a reference-format ``{i:06d}.tar`` beside it (train/checkpoint.py),
and ``ft_path``, ``depth_net_path`` and the resume scan read such a
``.tar`` as the JAX Trainer does: its NeRFs, its DepthNet and its step,
never its optimizer moments. The Trainer runs on the card unless it is
given ``device="cpu"``.

Around the steps, as the JAX Trainer (:490-568, :830-850): ``profile_dir``
traces steps [start+20, start+40) with torch.profiler into
``profile_dir/trace.json``, with the recorder's spans, counts and each
step's phase times beside it in ``spans.json`` (utils/profiling.py); ``debug_nans`` raises at
the first module output that holds a NaN and runs autograd's anomaly mode
(rays that miss the DepthNet's sphere give NaN by design: see
``nan_checks``); ``wandb_mode`` logs to wandb where it is installed, else
to ``metrics.jsonl``; a ``trial`` (optuna's, or any object with
``report`` and ``should_prune``) gets the PSNR at every ``i_print`` and
may prune the run (``TrialPruned``).

The models a run starts from are the JAX Trainer's for ``cfg.seed``,
bit for bit (``_initial_models``, core/prng.py), so a seed starts the same
run in both packages. The seed of step i is a pure function of
(``cfg.seed``, i), as JAX's ``fold_in(base_key, i)``, so a resumed run
draws what an unbroken run draws at the same step. With ``mlp_impl="cuda"`` every kernel pack an eval
reads is made anew before the eval, fp32 ones included (the DepthNet's in
depth-net mode, where the NeRF is frozen and its packs are made once; all
of them in nerf and joint mode); the nerf and joint steps pack the live
NeRF weights for K4/K5 on every query. ``mlp_impl="cuda_int8"`` (the JAX
"pallas_int8") calibrates the restored NeRFs once on the scene's first
train view (``render/quantize.py``) and packs them in int8 (the
DepthNet's pack stays bf16): the depth-net step's K6 oracle and the evals
then run the int8 kernels. It needs a frozen NeRF: nerf and joint training raise, as the JAX
Trainer does, unless they only render (``render_only``).

Data parallelism (JAX :103-114, :287-375, :500-560, :736-800): with
``n_devices`` > 1 (0: every rank) or ``multihost`` the Trainer is one rank
of a torch.distributed process group, one process per card: the group
its caller formed (``experiments/run.py --n_devices N`` spawns the ranks),
or the one a launcher describes (torchrun's ``env://`` variables;
``multihost`` needs them and takes every rank, on the hybrid mesh). Each
rank derives the same global batch from the shared sampler stream and
keeps its rows (``N_rand`` must divide by the world size), the models
are broadcast from rank 0 at setup, the steps average the gradients and
metrics over the ranks (parallel/ops.py), and the evals render through
``render_image_sharded``, so every rank sees the same PSNR and makes the
same keep_best and early-stop decisions. Only rank 0 (``primary``) writes:
args.txt, checkpoints, psnr.txt, PNGs, videos, the trace and the metrics
logger. The device is ``cuda:LOCAL_RANK`` unless one is given.

``steps_per_dispatch`` (JAX :577-712): K steps per host sync, the
counterpart of the JAX Trainer's scanned loop (``resolve_steps_per_dispatch``
gives K; 0 is auto). The loop then runs chunks of K steps through
``train/dispatch.py``: on the card each step after the first of its graph
replays a captured CUDA graph, on the CPU the steps run eagerly; either way
the run equals the per-step loop bit for bit (same sampler stream, same
per-step seeds). The chunk's metrics are read once, each step is logged
from them, and the next chunk's batches are sampled before that read, so
the sampler's host work overlaps the device. K divides the logging
cadences, so checkpoints, evals and early stops fall on chunk ends. On an
nccl mesh the chunks capture the sharded steps with their all-reduces (as
the JAX scan is jitted with the batch stack sharded on rays); a gloo mesh
on the card runs per step, since its collectives copy through the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from nerf_sampling_tpu_torch.core import prng
from nerf_sampling_tpu_torch.core.metrics import to8b
from nerf_sampling_tpu_torch.data.types import SceneData
from nerf_sampling_tpu_torch.models import DepthNet, NeRF
from nerf_sampling_tpu_torch.models.depth_net import init_like_jax as depth_init_like_jax
from nerf_sampling_tpu_torch.models.nerf import init_like_jax as nerf_init_like_jax
from nerf_sampling_tpu_torch.render.engine import (
    CUDA_INT8,
    KERNEL_IMPLS,
    EvalMode,
    NeRFParams,
    check_eval_envelope,
    eval_packs,
    make_nerf_slices,
    pack_kernel_weights,
    quant_pair,
    repack_depth,
)
from nerf_sampling_tpu_torch.render.path import render_path
from nerf_sampling_tpu_torch.render.quantize import calibrate_pipeline
from nerf_sampling_tpu_torch.train import checkpoint as ckpt_lib
from nerf_sampling_tpu_torch.train.dispatch import StepDispatcher
from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
from nerf_sampling_tpu_torch.train.state import TrainState, init_nerf_state, init_state, nerf_modules
from nerf_sampling_tpu_torch.train.steps import (
    make_depth_net_train_step,
    make_joint_train_step,
    make_nerf_train_step,
)
from nerf_sampling_tpu_torch.utils.config import TrainerConfig
from nerf_sampling_tpu_torch.utils.logging import MetricsLogger
from nerf_sampling_tpu_torch.utils.profiling import StepTimer, nan_checks, step_phases, trace
from nerf_sampling_tpu_torch.utils.video import write_video

TRAIN_MODES = ("depth_net", "nerf", "joint")
PROFILE_START, PROFILE_STOP = 20, 40  # the traced steps, after start (the JAX Trainer's window)


class TrialPruned(Exception):
    """Raised by the pruning hook when optuna is not installed (optuna's own
    TrialPruned is raised when it is)."""


def step_seed(seed: int, i: int) -> int:
    """The seed of train step ``i``: a pure function of (seed, i) in [0, 2^31)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0] >> 1)


def _host_copy_reason(mesh) -> str | None:
    """Why the collectives of ``mesh`` cannot be captured on the card, or
    None: only NCCL's run on the device, gloo's go through a host copy
    (parallel/mesh.py::host_side), and a CUDA graph holds no host copy."""
    if mesh is None or mesh.backend == "nccl":
        return None
    return (f"a {mesh.backend} mesh of ranks: {mesh.backend}'s collectives go through host copies, which a "
            "captured CUDA graph cannot hold (NCCL is the backend whose collectives are captured)")


def resolve_steps_per_dispatch(cfg: TrainerConfig, N_iters: int, start: int, device_type: str,
                               mesh=None) -> int:
    """Steps per host sync (``cfg.steps_per_dispatch``; 0 is auto), the JAX
    ``Trainer._resolve_scan_steps`` (:577-630) as a pure function.

    ``profile_dir`` (a per-step trace) or a run of at most 2 steps gives 1.
    An explicit K >= 1 is rounded down to a divisor of the gcd of
    ``i_print``, ``i_weights``, ``i_testset`` and ``i_video``, so that
    chunk ends fall on every checkpoint, eval and log step. Auto gives 1 on
    the CPU (no launch latency to amortize), elsewhere the largest divisor
    of that gcd up to 100, on one rank and on an NCCL mesh alike (a
    captured step holds its all-reduces). Two rules on the card: a mesh of
    another backend (gloo's collectives go through host copies) and
    ``debug_nans`` (its checks read every module output on the host) make
    auto 1 and an explicit K > 1 an error, since a captured step can do
    neither.
    """
    if cfg.profile_dir is not None or N_iters - start <= 2:
        return 1
    g = math.gcd(math.gcd(cfg.i_print, cfg.i_weights), math.gcd(cfg.i_testset, cfg.i_video))
    host_copy = _host_copy_reason(mesh)
    if cfg.steps_per_dispatch >= 1:
        n = cfg.steps_per_dispatch
        while g % n != 0:
            n -= 1
        if n != cfg.steps_per_dispatch:
            print(f"[trainer] steps_per_dispatch={cfg.steps_per_dispatch} does not divide the logging cadences "
                  f"(gcd {g}); using {n} so checkpoints/logs stay step-exact")
        if n > 1 and device_type == "cuda":
            if host_copy is not None:
                raise ValueError(f"steps_per_dispatch={n} on {host_copy}; use steps_per_dispatch 0 or 1")
            if cfg.debug_nans:
                raise ValueError(f"steps_per_dispatch={n} with debug_nans: the NaN checks read every module "
                                 "output on the host, which a captured step cannot; use steps_per_dispatch 0 or 1")
        return n
    if device_type != "cuda":
        return 1
    if host_copy is not None or cfg.debug_nans:
        print("[trainer] steps_per_dispatch auto: 1 step per dispatch ("
              + (host_copy if host_copy is not None else "debug_nans reads every module output") + ")")
        return 1
    return max(k for k in range(1, min(g, 100) + 1) if g % k == 0)


def _initial_models(p, seed: int, with_depth: bool) -> tuple:
    """The coarse and fine NeRFs and the DepthNet (None where the pipeline
    has none) with the JAX Trainer's initial weights for ``seed``
    (``_init_params``: keys 0, 1 and 2 of ``split(PRNGKey(seed), 3)``),
    made without touching the global RNG."""
    k_coarse, k_fine, k_depth = prng.split(prng.prng_key(seed), 3)
    with torch.random.fork_rng(devices=[]):
        coarse = nerf_init_like_jax(NeRF(p.nerf), k_coarse)
        fine = nerf_init_like_jax(NeRF(p.fine), k_fine) if p.fine is not None else None
        depth = depth_init_like_jax(DepthNet(p.depth), k_depth) if with_depth else None
    return coarse, fine, depth


class Trainer:
    """Trains the DepthNet, the NeRFs or both (``cfg.train_mode``) on one
    device: the card (``device=None``: "cuda", ``cuda:LOCAL_RANK`` on a
    rank, and a RuntimeError when no card is found), or the device given,
    such as "cpu". ``trial`` is an optuna trial (optional, for pruning)."""

    def __init__(self, cfg: TrainerConfig, device: torch.device | str | None = None, trial=None):
        if cfg.train_mode not in TRAIN_MODES:
            raise ValueError(f"train_mode must be one of {TRAIN_MODES}, got {cfg.train_mode!r}")
        if cfg.mlp_impl in (CUDA_INT8, "pallas_int8") and cfg.train_mode in ("nerf", "joint") \
                and not cfg.render_only:
            # the calibration is made once, on the restored NeRF: modes that then
            # update it would eval (and pick keep_best) through stale scales
            raise ValueError(
                f"mlp_impl={cfg.mlp_impl!r} requires a frozen NeRF (its activation calibration is "
                f"per-checkpoint); train_mode={cfg.train_mode!r} updates the NeRF. Use mlp_impl='cuda' "
                "for nerf/joint training; int8 is for depth_net training and render-only evaluation."
            )
        self.cfg = cfg
        self.trial = trial
        pipe = cfg.pipeline(with_depth=False)  # the envelope reads the NeRF side
        if pipe.mlp_impl in KERNEL_IMPLS:
            # the kernels' eval envelope, checked now: the first eval would
            # otherwise raise after i_testset steps and a checkpoint
            try:
                check_eval_envelope(pipe, self._eval_mode())
            except ValueError as err:
                raise ValueError(
                    f"{err}. This run's evals ({self._eval_mode().name}) cannot run on the kernels: use "
                    "-m recommended_depth_net_module, a model entry with a uniform or gaussian sampling_mode, "
                    "or --mlp_impl plain"
                ) from err
        self.device = torch.device("cuda" if device is None else device)
        self.mesh = self._setup_mesh()
        if device is None and self.mesh is not None:
            self.device = torch.device("cuda", self.mesh.local_rank)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: the Trainer runs on the card unless it is "
                               "given device='cpu' (--device cpu on the command line)")
        if self.mesh is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # nccl's collectives run on the current device
        self.global_step = 0
        self.start = 0
        self.steps_per_dispatch = 1  # what train() resolved cfg.steps_per_dispatch to
        self.captured_graphs = 0  # the CUDA graphs its chunks captured (0 per step and off the card)
        self.scene: SceneData | None = None
        self.pipeline = None
        self.params: NeRFParams | None = None
        self.eval_params: NeRFParams | None = None  # what the last eval rendered
        self.logger: MetricsLogger | None = None
        self._resume_tree: dict | None = None  # the checkpoint whose optimizer state resumes
        self._nerf_state: TrainState | None = None
        self._depth_state: TrainState | None = None
        self._avg_eval_psnr = 0.0
        self._best_psnr = -float("inf")
        self._evals_since_best = 0
        self._stop_early = False

    @property
    def expdir(self) -> str:
        return os.path.join(self.cfg.basedir, self.cfg.expname)

    @property
    def primary(self) -> bool:
        """True on the rank that writes every file (rank 0, or the only
        process). Every rank runs the evals and makes the same decisions
        from their gathered, identical maps."""
        return self.mesh is None or self.mesh.rank == 0

    def _setup_mesh(self):
        """The rank mesh of ``n_devices`` / ``multihost``, or None for one
        device (JAX :287-331). Joins the launcher's process group where
        there is one and no group exists yet."""
        cfg = self.cfg
        if cfg.n_devices == 1 and not cfg.multihost:
            return None
        from nerf_sampling_tpu_torch.parallel import make_hybrid_mesh, make_mesh, maybe_initialize_distributed

        joined = maybe_initialize_distributed(cfg, device=self.device)
        world = dist.get_world_size() if joined else 1
        if cfg.multihost:
            if cfg.n_devices not in (0, world):
                raise ValueError(f"multi-process training uses ALL ranks: n_devices={cfg.n_devices} but the "
                                 f"process group has {world} (set n_devices=0)")
            mesh = make_hybrid_mesh()
            if mesh.rank == 0:
                print(f"[trainer] multi-host data-parallel: {mesh.shape[0]} hosts x {mesh.shape[1]} ranks "
                      "(hybrid [dcn, rays] mesh)")
            return mesh
        n = world if cfg.n_devices == 0 else cfg.n_devices
        if n > 1 and not joined:
            raise ValueError(
                f"n_devices={n} needs {n} ranks, one process per card: run `python3 -m "
                f"nerf_sampling_tpu_torch.experiments.run --n_devices {n} ...`, which starts them, or start "
                f"them with `torchrun --nproc_per_node {n}`")
        if n != world:
            raise ValueError(f"n_devices={n} but the process group has {world} ranks (one per card)")
        if n == 1:
            return None
        mesh = make_mesh(n)
        if mesh.rank == 0:
            print(f"[trainer] data-parallel over {n} ranks")
        return mesh

    def _barrier(self) -> None:
        """Wait for every rank (where a read depends on rank 0's writes)."""
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group)

    def load_data(self) -> SceneData:
        """The scene of ``dataset_type`` (the reference's per-dataset trainers)."""
        cfg = self.cfg
        if cfg.dataset_type == "blender":
            from nerf_sampling_tpu_torch.data.blender import load_blender_data

            scene = load_blender_data(cfg.datadir, cfg.half_res, cfg.testskip)
            if cfg.white_bkgd:
                scene.composite_white_background()
            else:
                scene.drop_alpha()
            scene.near, scene.far = cfg.near, cfg.far
            return scene
        if cfg.dataset_type == "llff":
            from nerf_sampling_tpu_torch.data.llff import load_llff_scene

            return load_llff_scene(cfg)
        if cfg.dataset_type == "LINEMOD":
            from nerf_sampling_tpu_torch.data.linemod import load_linemod_scene

            return load_linemod_scene(cfg)
        if cfg.dataset_type == "deepvoxels":
            from nerf_sampling_tpu_torch.data.deepvoxels import load_deepvoxels_scene

            return load_deepvoxels_scene(cfg)
        raise ValueError(f"unknown dataset_type {cfg.dataset_type}")

    def create_log_dir_and_dump_config(self) -> None:
        """args.txt and a copy of the config file (reference Trainer.py:148-160);
        rank 0 only."""
        if not self.primary:
            return
        os.makedirs(self.expdir, exist_ok=True)
        with open(os.path.join(self.expdir, "args.txt"), "w") as f:
            for k, v in dataclasses.asdict(self.cfg).items():
                f.write(f"{k} = {v}\n")
        if self.cfg.config_path is not None and os.path.exists(self.cfg.config_path):
            with open(self.cfg.config_path) as src, open(
                os.path.join(self.expdir, "config.txt"), "w"
            ) as dst:
                dst.write(src.read())

    def setup_models(self) -> None:
        """The NeRFs and the DepthNet, restored as the JAX Trainer restores
        them (:170-281), and the step to resume from."""
        cfg = self.cfg
        with_depth = cfg.train_mode in ("depth_net", "joint")
        p = self.pipeline = cfg.pipeline(with_depth=with_depth)
        if p.ndc and self.scene is not None:  # the steps see flat ray batches: the reprojection's geometry rides here
            H, W, focal = self.scene.hwf
            p = self.pipeline = dataclasses.replace(p, H=int(H), W=int(W), focal=float(focal))
        coarse, fine, depth = _initial_models(p, cfg.seed, with_depth)
        explicit_depth = cfg.depth_net_path not in (None, "None")

        if cfg.ft_path not in (None, "None"):
            if not os.path.exists(cfg.ft_path):
                raise FileNotFoundError(f"ft_path {cfg.ft_path} does not exist")
            nerf_ckpts = [cfg.ft_path]
        else:
            nerf_ckpts = ckpt_lib.find_checkpoints(self.expdir, r"^(?!depth_).*\.(npz|tar)$")
        nerf_start = 0
        if nerf_ckpts and not cfg.no_reload:
            path = nerf_ckpts[-1]
            print(f"Reloading NeRF from {path}")
            if path.endswith(".tar"):  # the reference format: no optimizer state is read
                sds = ckpt_lib.import_torch_checkpoint(path)
                nerf_start = sds["global_step"]
            else:
                tree, nerf_start = ckpt_lib.load_checkpoint(path)
                sds = ckpt_lib.params_from_jax(tree["params"])
                if cfg.train_mode in ("nerf", "joint"):
                    self._resume_tree = tree
            coarse.load_state_dict(sds["coarse"], strict=True)
            if fine is not None and sds.get("fine") is not None:
                fine.load_state_dict(sds["fine"], strict=True)
            if depth is not None and sds.get("depth") is not None and not explicit_depth:
                depth.load_state_dict(sds["depth"], strict=True)  # a joint checkpoint, or a .tar's
                print(f"Reloading DepthNet from {path}")

        depth_start = 0
        if with_depth:
            if explicit_depth:
                if not os.path.exists(cfg.depth_net_path):
                    raise FileNotFoundError(f"depth_net_path {cfg.depth_net_path} does not exist")
                depth_ckpts = [cfg.depth_net_path]
            else:
                depth_ckpts = ckpt_lib.find_checkpoints(self.expdir, r"^depth_.*\.npz$")
            if depth_ckpts and not cfg.no_reload:
                path = depth_ckpts[-1]
                print(f"Reloading DepthNet from {path}")
                if path.endswith(".tar"):
                    sds = ckpt_lib.import_torch_checkpoint(path)
                    depth_start = sds["global_step"]
                    if sds["depth"] is not None:
                        depth.load_state_dict(sds["depth"], strict=True)
                else:
                    tree, depth_start = ckpt_lib.load_checkpoint(path)
                    depth.load_state_dict(ckpt_lib.params_from_jax(tree["params"])["depth"], strict=True)
                    self._resume_tree = tree
        self.start = depth_start if cfg.train_mode == "depth_net" else nerf_start
        self.global_step = self.start

        dev = self.device
        if cfg.train_mode == "depth_net":
            coarse.eval()
            if fine is not None:
                fine.eval()
        params = NeRFParams(coarse.to(dev), fine.to(dev) if fine is not None else None,
                            depth.to(dev) if depth is not None else None)
        if self.mesh is not None:  # every rank starts from rank 0's models
            from nerf_sampling_tpu_torch.parallel import replicate

            for m in params[:3]:
                if m is not None:
                    replicate(self.mesh, m)
        # (under cuda_int8 every rank then calibrates the same models on the same view: the same scales)
        # int8: the static calibration of the NeRFs restored here (a no-op otherwise)
        p = self.pipeline = calibrate_pipeline(p, params, self.scene)
        if p.mlp_impl in KERNEL_IMPLS and cfg.train_mode == "depth_net":  # the frozen NeRF's packs, once
            # the oracle (K6, not under NDC) reads the hier packs, int8 ones under cuda_int8 whatever the eval mode
            params = pack_kernel_weights(params, **{**eval_packs(p, self._eval_mode(), params),
                                                    "with_hier": not p.ndc, "quant_pair": quant_pair(p, params)})
            make_nerf_slices(params.kernels)
        self.params = params

    def _restored_opt(self, key: str) -> dict | None:
        tree = self._resume_tree
        return tree.get(key) if tree is not None else None

    def _make_states(self):
        """The train states of the mode, their optimizer state restored
        from the resume checkpoint where it has one, and the step function."""
        cfg, p = self.cfg, self.params
        if cfg.train_mode == "depth_net":
            state = init_state(p.depth, cfg.depth_net_lr, self.start)
            opt = self._restored_opt("opt_state")
            if opt is not None:
                ckpt_lib.adam_state_from_jax(opt, state.model, state.optimizer)
                print("Restored optimizer state")
            return state, None, self._step_maker("depth")(self.pipeline, p)
        nerf = init_nerf_state(nerf_modules(p.coarse, p.fine), cfg.lrate, cfg.lrate_decay, self.start)
        opt = self._restored_opt("opt_state")
        if opt is not None and ckpt_lib.nerf_adam_state_from_jax(opt, nerf.model, nerf.optimizer) is not None:
            print("Restored optimizer state")
        if cfg.train_mode == "nerf":
            return nerf, None, self._step_maker("nerf")(self.pipeline)
        depth = init_state(p.depth, cfg.depth_net_lr, self.start)
        opt = self._restored_opt("depth_opt_state")
        if opt is not None:
            ckpt_lib.adam_state_from_jax(opt, depth.model, depth.optimizer)
            print("Restored depth optimizer state")
        return nerf, depth, self._step_maker("joint")(self.pipeline)

    def _step_maker(self, kind: str):
        """The step maker of ``kind``: the one-device step, or on a mesh the
        data-parallel one of the rank's rows (parallel/ops.py)."""
        if self.mesh is None:
            return {"depth": make_depth_net_train_step, "nerf": make_nerf_train_step,
                    "joint": make_joint_train_step}[kind]
        from nerf_sampling_tpu_torch.parallel import ops

        maker = {"depth": ops.make_sharded_depth_train_step, "nerf": ops.make_sharded_nerf_train_step,
                 "joint": ops.make_sharded_joint_train_step}[kind]
        return functools.partial(maker, mesh=self.mesh)

    def train(self, N_iters: int = 200001) -> float:
        """Train to step N_iters - 1 and return the last step's PSNR; with
        ``render_only``, render instead and return the average PSNR."""
        cfg = self.cfg
        self.scene = self.load_data()
        self.create_log_dir_and_dump_config()
        self.setup_models()
        self.logger = MetricsLogger(self.expdir, cfg.wandb_mode, cfg, enabled=self.primary)
        if cfg.render_only:
            try:
                return self.render_only_path()
            finally:
                self.logger.close()
                self._barrier()
        sampler = RaySampler(
            self.scene,
            SamplerConfig(N_rand=cfg.N_rand, use_batching=not cfg.no_batching,
                          precrop_iters=cfg.precrop_iters, precrop_frac=cfg.precrop_frac,
                          single_image=cfg.single_image, single_ray=cfg.single_ray),
            seed=cfg.seed,
        )
        if self.mesh is not None:
            from nerf_sampling_tpu_torch.parallel import ray_rows, shard_ray_batch

            ray_rows(self.mesh, cfg.N_rand)  # raises when the batch does not split
        state, depth_state, step_fn = self._make_states()
        if cfg.train_mode == "depth_net":
            self._depth_state = state
        else:
            self._nerf_state, self._depth_state = state, depth_state
        timer = StepTimer(rays_per_step=cfg.N_rand, device=self.device)
        n_chunk = resolve_steps_per_dispatch(cfg, N_iters, self.start, self.device.type, self.mesh)
        self.steps_per_dispatch, self.captured_graphs = n_chunk, 0
        metrics: dict = {}
        with contextlib.ExitStack() as stack:
            stack.callback(self._barrier)  # a rank returns once rank 0's files are written
            stack.callback(self.logger.close)
            p = self.params
            if cfg.debug_nans:
                stack.enter_context(nan_checks(m for m in (p.coarse, p.fine, p.depth) if m is not None))
            if n_chunk > 1:
                return self._train_chunked(step_fn, state, depth_state, sampler, N_iters, timer, n_chunk)
            # the profiler's window: closed before step start+PROFILE_STOP, or when the loop ends
            profile = stack.enter_context(contextlib.ExitStack())
            for i in range(self.start + 1, N_iters):
                if cfg.profile_dir is not None and self.primary:
                    if i == self.start + PROFILE_START:
                        profile.enter_context(trace(cfg.profile_dir, self.device))
                    elif i == self.start + PROFILE_STOP:
                        profile.close()
                        print(f"profiler trace written to {cfg.profile_dir}")
                with record_function("train_step"):
                    batch = sampler.sample(i)
                    if self.mesh is not None:  # the rank's rows of the shared global batch
                        batch = shard_ray_batch(self.mesh, batch)
                    batch = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device) for x in batch)
                    seed = step_seed(cfg.seed, i)
                    with step_phases(self.device):
                        if cfg.train_mode == "joint":
                            state, depth_state, metrics = step_fn(state, depth_state, batch, seed)
                        else:
                            state, metrics = step_fn(state, batch, seed)
                    timer.tick()
                if cfg.debug_nans and not torch.isfinite(metrics["loss"]):  # a NaN no module output showed
                    raise FloatingPointError(f"step {i}: the loss is {float(metrics['loss'])}")
                self.global_step = i
                self.log(i, metrics, timer)
                if self._stop_early:
                    break
        return float(metrics["psnr"]) if metrics else 0.0

    def _train_chunked(self, step_fn, state, depth_state, sampler, N_iters: int, timer: StepTimer,
                       n_chunk: int) -> float:
        """The train loop with ``n_chunk`` steps per host sync (JAX
        ``_train_scanned``, :632-712): bit-identical to the per-step loop."""
        cfg = self.cfg
        if cfg.train_mode == "joint":
            warmup = self.pipeline.joint_depth_warmup
            dispatcher = StepDispatcher(lambda batch, seed: step_fn(state, depth_state, batch, seed)[2],
                                        [state, depth_state], self.device,
                                        graph_key=lambda: state.step >= warmup)
        else:
            dispatcher = StepDispatcher(lambda batch, seed: step_fn(state, batch, seed)[1], [state], self.device)

        def sample(i0: int, k: int) -> np.ndarray:
            """The [k, N, 9] batches of steps i0 .. i0 + k - 1 (the rank's rows on a mesh)."""
            batches = [sampler.sample(i) for i in range(i0, i0 + k)]
            if self.mesh is not None:
                from nerf_sampling_tpu_torch.parallel import shard_ray_batch

                batches = [shard_ray_batch(self.mesh, b) for b in batches]
            return np.stack([np.concatenate(b, -1) for b in batches])

        metrics: dict = {}
        i = self.start + 1
        k = min(n_chunk, N_iters - i)
        chunk = sample(i, k)
        while i < N_iters and not self._stop_early:
            with record_function("train_chunk"):
                ms = dispatcher.run(chunk, [step_seed(cfg.seed, i + j) for j in range(k)])
            # the next chunk's batches before the metrics read: the sampler's
            # host work overlaps the device's run of this chunk
            k_next = min(n_chunk, N_iters - (i + k))
            if k_next > 0:
                chunk = sample(i + k, k_next)
            host = dispatcher.read(ms)
            for j in range(k):
                timer.tick()
                metrics = {name: v[j] for name, v in host.items()}
                if cfg.debug_nans and not np.isfinite(metrics["loss"]):
                    raise FloatingPointError(f"step {i + j}: the loss is {float(metrics['loss'])}")
                self.global_step = i + j
                self.log(i + j, metrics, timer)
                if self._stop_early:
                    break
            i += k
            k = k_next
        self.captured_graphs = dispatcher.graphs
        return float(metrics["psnr"]) if metrics else 0.0

    def _eval_mode(self) -> EvalMode:
        cfg = self.cfg
        if cfg.use_nerf_max_pts:
            return EvalMode.NERF_MAX
        if cfg.use_full_nerf or cfg.train_mode == "nerf":
            return EvalMode.FULL_NERF
        if cfg.compare_nerf:
            return EvalMode.COMPARE_NERF
        return EvalMode.DEPTH_NET

    def _eval_params(self) -> NeRFParams:
        """The models with every kernel pack the eval mode reads made from
        their weights as they are now (the steps changed what the packs
        copied): the DepthNet's packs in depth-net mode, where the frozen
        NeRF's were made at setup; all of them in nerf and joint mode. The
        last eval's packs are let go first, so that two sets never coexist."""
        self.eval_params = None
        params = self.params
        if self.pipeline.mlp_impl in KERNEL_IMPLS:
            if self.cfg.train_mode == "depth_net":
                params = repack_depth(params)
            else:
                params = pack_kernel_weights(params._replace(kernels=None),
                                             **eval_packs(self.pipeline, self._eval_mode(), params))
        self.eval_params = params
        return params

    def _render(self, poses, seed: int = 0, **kw):
        """render_path of ``poses`` with the eval mode and fresh packs (sharded
        over the ranks on a mesh; ``savedir`` is the caller's, None off rank 0)."""
        return render_path(
            self.pipeline, self._eval_params(), poses, self.scene.hwf, self.scene.intrinsics(),
            device=self.device, mode=self._eval_mode(), chunk=self.cfg.chunk,
            generator=torch.Generator(device=self.device).manual_seed(seed), mesh=self.mesh, **kw,
        )

    def eval_testset(self, savedir: str | None, step: int = 0) -> float:
        """Render the test views with the models as they are now, each
        through the logger's ``log_render``; average PSNR."""
        scene = self.scene
        _, _, avg = self._render(scene.poses[scene.i_test], gt_imgs=scene.images[scene.i_test],
                                 savedir=savedir, verbose=False, logger=self.logger, step=step)
        return avg

    def save_spiral_video(self, i: int) -> None:
        """The spiral path rendered in the eval mode, as rgb and disparity
        videos ``{expname}_spiral_{i:06d}_{rgb,disp}`` (utils/video.py)."""
        rgbs, disps, _ = self._render(self.scene.render_poses, verbose=False)
        if not self.primary:
            return
        moviebase = os.path.join(self.expdir, f"{self.cfg.expname}_spiral_{i:06d}_")
        print("video:", write_video(moviebase + "rgb", to8b(rgbs)))
        if disps.ndim == 3:  # NERF_MAX's disparity is already [P, H, W, 3] (its zeros)
            disps = np.repeat(disps[..., None], 3, -1)
        print("video:", write_video(moviebase + "disp", to8b(disps / max(np.max(disps), 1e-8))))

    def render_only_path(self) -> float:
        """Render the test views (``render_test``) or the spiral path into
        ``renderonly_{test|path}_{step:06d}/`` (PNGs, psnr.txt, the scene
        data, a video); returns the average PSNR (0 without ground truth)."""
        cfg, scene = self.cfg, self.scene
        if cfg.render_test:
            poses, gt = scene.poses[scene.i_test], scene.images[scene.i_test]
        else:
            poses, gt = scene.render_poses, None
        savedir = os.path.join(
            self.expdir, f"renderonly_{'test' if cfg.render_test else 'path'}_{self.global_step:06d}")
        if self.primary:
            os.makedirs(savedir, exist_ok=True)
        rgbs, _, avg = self._render(poses, seed=cfg.seed, gt_imgs=gt, savedir=savedir if self.primary else None,
                                    render_factor=cfg.render_factor, save_scene_data=cfg.save_scene_data)
        if self.primary:
            print("Done rendering", savedir)
            print("video:", write_video(os.path.join(savedir, "video"), to8b(rgbs)))
        return avg

    def log(self, i: int, metrics: dict, timer: StepTimer | None = None) -> None:
        cfg, scene = self.cfg, self.scene
        if i % cfg.i_weights == 0:
            self.save_checkpoint(i)
        if i % cfg.i_testset == 0 and i > 0 and len(scene.i_test) > 0:
            # every rank renders (the sharded render) and decides; rank 0 writes
            testsavedir = self._savedir(f"testset_{i:06d}")
            avg_psnr = self.eval_testset(testsavedir, i)
            self._avg_eval_psnr = avg_psnr
            record = {"test_psnr": avg_psnr}
            line = f"Saved test set (avg PSNR {avg_psnr:.3f}"
            if self.device.type == "cuda":
                # live: what the run holds after the eval; max: the peak since the process
                # (or its caller) last reset it
                record["memory_allocated_mib"] = torch.cuda.memory_allocated(self.device) / 2**20
                record["max_memory_allocated_mib"] = torch.cuda.max_memory_allocated(self.device) / 2**20
                record["memory_reserved_mib"] = torch.cuda.memory_reserved(self.device) / 2**20
                line += (f", memory allocated {record['memory_allocated_mib']:.1f} MiB, "
                         f"max {record['max_memory_allocated_mib']:.1f} MiB, "
                         f"reserved {record['memory_reserved_mib']:.1f} MiB")
            self.logger.log(record, i)
            if self.primary:
                print(line + ")")
            if avg_psnr > self._best_psnr + 1e-6:
                self._best_psnr = avg_psnr
                self._evals_since_best = 0
                if cfg.keep_best:
                    self.save_checkpoint(i, subdir="best")
            else:
                self._evals_since_best += 1
                if 0 < cfg.early_stop_patience <= self._evals_since_best:
                    if self.primary:
                        print(f"Early stop at iter {i}: eval PSNR has not improved for "
                              f"{self._evals_since_best} evals (best {self._best_psnr:.3f})")
                    self._stop_early = True
            if cfg.save_train_set_render:
                self._render(scene.poses[scene.i_train[:10]], savedir=self._savedir(f"trainset_{i:06d}"),
                             verbose=False)
        if i % cfg.i_video == 0 and i > 0:
            self.save_spiral_video(i)
        if i % cfg.i_print == 0:
            m = {k: float(v) for k, v in metrics.items()}
            info = f"Iter: {i} Loss: {m['loss']}"
            scalars = {"Loss": m["loss"], "Depth net PSNR": m["psnr"]}
            # only the metrics the mode produces: nerf steps have no depth loss
            if "depth_net_loss" in m:
                info += f", Depth Net Loss: {m['depth_net_loss']}"
                scalars["Depth net loss"] = m["depth_net_loss"]
            for k in ("depth_loss_fg", "depth_loss_bg", "fg_frac", "depth_live"):
                if k in m:
                    scalars[k] = m[k]
            info += f", PSNR: {m['psnr']:.5f}"
            if timer is not None:
                scalars.update(timer.metrics())
            self.logger.log(scalars, i)
            self.logger.print_line(info)
            if self.trial is not None:
                self._report_trial(m["psnr"], i)

    def _savedir(self, name: str) -> str | None:
        """``expdir/name``, made, on rank 0; None on the other ranks."""
        if not self.primary:
            return None
        path = os.path.join(self.expdir, name)
        os.makedirs(path, exist_ok=True)
        return path

    def _report_trial(self, psnr: float, step: int) -> None:
        """The pruning hook (reference Trainer.py:393-398): report to the
        trial, and raise optuna's TrialPruned (this module's stand-in when
        optuna is not installed) when it says to prune."""
        self.trial.report(psnr, step)
        if self.trial.should_prune():
            try:
                import optuna

                exc = optuna.exceptions.TrialPruned
            except ImportError:
                exc = TrialPruned
            raise exc()

    def save_checkpoint(self, i: int, subdir: str = "") -> None:
        """The models and their Adam moments in the JAX layout:
        ``depth_{i:06d}.npz`` in depth-net mode, ``{i:06d}.npz`` in nerf and
        joint mode (joint adds the DepthNet's moments); subdir="best" keeps
        the keep_best snapshot out of the resume scan's way. With
        ``export_torch_ckpt`` (not under ``subdir``) a reference-format
        ``{i:06d}.tar`` goes beside it, each live Adam routed to its torch
        optimizer as the JAX Trainer routes them: the DepthNet's in
        depth_net mode (the frozen NeRF's optimizer written fresh), the
        NeRFs' in nerf mode, both in joint mode. Rank 0 only."""
        if not self.primary:
            return
        p = self.params
        sds = {"coarse": p.coarse.state_dict()}
        if p.fine is not None:
            sds["fine"] = p.fine.state_dict()
        if p.depth is not None:
            sds["depth"] = p.depth.state_dict()
        tree: dict = {"params": ckpt_lib.JaxNeRFParams(**ckpt_lib.params_to_jax(sds))}
        outdir = os.path.join(self.expdir, subdir) if subdir else self.expdir
        if self.cfg.train_mode == "depth_net":
            tree["opt_state"] = ckpt_lib.adam_state_to_jax(self._depth_state.model, self._depth_state.optimizer)
            path = os.path.join(outdir, f"depth_{i:06d}.npz")
        else:
            tree["opt_state"] = ckpt_lib.nerf_adam_state_to_jax(self._nerf_state.model,
                                                                 self._nerf_state.optimizer)
            if self._depth_state is not None:
                tree["depth_opt_state"] = ckpt_lib.adam_state_to_jax(self._depth_state.model,
                                                                     self._depth_state.optimizer)
            path = os.path.join(outdir, f"{i:06d}.npz")
        ckpt_lib.save_checkpoint(path, tree, i)
        if self.cfg.export_torch_ckpt and not subdir:
            cfg, nerf, depth = self.cfg, self._nerf_state, self._depth_state
            ckpt_lib.export_torch_checkpoint(
                os.path.join(self.expdir, f"{i:06d}.tar"), i, sds["coarse"], sds.get("fine"), sds.get("depth"),
                lrate=cfg.lrate, depth_net_lr=cfg.depth_net_lr, lrate_decay=cfg.lrate_decay,
                nerf_opt=(nerf.model, nerf.optimizer) if nerf is not None else None,
                depth_opt=(depth.model, depth.optimizer) if depth is not None else None,
            )
        print("Saved checkpoints at", path)

    def save_rays_data(self, rays_o, pts, alpha) -> str:
        """Ray data for later visualization, as safetensors (reference
        sampling_trainer.py:124-138); ``{expname}_{global_step}.safetensors``
        in the experiment directory; rank 0 writes it (every rank returns its name)."""
        from safetensors.numpy import save_file

        def f32(x) -> np.ndarray:
            x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
            return np.ascontiguousarray(x, dtype=np.float32)

        filename = os.path.join(self.expdir, f"{self.cfg.expname}_{self.global_step}.safetensors")
        if self.primary:
            save_file({"origins": f32(rays_o), "pts": f32(pts), "alpha": f32(alpha)}, filename)
        return filename
