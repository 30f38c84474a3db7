"""Drive the PyTorch port's render paths, its render CLI and three training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. Device: a CUDA device is required; prints nvidia-smi's name and power limit.
2. Build: compiles the hand-written kernels from ``nerf_sampling_tpu_torch/kernels/csrc``
   and prints each kernel's registers, spills and shared memory.
   [core]: one dense layer of the wgmma MLP core (csrc/mlp_wgmma.cuh, through
   csrc/wg_dense.cu) against torch.matmul of the same bf16 operands with fp32
   accumulation, at 64, 128 and ragged row counts, with and without a skip
   operand (CORE_ULP_TOL, CORE_FLIP_TOL); then one s8 layer (the int8 NeRF's
   products) whose int32 sums must equal an fp64 matmul of the int8 values
   exactly; then one fp32 layer (3xTF32 products, those of K1, K7 and K9
   in fp32) whose largest error from an fp64 matmul must be at most
   CORE32_TOL times strict-fp32 torch.matmul's; then the render kernels'
   PE fill (csrc/mlp_wgmma.cuh's stage_views and pe_fill, through
   wg_dense.cu's nst_pe_fill_check) against the per-column formula it
   replaced, on 1,048,576 rows and ragged launches at S 2, 64, 192 and
   512 with NaN depths, z inside and beyond [2, 6] and arguments past
   sinf's fast range: 0 bytes may differ; then the point-query kernels'
   PE fill (csrc/mlp_wgmma.cuh's point_fill, K4's and K5's, through
   wg_dense.cu's nst_point_fill_check) against the per-column formula it
   replaced, tiles and their inputs, in K4's form and K5's (rolled), on
   the train step's coarse (S 64) and fine (S 192) queries and ragged
   ones at S 1, 7 and 192 whose tiles start mid-ray, points up to 6 and
   past sinf's fast range, NaN points and directions: 0 bytes may
   differ; it fails before any NeRF kernel runs.
3. Kernel vs plain, on the committed checkpoint's weights, each held to
   its plain version at bf16 rounding with the tolerances below:
   K1 (DepthNet) on the 160,000 rays of test view 0 plus 64 rays that miss
   the bounding sphere (its launch shape, 160 threads and one block per SM,
   one tile alone and its registers printed); K2 (uniform populate-and-shade) and K3 (gaussian)
   on the same 160,000 rays in one launch at S=64, std=1.0, with 16 NaN
   depths spread among them (K3 with injected noise); K6 (the seeded
   hierarchical pass) on 1024-ray train batches with injected draws. K3
   and K6 also: one seed gives the same bits, the next seed others, and
   the mean rgb of the in-kernel draws matches torch draws.
4. The render path: the example scene (generated on first use), the
   production pipeline (lego.yaml's recommended_depth_net_module with
   run.py's overrides, uniform/64/distance 1.0), evidence/ckpt/
   example_depth.npz through the weight converter, the 4 test views with
   ``render_path`` on the kernels (K1 and K2 must launch), view 0 against
   the JAX package's fp32 render of it (REFERENCE_PSNR_VIEW0), the image
   std in evidence/ckpt/expected.json and the port's plain fp32 path; a
   400x400 frame timed on both paths, one kernel-path frame profiled.
5. The training path, through the CLI's main in process: the recipe with
   ``--mlp_impl cuda``, seed 42, a fresh DepthNet against a NeRF-only copy
   of the committed checkpoint, 2500 steps (K6, K1 and K3 must launch);
   the depth-net loss must fall, its median logged Depth Net Loss over the
   second half of the run (steps 1300-2500) must be at most DEPTH_LOSS_TOL,
   best/depth_002500.npz must exist, and the
   step-2500 eval must be at most EVAL_GAP_TOL dB below the committed
   DepthNet's under the same eval. Then one step on both paths from one
   state, batch and draws, the median step time on both paths, and one
   profiled kernel-path step with its phases.
6. NeRF and joint training, kernels first, on the committed checkpoint's
   NeRFs at the train step's shapes (1024 rays, 64 + 128 samples):
   [k4] K4 (the point-query MLP, on the wgmma core) on the coarse and fine
   queries against its plain bf16 version: at least as close to it as that
   version is to fp32; its launch shape (288 threads, one block per SM, one
   wave), one block alone and its registers at both sizes; [k5] K5 (its recompute backward) on the fine queries with a real
   step's cotangent: per-tensor error against its plain bf16 version, the
   param grads identical with and without dx and across launches, cosine
   to fp32 autograd of each NeRF; [k7] K7 (the deterministic hierarchical
   pass) over the 160,000 rays of test view 0 in one launch against its
   plain version, the FULL_NERF PSNR of view 0 within FULL_PSNR_TOL of the
   plain fp32 path, all 4 views and the frame time on both paths; [mip]
   K11 (mip-NeRF's two levels, render_mip.cu) on glorot weights from
   MIP_SEED: an 800x800 frame through render_image on a mip-NeRF Pipeline
   in one launch, bit for bit the direct launch on the same rays; the
   640,000 rays against its plain version in chunks, and ragged launches
   of MIP_RAGGED rays (not multiples of its 12 rays a block); rgb, depth
   (acc > 0.5) and acc within MIP_*_TOL, which K11 with mip-NeRF's
   disable_integration (the variances left out) must exceed; [step]
   one nerf step and one joint step from one state, batch and draws, cuda
   against plain, their median times and a profiled kernel-path nerf step;
   [nerf] the CLI from scratch, --mode nerf for NERF_ITERS steps on both
   paths (K4, K5 and K7 must launch; the loss must fall over the center-
   crop phase; the kernel run's
   FULL_NERF eval within NERF_EVAL_TOL dB of the plain run's); [joint] the
   CLI, --mode joint from the committed checkpoint (NeRFs and DepthNet)
   with a warmup, on both paths: the DepthNet bit for bit unchanged
   through the warmup and trained after it, depth_live 0 then 1, the
   kernel run's eval within NERF_EVAL_TOL dB of the plain run's. Both are
   printed beside the committed pair's under the same eval: the recipe
   restarts the NeRF's Adam at lrate (the checkpoint carries no optimizer
   state), and a converged NeRF loses about 2 dB in 300 such steps on
   either path (PERF.md).
7. The other eval modes (run after [k7], before the render path of 4.):
   [k8] K8 (the linspace render) over the 160,000 rays of view 0 in one
   launch with the fine NeRF's pack, at 64 and 192 samples, against its
   plain bf16 version (K2's bounds), fp32 on a slice against plain fp32,
   and FULL_NERF at N_importance 0 through the engine (K8 on the coarse
   NeRF) within FULL_PSNR_TOL of the plain fp32 path; [k9] K9 (shading
   given z) at bf16 and fp32 on the uniform and a sorted gaussian
   population of view 0 against its plain versions, and input_unsorted on
   a per-ray shuffled copy equal to the sorted input (1e-6), K9 fp32
   (3xTF32 on the wgmma core) with its time against both bounds, launch
   shape (160 threads, one block per SM), one block alone against its
   share of a wave, registers, and a launch without its weight slices
   refused; [fp32] the COMPARE mode's K1 (depth within 1e-4, the NaN mask
   equal) and K7 (max_z within 1e-3 on rays that hit the sphere, rgb
   FP32_RGB_TOL) against their plain fp32 versions, both (3xTF32 on the
   wgmma core) with their time against both bounds, launch shape (160
   threads, one block per SM), one block alone, registers, and a launch
   without the weight slices refused; [modes] COMPARE_NERF (PSNR within
   0.01 dB, compare MSE within 1%, max_z 1e-3) and NERF_MAX (PSNR within
   FULL_PSNR_TOL) over view 0, kernels against the plain fp32 path. After
   the render path, [render]: experiments/render.py's main over the 4 test
   views (a copy of the scene with one train view) in its default mode
   (the render path's PSNRs to 1e-4), -nc, -nm and -nf, each with its
   PNGs, psnr.txt (the MSE for -nc) and kernel launches, then the default
   mode and -nf again with --mlp_impl pallas_int8 (the int8 kernels must
   launch; PSNRs beside the bf16 ones); its -e grid on one view (32
   renders); one render_only render of the spiral path with its video.
   Each phase prints its seconds.
8. The int8 mode (W8A8, K10), after [modes]: [k10] calibrates the
   committed checkpoint's NeRFs on the example scene (the calib printed),
   then holds each int8 mode of the kernels to its plain int8 version on
   the card (K10_MEAN_TOL / K10_P999_TOL, percentiles: an int8 rounding
   that the fp32 summation order flips moves a sample): K2, K3 (injected
   noise), K8 and K9 over view 0's 160,000 rays at 64 samples with 16 NaN
   depths (NaN exactly there), K7 over view 0, K6 on 1024-ray train
   batches with injected draws, K7's and K6's max_z and depth_map also on
   the rays with acc > 0.5 (K10_Z_MEAN_TOL / K10_Z_P99_TOL); K6-int8's
   max_z against bf16 K6 on those rays (median within a coarse spacing,
   tests/test_quant.py's bound); fault_check.py shows that a planted
   requant fault, and a wrong int8 swizzle of the wgmma core, fail these
   gates; K2/K3/K8/K9-int8 and K6/K7-int8 run on the wgmma core with s8
   products: the launch shapes of render_around_depth_kernel<int8_t> (288
   threads, one block per SM) and render_hier_kernel<int8_t> (the same, 128
   blocks for a 1024-ray step), one block's time alone, and an int8 render
   or hierarchical launch without its weight slices must be refused;
   FULL_NERF at N_importance 0 through the engine (K8 int8 once);
   the DEPTH_NET view 0 PSNR in int8 beside bf16 (no gate) and the int8
   frame's time and profile. After the training path, [int8-train]: the
   CLI with --mlp_impl pallas_int8 runs the same recipe and seed for
   TRAIN_ITERS steps (K6 and K3 in int8 must launch, bf16 K6 must not, the
   loss must fall); its best DepthNet evaluated under the bf16 protocol
   within INT8_EVAL_TOL dB of the bf16 run's eval; --mode nerf with int8
   must raise.
9. [tar], after [joint]: the reference's .tar format on the main path. The
   committed checkpoint written as a reference-format .tar by the port's
   export and read back by its import, every tensor bit for bit; view 0
   rendered through the render CLI's loader from the .tar and from the
   .npz (K1 and K2 must launch), the two images bit-identical and view 0
   within PSNR_TOL of REFERENCE_PSNR_VIEW0; experiments/run.py's main
   with --ft_path a NeRF-only .tar, --mlp_impl cuda and --profile_dir for
   TAR_ITERS depth-net steps (K6 and K1 must launch; the trace of steps
   20-40 must exist and hold K6's kernel; the device's idle share over
   those steps and the ten host functions with the most self time are
   printed from it; the step-TAR_ITERS .tar export must read back to the
   run's DepthNet and NeRFs, with the DepthNet's Adam moments); one plain
   nerf step at --precision high against highest (the loss difference
   printed), torch's matmul precision back at strict fp32 after it. The
   kernels' record carries each kernel's launches in this phase as
   "tar_launches".
10. [llff], after [tar]: the forward-facing path through NDC at the llff
   recipe's full width (llff_depth_net_module with run.py's overrides) on
   the procedural example_llff scene (400x400, 24 views, llffhold 8),
   generated on first use. run.py --mode nerf from scratch for
   LLFF_NERF_ITERS steps on the kernels and on the plain path (only K4 and
   K5 may launch; the loss must fall over the center-crop phase; the
   kernel run's FULL_NERF eval, K4 on the composable route, within
   NERF_EVAL_TOL dB of the plain run's); one NDC nerf step and one NDC
   depth step on both paths from one state, batch and draws ([step]'s
   gates) and their median times; run.py --mode depth_net from the kernel
   run's NeRF for LLFF_DEPTH_ITERS steps (only K4, the target pass's
   queries, and K1, the eval, may launch: no K6; the loss must fall); the
   render CLI -rt gaussian/64/0.25 over the test views on both paths
   (only K1 and K4 may launch; the average PSNR within FULL_PSNR_TOL of
   plain fp32); one view's DEPTH_NET and FULL_NERF frame times on both
   paths and a profiled kernel-path DEPTH_NET frame. [formats]:
   example_linemod (per-frame K) and example_deepvoxels through run.py
   --mlp_impl cuda for FORMATS_ITERS depth steps against a NeRF from seed
   and one eval (K6, K1 and K3 must launch, the eval finite); LINEMOD's run
   evals its one test view twice, and [memory] holds the peak device
   memory at the second eval to the first's within MEMORY_GROWTH_MIB. The record
   carries each kernel's launches in these phases as "llff_launches" and
   "formats_launches".
11. [dispatch], after [formats]: K train steps per host sync
   (train/dispatch.py) at the same widths. (a) K6 with its seed read from
   device memory: DISPATCH_SEEDS by pointer equal to the same seeds by
   value bit for bit in bf16 and int8, a CUDA graph of one K6 launch
   replayed after each rewrite of its seed word equal to direct launches,
   the two timed in turns within DISPATCH_SEED_TIME_TOL (the K6 records
   gain "seed_value_ms" and "seed_ptr_ms"); (b)-(d) the depth step (bf16
   and int8), the nerf step and the joint step (warmup DISPATCH_WARMUP,
   ending inside a chunk) in captured chunks (DISPATCH_CHUNKS) against as
   many eager steps from one state, sampler stream and seeds: every step's
   metrics, the parameters and the Adam state bit for bit, K6 counted once
   per captured step, K4/K5 counted, the DepthNet unchanged through the
   warmup and depth_live 0 then 1; (e) the capturable Adam against torch's
   default Adam, one update within rtol 1e-6 plus ADAM_MOVE_TOL lr (the
   fp32 bias corrections move each parameter up to 6.4e-6 of its move
   differently) and the largest difference after 50 steps printed, and
   both against optax.adam's rule in numpy fp32 (optax_adam_np), one
   update from optax's state at each of the 50 steps: which is closer is
   printed, and the capturable one must stay within rtol 1e-6 plus
   ADAM_MOVE_TOL lr; (f) run.py's depth-net recipe for DISPATCH_ITERS
   steps with --steps_per_dispatch 0 (auto, captured) and 1: psnr.txt and
   every checkpoint array bit for bit, K6 launches equal to the steps in
   both (the K6 record's "dispatch_launches"). The median ms a step of both
   loops in turns, and the device idle share of one profiled captured
   chunk, are printed with the card's name and power limit. Then on a
   one-rank NCCL mesh (this process, its group formed by
   parallel.ops.spawn): (g) an all-reduce on a group formed under
   TORCH_NCCL_BLOCKING_WAIT=1 captured and replayed to the right values
   (the resolver has no rule for that setting); the sharded steps (make_sharded_*_train_step,
   their gradient and metric all-reduces inside each captured graph) of
   (b)-(d) in captured chunks against the per-step sharded loop, bit for
   bit as there, that loop bit for bit the one-rank loop of (b)-(d), the
   times of both loops, the idle share and the NCCL kernels a step of a
   profiled captured chunk (the K4, K5 and K6 records gain
   "mesh_dispatch_launches"); (h) run.py --multihost in a subprocess with
   the launcher's variables for one rank (MASTER_ADDR, MASTER_PORT,
   WORLD_SIZE=1, RANK=0, LOCAL_RANK=0), DISPATCH_ITERS depth-net steps with
   --steps_per_dispatch 0 against 1: auto above 1 with a graph captured,
   psnr.txt and every
   checkpoint array bit for bit, K6 launches equal to the steps in both
   (the K6 record's "mesh_cli_launches"). Every training phase above runs
   run.py with the auto default, so on the card its steps are CUDA-graph
   replays ([tar], which traces, and [scaleout], whose gloo mesh copies
   through the host, run one step per dispatch).
12. [scaleout], last: data parallelism (nerf_sampling_tpu_torch/parallel/)
   at the production widths (the committed checkpoint, 1024 rays a step,
   64 + 128 samples, view 0 at 400x400). (a) K6 on rows 512:1024 of a
   1024-ray batch with ray_base 512 and K3 on rows 80,000:160,000 of view
   0 with ray_base 80,000 equal the matching rows of the whole launch bit
   for bit, and their plain versions with the host twins' ray0 at [K6]'s
   and [K3]'s tolerances (both records gain "ray_base_check"). Then the
   one-rank references here, and SCALEOUT_RANKS ranks spawned on cuda:0
   under gloo (NCCL refuses two ranks on one card; a file:// rendezvous
   under logs/, collective and join timeouts, every rank killed when one
   fails): (b) SCALEOUT_STEPS depth-net steps (K6 oracle, DepthNet
   autograd, the gradient all-reduce) and (c) as many nerf steps (K4/K5)
   on NeRFs from seed 42, from the same state, batches and seeds as one
   rank: the first loss within 1e-5, the all-reduced gradients equal bit
   for bit to the mean of the two halves' own gradients made here, that
   mean within 1e-3 (b) or 2^-8 (c) of the largest 1024-row gradient, the
   params after step 1 within one Adam step (the fraction outside rtol
   1e-4 / atol 1e-6 printed), the ranks' params bit-identical after the
   last step. The 1-rank step is deterministic, but on the card its fp32
   GEMMs round a row differently at another batch size and K5's weight
   grads are bf16 sums over the rows a launch sees, so the halves differ
   from the whole in rounding, which Adam's first steps and the
   single-sample composite amplify. (d) view 0 through
   render_image_sharded, DEPTH_NET uniform (K1 + K2) and gaussian (K1 +
   K3), bit-identical to one rank's render, the PSNR printed; (e) a 2-rank
   Trainer (n_devices=2 on cuda:0, each rank joining the group spawn
   formed) for SCALEOUT_ITERS depth-net steps from the committed NeRF and
   its eval: the first logged loss within 1e-4 of one rank's Trainer, the
   eval within SCALEOUT_EVAL_TOL dB of it and equal to the 1-rank eval of
   rank 0's step-60 DepthNet, rank 1 wrote no file. Each rank's launches
   and the 2-rank step and frame times (two ranks sharing one card:
   correctness, not scaling) are printed; the record carries each
   kernel's launches on the ranks as "scaleout_launches". (i) the Trainer
   with steps_per_dispatch 4 on the two gloo ranks raises ValueError
   naming gloo before step 1, no kernel launched.

Every kernel runs its MLP on the wgmma core (csrc/mlp_wgmma.cuh): K1 in
bf16 and fp32 (depth_net.cu), K2, K3, K8 and K9 in bf16, int8 and fp32
(render_around_depth.cu), K6/K7 in bf16, int8 and fp32 (render_hier.cu),
K4 and K5's row pass. Their records name it under "core"; the launch
shapes of K1's, K2's, K2-int8's and K6's kernels (blocks, rays or tiles per
block, occupancy), the registers and spills of every kernel from the build
log, one K1 tile's and one K2 block's time alone, and K5's time by pass
(CUDA events; its library_ms is torch.matmul of pass (b)'s weight-grad
products on the same shapes) are printed; [K1], [K2] and [k10] also show
that a launch without the weight slices is refused.

Every kernel's record carries its bound from this run's shapes (the
larger of its operations at the card's bf16, int8 or fp32 peak, the fp32
kernels' (K1, K7, K9) at three tf32 products per fp32 product, and its bytes at the memory
rate) and its launches on the path it serves. The last two
lines of standard output are the kernels' JSON record and the device JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from nerf_sampling_tpu_torch.kernels import build

HERE = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(HERE, "evidence", "ckpt", "expected.json")
CKPT = os.path.join(HERE, "evidence", "ckpt", "example_depth.npz")
OUT_DIR = os.path.join(HERE, "logs", "chip_smoke")  # renders and psnr.txt (gitignored)
TRAIN_DIR = os.path.join(HERE, "logs", "chip_smoke_train")  # the training run (gitignored)
TRAIN_ITERS = EVAL_STEP = 2500  # the recipe's first eval (i_testset) and checkpoint
TRAIN_PRINT = 100  # i_print of the training run
NERF_DIR = os.path.join(HERE, "logs", "chip_smoke_nerf")  # the nerf-mode CLI runs (gitignored)
JOINT_DIR = os.path.join(HERE, "logs", "chip_smoke_joint")  # the joint-mode CLI run (gitignored)
NERF_ITERS = 500  # --mode nerf from scratch: the center-crop phase, then the eval
JOINT_ITERS, JOINT_WARMUP = 300, 100  # --mode joint: eval at the last step
NERF_PRINT = 100  # i_print of the nerf and joint runs
RENDER_DIR = os.path.join(HERE, "logs", "chip_smoke_render")  # the render CLI's runs (gitignored)
INT8_TRAIN_DIR = os.path.join(HERE, "logs", "chip_smoke_int8_train")  # the int8 training run (gitignored)
TAR_DIR = os.path.join(HERE, "logs", "chip_smoke_tar")  # the [tar] phase's files (gitignored)
TAR_ITERS = 60  # [tar]: depth-net steps from the .tar; the profiler traces steps 20-40, eval and .tar at 60
LLFF_DIR = os.path.join(HERE, "logs", "chip_smoke_llff")  # the [llff] phase's runs (gitignored)
LLFF_NERF_ITERS = 500  # [llff] --mode nerf from scratch: the center-crop phase, then the eval
LLFF_DEPTH_ITERS = 300  # [llff] --mode depth_net from that NeRF: eval and best checkpoint at the last step
FORMATS_DIR = os.path.join(HERE, "logs", "chip_smoke_formats")  # the [formats] phase's runs (gitignored)
FORMATS_ITERS = 20  # [formats] depth-net steps per format: eval and best checkpoint at the last step (LINEMOD also halfway)

# kernel vs its plain version at bf16 rounding (same inputs, same weights):
# the two differ only in fp32 summation order and the few bf16 roundings
# that order flips
K1_MEAN_TOL, K1_MAX_TOL = 1e-3, 5e-2  # |depth| on rays that hit, depth in [2, 6]
K2_MEAN_TOL, K2_MAX_TOL = 1e-3, 2e-2  # |rgb|, |acc| in [0, 1]; depth and disp scaled by 6
K3_MEAN_RGB_TOL = 1e-3  # in-kernel draws vs torch draws: equal in distribution
# K6 at bf16 rounding on train batches: a flipped bf16 rounding can move a
# fine sample and with it a whole ray, so the tail is held by percentile
K6_MEAN_TOL, K6_P999_TOL = 1e-3, 2e-2  # |rgb|, |acc|
K6_Z_MEAN_TOL, K6_Z_P99_TOL = 2e-3, 2e-2  # |max_z| on rays with acc > 0.5
K6_MEAN_RGB_TOL = 1e-3  # in-kernel draws vs torch draws over 64 batches
PSNR_TOL, STD_TOL, PLAIN_PSNR_TOL = 0.10, 0.003, 0.05
EVAL_GAP_TOL = 0.5  # dB the trained DepthNet may eval below the committed one
# [train]: the median logged Depth Net Loss over steps 1300-2500 of the
# recipe's run against the committed NeRF. The same run (the recipe, seed
# 42, K = 100) as D1 of scripts/torch_parity_runs.py logged 0.007654 there
# with the JAX package's initial weights (evidence/torch_parity/
# D1_repaired/), 0.006612 with torch's (D1/, cuda at auto K and K = 1
# alike) and 0.006125 on the plain path, against 0.0105 and 0.0080 at steps
# 1000 and 2000 of the JAX package's TPU run of the recipe (NVIDIA H100
# 80GB HBM3, 700 W): the bound is twice this tree's figure
DEPTH_LOSS_TOL = 0.0153
# [formats] LINEMOD's [memory] check: the peak device memory at its second
# eval at most this much above its first (one test view; the peak is reset
# before the run)
MEMORY_GROWTH_MIB = 1.0
# K5 against its plain bf16 version: the two differ in fp32 summation order
# and the bf16 roundings of d_z16 that order flips (tests/
# test_torch_nerf_train.py holds the plain version to JAX at 2e-2 of each
# tensor's largest grad at bf16)
K5_REL_TOL = 2e-2
# the [core] layer against torch.matmul of the same bf16 operands: both sum in
# fp32 and round once to bf16, in other orders, so an element may differ by
# the two fp32 sums' reordering bound (K * 2^-24 * sum |a w|, which near zero
# is several bf16 steps of the tiny result) plus CORE_ULP_TOL bf16 steps of
# its magnitude, and only rarely (CORE_FLIP_TOL of the elements)
CORE_ULP_TOL, CORE_FLIP_TOL = 1.0, 2e-2
# the [core] fp32 layer (3xTF32 products, fp32 sums) against an fp64 matmul:
# its largest error at most this many times strict-fp32 torch.matmul's on
# the same inputs
CORE32_TOL = 2.0
K5_COS_TOL = 0.999  # K5's grads against fp32 autograd of each NeRF
K7_MEAN_TOL, K7_P999_TOL = 1e-3, 2e-2  # |rgb| against the plain bf16 version (K6's bounds)
FULL_PSNR_TOL = 0.05  # FULL_NERF view 0: kernels against the plain fp32 path
# [mip]: K11 against its plain version (bf16 products and encodings in both):
# |rgb| mean and p99.9, |depth| mean over rays the plain version finds
# opaque (acc > 0.5), |acc| mean; K11 without the integration must exceed one
MIP_RGB_MEAN_TOL, MIP_RGB_P999_TOL, MIP_DEPTH_TOL, MIP_ACC_TOL = 5e-5, 5e-4, 4e-4, 2e-4
MIP_SEED = 2**31 + 12_345  # [mip]'s glorot weights
MIP_RAGGED = (1, 13, 95, 1001)  # [mip]'s ragged launches, in rays
# the fp32 kernels (the COMPARE mode's) against their plain fp32 versions: the
# two differ in fp32 summation order only; K7's max_z at ROADMAP's COMPARE budget
FP32_RGB_TOL, K1_FP32_TOL, K7_FP32_Z_TOL = 3e-4, 1e-4, 1e-3
MODE_COMPARE_PSNR_TOL, MODE_MSE_REL_TOL = 0.01, 0.01  # COMPARE view 0: kernels against plain fp32
# one nerf or joint step, cuda vs plain, same state, batch and draws
NSTEP_IMG_TOL, NSTEP_COS_TOL = 1e-2, 0.995
NERF_EVAL_TOL = 0.5  # dB between the kernel and plain runs' evals (nerf and joint mode)
# one step, cuda vs plain, same state, batch and draws: img_loss is the same
# fp32 code on both; the depth target comes from bf16 (K6) vs fp32, so the
# bound of tests/test_train_pallas.py:41
STEP_IMG_TOL, STEP_DEPTH_TOL, STEP_COS_TOL = 1e-5, 0.05, 0.99
# the int8 kernels against their plain int8 versions (same inputs, weights
# and calib): the two differ in the fp32 summation order of the bf16
# products, which flips an int8 rounding now and then, and a flip moves
# what follows it; held by mean and percentile, as K6, with bounds between
# the sound kernels' largest readings (mean 4.3e-6, p99.9 1.7e-5 on rgb) and
# a planted requant fault's (PERF.md)
K10_MEAN_TOL, K10_P999_TOL = 1e-4, 1e-3  # |rgb|, |acc|; depth and disp scaled by 6
# K6/K7-int8's |max_z| and |depth_map| on rays with acc > 0.5: sound, max_z equal
# and depth_map p99 1.2e-6; the planted fault, mean 1.8e-3 and p99 5.6e-2 and up
K10_Z_MEAN_TOL, K10_Z_P99_TOL = 1e-4, 1e-3
INT8_EVAL_TOL = 0.3  # dB: the int8-oracle DepthNet under the bf16 eval against the bf16 run's (RESULTS.md A/B)
# View 0 as the JAX package renders it through its own fp32 path
# (mlp_impl="xla") from the committed checkpoint: `python3 reference_psnr.py`
# prints it (33.6077 dB on an NVIDIA H100 80GB HBM3 at 700 W, jax 0.9.0).
# evidence/ckpt/expected.json records 31.17 dB for the same view from a TPU
# v5e run of the JAX package; its fp32 path on the H100 does not reproduce
# that, and the cause is not known (PERF.md, Open questions). The recorded
# image std (0.4181) is reproduced and stays a gate.
REFERENCE_PSNR_VIEW0 = 33.6077


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# each kernel record's (kernel, precision) key in build.launches
LAUNCH_KEYS = {
    "depth_net_kernel": ("K1", "bf16"), "depth_net_kernel_fp32": ("K1", "fp32"),
    "render_around_depth_kernel": ("K2", "bf16"), "render_around_depth_kernel_int8": ("K2", "int8"),
    "render_gaussian_kernel": ("K3", "bf16"), "render_gaussian_kernel_int8": ("K3", "int8"),
    "nerf_points_kernel": ("K4", "bf16"), "nerf_points_bwd_kernel": ("K5", "bf16"),
    "render_hier_kernel": ("K6", "bf16"), "render_hier_kernel_int8": ("K6", "int8"),
    "render_hier_kernel_det": ("K7", "bf16"), "render_hier_kernel_det_fp32": ("K7", "fp32"),
    "render_hier_kernel_det_int8": ("K7", "int8"),
    "render_linspace_kernel": ("K8", "bf16"), "render_linspace_kernel_int8": ("K8", "int8"),
    "shade_kernel": ("K9", "bf16"), "shade_kernel_fp32": ("K9", "fp32"),
    "render_mip_kernel": ("K11", "bf16"),
}


def reset_launches(*names: str) -> None:
    """Zero the named kernels' counts in build.launches."""
    for name in names:
        build.launches[LAUNCH_KEYS[name]] = 0


def launched(*names: str) -> dict[str, int]:
    """The named kernels' counts in build.launches (K5: one a pass)."""
    return {name: n_launches(name) for name in names}


def n_launches(name: str) -> int:
    return build.launches[LAUNCH_KEYS[name]]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frame_ms(fn, reps: int) -> float:
    """Median host time in ms of ``fn`` with a synchronize inside the window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    d = (got - want).abs()
    d = d[~torch.isnan(d)]
    return float(d.mean()), float(d.max())


# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): the
# bound of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak of their type; an fp32-accurate product on the
# tensor cores (3xTF32) is three tf32 products
PEAK = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "tf32x3": 494.7e12 / 3}
HBM_BYTES_PER_S = 3.35e12


def module_macs(module, sigma_only: bool = False) -> int:
    """Multiply-adds of one query of a NeRF or DepthNet module: the weights
    of its linear layers (``sigma_only``: the NeRF's trunk and alpha head)."""
    if sigma_only:
        return sum(lin.weight.numel() for lin in module.pts_linears) + module.alpha_linear.weight.numel()
    return sum(m.weight.numel() for m in module.modules() if isinstance(m, torch.nn.Linear))


def int8_macs(module, sigma_only: bool = False) -> int:
    """The multiply-adds of one NeRF query that the int8 MLP runs in int8:
    the h rows of trunk layers 1..D-1 and, unless ``sigma_only``, the
    feature layer and the feature rows of the views layer (the rest, on
    the embeddings and the heads, runs in bf16)."""
    W = module.cfg.W
    return (module.cfg.D - 1) * W * W + (0 if sigma_only else W * W + W * (W // 2))


def nbytes(*tensors) -> int:
    """Bytes of tensors and of the tensors in nested dicts and lists."""
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


# the wgmma MLP core, which every kernel's MLP runs on
CORE = "nerf_sampling_tpu_torch/kernels/csrc/mlp_wgmma.cuh"


def kernel_record(name: str, source: str, replaces: str, max_abs_err: float, ms: float, plain_ms: float,
                  flop: float, moved: int, dtype: str = "bf16", int8_flop: float = 0.0,
                  library_ms: float | None = None, core: str | None = None) -> dict:
    """One kernel's entry of the JSON record, its bound from this run's
    shapes: flop at the ``dtype`` peak (``int8_flop`` of them at the int8
    peak) against the bytes it must move (inputs, weights and outputs once)
    at the memory rate. No single PyTorch call computes any of the fused
    renders, so their library_ms is null; K5's is the weight-grad matmuls.
    ``core`` names the MLP core the kernel runs on, where it is the wgmma one."""
    t_ops = (int8_flop / PEAK["int8"] + (flop - int8_flop) / PEAK[dtype]) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    rec = {"name": name, "route": "cuda", "source": f"nerf_sampling_tpu_torch/kernels/csrc/{source}",
           "replaces": replaces, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library_ms}
    if core:
        rec["core"] = core
    return rec


def check_core(device) -> None:
    """[core]: one dense layer of the wgmma core against torch.matmul of the
    same bf16 operands (fp32 accumulation, one bf16 rounding), at 64, 128
    and ragged row counts, with and without a skip operand; then its s8
    mode, whose int32 sums must equal an fp64 matmul of the int8 values
    (exact: every sum is below 2^53); then its fp32 mode (3xTF32 products),
    whose largest error from an fp64 matmul must be at most CORE32_TOL
    times strict-fp32 torch.matmul's; then the render kernels' PE fill and
    the point-query kernels' (K4, K5), whose tiles must equal the
    per-column formula's byte for byte; every launch counted."""
    from nerf_sampling_tpu_torch.kernels import fused_render as fr

    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(9)
    build.launches["nst_wg_dense", "bf16"] = 0
    cases = ((64, 64, 256, False), (128, 256, 256, True), (300, 192, 128, True), (1000, 256, 256, False),
             (4133, 256, 256, True))
    for M, K, N, skip in cases:
        a = (torch.randn(M, K, generator=g, device=device) * 0.5).bfloat16()
        w = (torch.randn(K, N, generator=g, device=device) / K ** 0.5).bfloat16()
        b = torch.randn(N, generator=g, device=device) * 0.1
        a2 = torch.randn(M, 64, generator=g, device=device).bfloat16() if skip else None
        w2 = (torch.randn(64, N, generator=g, device=device) / 8).bfloat16() if skip else None
        got = fr.wgmma_dense(a, w, b, a2=a2, w2=w2, act=1).float()
        torch.cuda.synchronize()
        z = torch.matmul(a.float(), w.float()) + b
        if skip:
            z = z + torch.matmul(a2.float(), w2.float())
        ref = torch.relu(z).bfloat16().float()
        mag = torch.matmul(a.float().abs(), w.float().abs())
        if skip:
            mag = mag + torch.matmul(a2.float().abs(), w2.float().abs())
        reorder = (K + (64 if skip else 0)) * 2.0 ** -24 * mag  # two fp32 sums of the same terms
        ulp = ref.abs() * 2.0 ** -7
        steps = float(((got - ref).abs() - reorder).clamp_min(0).div(ulp.clamp_min(2.0 ** -126)).max())
        flips = float((got != ref).float().mean())
        log(f"[core] {M} x {K} @ {K} x {N}{' + skip 64' if skip else ''}: max |got - ref| "
            f"{float((got - ref).abs().max()):.3e}, beyond the fp32 reordering bound {steps:.2f} bf16 steps "
            f"(tol {CORE_ULP_TOL:g}); {flips:.2e} of the elements differ (tol {CORE_FLIP_TOL:g})")
        require(bool(torch.isfinite(got).all()) and steps <= CORE_ULP_TOL and flips <= CORE_FLIP_TOL,
                f"[core] the wgmma layer disagrees with torch.matmul at {M} x {K} x {N}")
    require(build.launches["nst_wg_dense", "bf16"] == len(cases), "[core] wgmma_dense did not launch its kernel")
    build.launches["nst_wg_dense_q", "int8"] = 0
    qcases = ((64, 256, 256), (300, 128, 128), (1000, 256, 128), (4133, 256, 256))
    for M, K, N in qcases:
        a = torch.randint(-128, 128, (M, K), generator=g, device=device).to(torch.int8)
        wq = torch.randint(-128, 128, (N, K), generator=g, device=device).to(torch.int8)
        got = fr.wgmma_dense_q(a, wq)
        torch.cuda.synchronize()
        ref = torch.matmul(a.double(), wq.double().T)
        bad = int((got.double() != ref).sum())
        log(f"[core] s8 {M} x {K} @ ({N} x {K})^T: {bad} of {M * N} int32 sums differ from the fp64 matmul "
            f"(max |sum| {float(ref.abs().max()):.0f}; must be 0)")
        require(bad == 0, f"[core] the s8 wgmma layer's int32 sums are not exact at {M} x {K} x {N}")
    require(build.launches["nst_wg_dense_q", "int8"] == len(qcases), "[core] wgmma_dense_q did not launch its kernel")
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick: torch.matmul in strict fp32
    build.launches["nst_wg_dense32", "fp32"] = 0
    fcases = ((64, 256, 256), (128, 64, 128), (300, 192, 128), (4133, 256, 256), (100, 32, 256))
    for M, K, N in fcases:
        a = torch.randn(M, K, generator=g, device=device) * 0.5
        w = torch.randn(K, N, generator=g, device=device) / K ** 0.5
        b = torch.randn(N, generator=g, device=device) * 0.1
        got = fr.wgmma_dense32(a, w, b, act=0)
        torch.cuda.synchronize()
        ref = a.double() @ w.double() + b.double()
        e_got = float((got.double() - ref).abs().max())
        e_f32 = float(((torch.matmul(a, w) + b).double() - ref).abs().max())
        log(f"[core] fp32 (3xTF32) {M} x {K} @ {K} x {N}: max |got - fp64| {e_got:.3e}, strict-fp32 torch.matmul's "
            f"{e_f32:.3e} ({e_got / e_f32:.2f}x, tol {CORE32_TOL:g}x)")
        require(bool(torch.isfinite(got).all()) and e_got <= CORE32_TOL * e_f32,
                f"[core] the 3xTF32 layer is further from fp64 than {CORE32_TOL:g}x fp32 at {M} x {K} x {N}")
    require(build.launches["nst_wg_dense32", "fp32"] == len(fcases), "[core] wgmma_dense32 did not launch its kernel")
    # the render kernels' PE fill against the per-column formula it replaced,
    # byte for byte: (S, rays a block, rays, sigma_only); 16384 x 64 is
    # 1,048,576 rows, the others end on a ragged tile or a short last block
    build.launches["nst_pe_fill_check", "bf16"] = 0
    pcases = ((64, 24, 16384, False), (2, 64, 4099, False), (192, 5, 1001, False), (512, 3, 301, False),
              (64, 8, 1001, True))
    for S, R, n, sigma_only in pcases:
        ro = torch.randn(n, 3, generator=g, device=device) * 2.0
        far_off = torch.rand(n, generator=g, device=device) < 0.01  # |u| 2^9 past sinf's fast range
        ro[far_off] *= 100.0
        rd = torch.randn(n, 3, generator=g, device=device)
        z = torch.rand(n, S, generator=g, device=device) * 8.0  # inside and beyond [2, 6]
        z[torch.rand(n, generator=g, device=device) < 0.01] = float("nan")  # sphere misses: a NaN depth
        z[torch.rand(n, S, generator=g, device=device) < 0.001] = float("nan")
        got, ref = fr.pe_fill_check(ro, rd, z, R, sigma_only=sigma_only)
        torch.cuda.synchronize()
        cols = 64 if sigma_only else 128
        bad = int((got[:, :cols].contiguous().view(torch.uint8) != ref[:, :cols].contiguous().view(torch.uint8)).sum())
        nan_rows = int(torch.isnan(ref[:, 0].float()).sum())
        log(f"[core] PE fill, S {S}, {R} rays a block, {n} rays ({n * S} rows, {nan_rows} NaN"
            f"{', sigma only: the point panel' if sigma_only else ''}): {bad} of {got.shape[0] * cols * 2} bytes "
            f"differ from the per-column formula (must be 0)")
        require(bad == 0 and nan_rows > 0, f"[core] the PE fill differs from the per-column formula at S {S}")
    require(build.launches["nst_pe_fill_check", "bf16"] == len(pcases), "[core] pe_fill_check did not launch its kernel")
    # K4's and K5's PE fill against the per-column formula it replaced, byte
    # for byte, tiles and their inputs: (S, rays, tiles a block); the train
    # step's coarse and fine queries, then ragged ones whose tiles start
    # mid-ray and whose last tile is short
    from nerf_sampling_tpu_torch.kernels import fused_nerf as k4

    build.launches["nst_point_fill_check", "bf16"] = 0
    qcases = [(S, n, tpb, rolled) for S, n, tpb in ((64, 1024, 4), (192, 1024, 12), (1, 20001, 3), (7, 1001, 2),
                                                    (192, 5, 1)) for rolled in (False, True)]
    for S, n, tpb, rolled in qcases:
        pts = (torch.rand(n * S, 3, generator=g, device=device) * 2.0 - 1.0) * 6.0  # |x| up to 6
        far_off = torch.rand(n * S, generator=g, device=device) < 0.01  # |x| 2^9 past sinf's fast range
        pts[far_off] *= 100.0
        pts[torch.rand(n * S, generator=g, device=device) < 0.005] = float("nan")
        dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=g, device=device), dim=-1)
        dirs[torch.rand(n, generator=g, device=device) < 0.01, 1] = float("nan")
        pts[1], dirs[-1, 1] = float("nan"), float("nan")  # at least one of each, in the last tile too
        got, ref, q_got, q_ref = k4.point_fill_check(pts, dirs, tiles_per_block=tpb, rolled=rolled)
        torch.cuda.synchronize()
        bad = int((got.contiguous().view(torch.uint8) != ref.contiguous().view(torch.uint8)).sum())
        bad_q = int((q_got.view(torch.int32) != q_ref.view(torch.int32)).sum())
        nan_rows = int(torch.isnan(ref[:, 0].float()).sum())
        nan_views = int(torch.isnan(ref[:, 65].float()).sum())
        log(f"[core] point fill{' (rolled, K5)' if rolled else ' (K4)'}, S {S}, {n * S} rows "
            f"({n * S % 128 or 128} in the last tile), {tpb} tiles a block, "
            f"{nan_rows} NaN points, {nan_views} rows of NaN directions: {bad} of {got.numel() * 2} bytes and "
            f"{bad_q} of {q_got.numel()} input words differ from the per-column formula (must be 0)")
        require(bad == 0 and bad_q == 0 and nan_rows > 0 and nan_views > 0,
                f"[core] the point fill differs from the per-column formula at S {S}")
    require(build.launches["nst_point_fill_check", "bf16"] == len(qcases), "[core] point_fill_check did not launch its kernel")
    log(f"[core] phase {time.perf_counter() - t0:.1f} s")


def view0_camera():
    """Test view 0 of the example scene at half resolution (400x400)."""
    from nerf_sampling_tpu_torch.data.example import _CAMERA_ANGLE_X, _orbit_poses

    H = W = 400
    focal = 0.5 * 800 / np.tan(0.5 * _CAMERA_ANGLE_X) / 2.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    return H, W, K, _orbit_poses(4, 2)[0][:3, :4].astype(np.float32)


def load_example_scene():
    """The example scene's views at 400x400 on white (generated at 800x800 on
    first use, as the JAX package's bench does) and their intrinsics K."""
    from nerf_sampling_tpu_torch.data.blender import load_blender_data
    from nerf_sampling_tpu_torch.data.example import generate_example_dataset
    from nerf_sampling_tpu_torch.definitions import DATASET_DIR

    t0 = time.perf_counter()
    datadir = os.path.join(DATASET_DIR, "example")
    if not os.path.exists(os.path.join(datadir, "transforms_test.json")):
        generate_example_dataset(datadir, H=800, W=800)
    scene = load_blender_data(datadir, half_res=True, testskip=1)
    scene.composite_white_background()
    log(f"[scene] example scene ready in {time.perf_counter() - t0:.1f} s: "
        f"{len(scene.images)} views at {scene.hwf[0]}x{scene.hwf[1]}")
    H, W, focal = scene.hwf
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    _, _, K0, c2w0 = view0_camera()
    require(np.allclose(K, K0) and np.allclose(scene.poses[int(scene.i_test[0])][:3, :4], c2w0),
            "test view 0 of the loaded scene is not the camera the kernel phases used")
    return scene, K


def production_pipeline(mlp_impl: str):
    import dataclasses

    from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.utils.config import load_trainer_config

    cfg = load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    # run.py's hard overrides (reference run.py:101-109): the checkpoint's DepthNet is 10x256
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    return dataclasses.replace(
        cfg.pipeline(with_depth=True), n_depth_samples=64, sampling_mode="uniform",
        distance=1.0, mlp_impl=mlp_impl,
    )


def view0_rays(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 160,000 rays of test view 0, [N, 3] each."""
    from nerf_sampling_tpu_torch.core.rays import get_rays

    H, W, K, c2w = view0_camera()
    ro, rd = get_rays(H, W, K, c2w, device)
    return ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()


def k1_rays(device) -> tuple[torch.Tensor, torch.Tensor]:
    """View 0's rays and 64 rays from the camera that miss the r=2 sphere
    (perpendicular to the origin), last."""
    ro, rd = view0_rays(device)
    g = torch.Generator().manual_seed(0)
    o = ro[:64]
    d = torch.cross(o, torch.randn(64, 3, generator=g).to(device), dim=1)
    return torch.cat([ro, o]), torch.cat([rd, d / d.norm(dim=1, keepdim=True)])


def check_k1_launch(tag: str, packed: dict, cfg, A: torch.Tensor, B: torch.Tensor, ms: float, device) -> None:
    """K1's launch on the wgmma core (bf16, or fp32 by A's dtype): its shape
    (160 threads, one block per SM), one block of one tile alone against
    the launch's time per tile of a block (``ms``), its registers, and a
    launch without the weight slices refused."""
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1

    fp32 = A.dtype == torch.float32
    name, mangled = ("float", "depth_net_kernelIfE") if fp32 else ("bf16", "depth_net_kernelI13__nv_bfloat16E")
    n = A.shape[0]
    occ = k1.kernel_occupancy(n, fp32=fp32)
    slots = occ["blocks_per_sm"] * occ["sms"]
    one = k1.TILE_ROWS  # one block of one tile
    ms_one = cuda_ms(lambda: k1.depth_net_kernel(packed, cfg, A[:one], B[:one]), 10)
    log(f"{tag} depth_net_kernel<{name}> (wgmma core) at {n} rays: {occ['blocks']} blocks of {occ['tiles_per_block']} "
        f"64-row tiles ({occ['threads']} threads, {occ['smem_bytes']} bytes of shared memory), {occ['blocks_per_sm']} "
        f"resident per SM x {occ['sms']} SMs = {slots} slots, {occ['blocks'] / slots:.2f} waves; one block of one "
        f"tile ({one} rays) alone {ms_one:.3f} ms against the launch's time per tile of a block "
        f"{ms / occ['tiles_per_block']:.3f} ms; {ptxas_usage(build.build_info['log'], mangled)}")
    require(occ["threads"] == 160 and occ["blocks_per_sm"] == 1,
            f"K1 {name} does not launch as the wgmma core's DepthNet (160 threads, one block per SM)")
    a, b = (k1.fragment_tiles(A), k1.fragment_tiles(B)) if fp32 else (A, B)
    arr, count = build.pointer_array([a, b, torch.empty(n, device=device)] + k1.epilogue_vectors(packed, A.dtype))
    rc = build.load_library().nst_depth_net_forward(
        arr, count, n, len(cfg.hidden_sizes), len(cfg.cat_hidden_sizes), float(cfg.near), float(cfg.far), int(fp32),
        occ["tiles_per_block"], build.current_stream(device))
    log(f"{tag} a {name} DepthNet launch without the weight slices: cudaError_t {rc} (refused)")
    require(rc != 0, f"K1 {name}: a launch without the weight slices was not refused")


def check_k1(params, device) -> dict:
    """K1 in bf16 (the DepthNet program of the wgmma core) over view 0 and
    64 rays that miss the sphere against its plain bf16 version, and its
    launch (``check_k1_launch``)."""
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1

    ro, rd = k1_rays(device)
    model, cfg = params.depth, params.depth.cfg
    packed = params.kernels.depth
    A, B = k1.depth_net_inputs(cfg, ro, rd, torch.bfloat16)
    got = k1.depth_net_kernel(packed, cfg, A, B)
    torch.cuda.synchronize()
    plain = k1.depth_net_plain(packed, cfg, A, B, torch.bfloat16)
    A32, B32 = k1.depth_net_inputs(cfg, ro, rd, torch.float32)
    ref32 = k1.depth_net_plain(k1.pack_depth_net(model, torch.float32), cfg, A32, B32, torch.float32)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(got), torch.isnan(plain)
    require(bool(torch.equal(nan_k, nan_p)), "K1: NaN mask differs from the plain version")
    require(bool(nan_k[-64:].all()) and not bool(nan_k[:-64].any()),
            "K1: NaN must mark exactly the 64 rays that miss the sphere")
    mean, mx = errors(got[:-64], plain[:-64])
    mean32, mx32 = errors(got[:-64], ref32[:-64])
    log(f"[K1] {got.numel()} rays: vs plain bf16 mean|d| {mean:.3e} max {mx:.3e} "
        f"(tol {K1_MEAN_TOL:g}/{K1_MAX_TOL:g}); vs plain fp32 mean {mean32:.3e} max {mx32:.3e}")
    require(mean <= K1_MEAN_TOL and mx <= K1_MAX_TOL, "K1 disagrees with its plain version")
    ms = cuda_ms(lambda: k1.depth_net_kernel(packed, cfg, A, B), 10)
    plain_ms = cuda_ms(lambda: k1.depth_net_plain(packed, cfg, A, B, torch.bfloat16), 5)
    log(f"[K1] {ms:.3f} ms per launch at {got.numel()} rays; plain bf16 version {plain_ms:.3f} ms")
    check_k1_launch("[K1]", packed, cfg, A, B, ms, device)
    return kernel_record("depth_net_kernel", "depth_net.cu", "nerf_sampling_tpu/kernels/fused_depth_net.py:181",
                         mx, ms, plain_ms, 2 * got.numel() * module_macs(model), nbytes(A, B, packed, got), core=CORE)


def check_k2(params, device) -> dict:
    """K2 over all 160,000 rays of view 0, one launch as the main path makes
    it, against its plain versions run over the same rays in chunks; a bf16
    launch without the weight slices must be refused; its launch shape."""
    from nerf_sampling_tpu_torch.core.rays import get_rays
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_render as k2

    H, W, K, c2w = view0_camera()
    ro, rd = get_rays(H, W, K, c2w, device)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    n = ro.shape[0]
    # NaN depths, as a sphere miss gives, on 16 rays spread over the frame's tiles
    nan_idx = torch.linspace(0, n - 1, 16, device=device).long()
    depth[nan_idx] = float("nan")
    nan_rows = torch.zeros(n, dtype=torch.bool, device=device)
    nan_rows[nan_idx] = True
    cfg, packed = params.fine.cfg, params.kernels.nerf
    packed32 = k2.pack_nerf(params.fine, torch.float32)
    offsets = torch.from_numpy(k2.uniform_population_offsets(64, 1.0)).to(device)
    chunk = 16384

    def plain_frame(weights, dtype) -> dict[str, torch.Tensor]:
        parts = [k2.render_around_depth_plain(weights, cfg, ro[s:s + chunk], rd[s:s + chunk],
                                              depth[s:s + chunk], offsets, dtype=dtype)
                 for s in range(0, n, chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    got = k2.render_around_depth_kernel(packed, cfg, ro, rd, depth, offsets)
    torch.cuda.synchronize()
    plain = plain_frame(packed, torch.bfloat16)
    ref32 = plain_frame(packed32, torch.float32)
    torch.cuda.synchronize()
    worst = 0.0
    for name, scale in (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0), ("disp_map", 6.0)):
        a, b = got[name], plain[name]
        nan_a = torch.isnan(a).reshape(n, -1)
        require(bool(torch.equal(torch.isnan(a), torch.isnan(b))), f"K2 {name}: NaN mask differs")
        require(bool(nan_a[nan_rows].all()) and not bool(nan_a[~nan_rows].any()),
                f"K2 {name}: NaN must mark exactly the NaN-depth rays")
        mean, mx = errors(a, b)
        mean32, mx32 = errors(a, ref32[name])
        log(f"[K2] {name}: vs plain bf16 mean {mean:.3e} max {mx:.3e} (tol {K2_MEAN_TOL * scale:g}/"
            f"{K2_MAX_TOL * scale:g}); vs plain fp32 mean {mean32:.3e} max {mx32:.3e}")
        require(mean <= K2_MEAN_TOL * scale and mx <= K2_MAX_TOL * scale,
                f"K2 {name} disagrees with its plain version")
        if name == "rgb_map":
            worst = mx
    # the bf16 kernel runs the wgmma core only: a launch without the weight
    # slices is refused, not run on another core
    vectors = k2.epilogue_vectors(packed)
    arr, count = build.pointer_array([ro, rd, depth, offsets, torch.empty((6, n), device=device)] + vectors)
    rc = build.load_library().nst_render_around_depth(
        arr, count, n, 64, cfg.D, sum(1 << i for i in packed["skip_w"]), 2.0, 6.0, 1, None,
        build.current_stream(device))
    log(f"[K2] a bf16 launch without the weight slices: cudaError_t {rc} (refused)")
    require(rc != 0, "K2: a bf16 launch without the weight slices was not refused")

    occ = k2.kernel_occupancy(64)
    ms = cuda_ms(lambda: k2.render_around_depth_kernel(packed, cfg, ro, rd, depth, offsets), 5)
    one = occ["rays_per_block"]  # one block alone: no other SM competes for L2
    ms_one = cuda_ms(lambda: k2.render_around_depth_kernel(packed, cfg, ro[:one], rd[:one], depth[:one],
                                                           offsets), 20)
    plain_ms = cuda_ms(lambda: plain_frame(packed, torch.bfloat16), 2)
    log(f"[K2] {n} rays x 64 samples, {int(nan_rows.sum())} with NaN depth; {ms:.3f} ms per "
        f"launch; one block of {one} rays alone {ms_one:.3f} ms; plain bf16 version {plain_ms:.3f} ms "
        f"(in chunks of {chunk} rays)")
    blocks, slots = -(-n // one), occ["blocks_per_sm"] * occ["sms"]
    wide = {S: k2.kernel_occupancy(S)["rays_per_block"] for S in (192, 512)}
    log(f"[K2] launch shape at {n} rays x 64 (wgmma core): {blocks} blocks of {one} rays "
        f"({occ['threads']} threads, {occ['smem_bytes']} bytes of shared memory), {occ['blocks_per_sm']} "
        f"resident per SM x {occ['sms']} SMs = {slots} slots, {blocks / slots:.2f} waves; rays per block "
        f"at 192 and 512 samples: {wide[192]}, {wide[512]}")
    return kernel_record("render_around_depth_kernel", "render_around_depth.cu",
                         "nerf_sampling_tpu/kernels/fused_render.py:390", worst, ms, plain_ms,
                         2 * n * 64 * module_macs(params.fine), nbytes(ro, rd, depth, offsets, packed, got),
                         core=CORE)


def same_bits(a: dict, b: dict) -> bool:
    """Every map equal element for element, NaN where NaN."""
    return all(torch.equal(torch.isnan(a[k]), torch.isnan(b[k]))
               and torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k])) for k in a)


def quantile(x: torch.Tensor, q: float) -> float:
    x = x[~torch.isnan(x)].float()
    return float(torch.quantile(x, q)) if x.numel() <= 16_000_000 else float(x.max())


def check_k3(params, device) -> dict:
    """K3 over all 160,000 rays of view 0 in one launch, with injected
    noise and 16 NaN depths, against its plain versions; then its in-kernel
    Philox draws: bits per seed, and the mean rgb against torch draws."""
    from nerf_sampling_tpu_torch.core.rays import get_rays
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_render as k2
    from nerf_sampling_tpu_torch.kernels import philox

    H, W, K, c2w = view0_camera()
    ro, rd = get_rays(H, W, K, c2w, device)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    n, S, std = ro.shape[0], 64, 1.0
    nan_idx = torch.linspace(0, n - 1, 16, device=device).long()
    depth[nan_idx] = float("nan")
    nan_rows = torch.zeros(n, dtype=torch.bool, device=device)
    nan_rows[nan_idx] = True
    cfg, packed = params.fine.cfg, params.kernels.nerf
    packed32 = k2.pack_nerf(params.fine, torch.float32)
    g = torch.Generator(device=device).manual_seed(3)
    noise = torch.randn((n, S - 1), generator=g, device=device)
    chunk = 16384

    def plain_frame(weights, dtype, nz) -> dict[str, torch.Tensor]:
        parts = [k2.render_gaussian_plain(weights, cfg, ro[s:s + chunk], rd[s:s + chunk],
                                          depth[s:s + chunk], nz[s:s + chunk], std=std, dtype=dtype)
                 for s in range(0, n, chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def kernel(**kw):
        return k2.render_gaussian_kernel(packed, cfg, ro, rd, depth, n_samples=S, std=std, **kw)

    got = kernel(noise=noise)
    torch.cuda.synchronize()
    plain = plain_frame(packed, torch.bfloat16, noise)
    ref32 = plain_frame(packed32, torch.float32, noise)
    worst = 0.0
    for name, scale in (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0), ("disp_map", 6.0)):
        a, b = got[name], plain[name]
        nan_a = torch.isnan(a).reshape(n, -1)
        require(bool(torch.equal(torch.isnan(a), torch.isnan(b))), f"K3 {name}: NaN mask differs")
        require(bool(nan_a[nan_rows].all()) and not bool(nan_a[~nan_rows].any()),
                f"K3 {name}: NaN must mark exactly the NaN-depth rays")
        mean, mx = errors(a, b)
        mean32, mx32 = errors(a, ref32[name])
        log(f"[K3] {name}: vs plain bf16 mean {mean:.3e} max {mx:.3e} (tol {K2_MEAN_TOL * scale:g}/"
            f"{K2_MAX_TOL * scale:g}); vs plain fp32 mean {mean32:.3e} max {mx32:.3e}")
        require(mean <= K2_MEAN_TOL * scale and mx <= K2_MAX_TOL * scale,
                f"K3 {name} disagrees with its plain version")
        if name == "rgb_map":
            worst = mx

    # in-kernel draws: a seed fixes the bits, the next seed changes them, and
    # the kernel's Philox stream is the host's (kernels/philox.py)
    a, b, c = kernel(seed=7), kernel(seed=7), kernel(seed=8)
    torch.cuda.synchronize()
    require(same_bits(a, b), "K3: one seed gave two results")
    require(not same_bits({"d": a["depth_map"]}, {"d": c["depth_map"]}), "K3: seed+1 gave the same depths")
    host = plain_frame(packed, torch.bfloat16, philox.gaussian_noise(7, n, S - 1).to(device))
    p_mean, p_max = errors(a["rgb_map"], host["rgb_map"])
    torch_draws = plain_frame(packed, torch.bfloat16, torch.randn((n, S - 1), generator=g, device=device))
    ok = ~nan_rows
    delta = abs(float(a["rgb_map"][ok].mean()) - float(torch_draws["rgb_map"][ok].mean()))
    log(f"[K3] in-kernel draws: seed 7 twice bit-identical, seed 8 differs; vs plain bf16 on "
        f"philox.gaussian_noise(7) rgb mean {p_mean:.3e} max {p_max:.3e}; |mean rgb - mean rgb of "
        f"plain with torch draws| {delta:.3e} (tol {K3_MEAN_RGB_TOL:g})")
    require(p_mean <= K2_MEAN_TOL and p_max <= K2_MAX_TOL, "K3: in-kernel draws are not the host's")
    require(delta <= K3_MEAN_RGB_TOL, "K3: in-kernel draws shift the mean rgb")
    ms = cuda_ms(lambda: kernel(seed=7), 5)
    plain_ms = cuda_ms(lambda: plain_frame(packed, torch.bfloat16, noise), 2)
    log(f"[K3] {n} rays x {S} samples: {ms:.3f} ms per launch (in-kernel draws); plain bf16 "
        f"version {plain_ms:.3f} ms (in chunks of {chunk} rays)")
    return kernel_record("render_gaussian_kernel", "render_around_depth.cu",
                         "nerf_sampling_tpu/kernels/fused_render.py:390", worst, ms, plain_ms,
                         2 * n * S * module_macs(params.fine), nbytes(ro, rd, depth, packed, got), core=CORE)


def check_k6(params, device, batches: list[tuple[torch.Tensor, torch.Tensor]]) -> dict:
    """K6 against its plain version on 1024-ray train batches with injected
    draws (the first 8 batches), its in-kernel draws (bits per seed, mean
    rgb against torch draws over all batches) and its time per launch."""
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6

    packed = params.kernels.hier
    cfg_c, cfg_f = params.coarse.cfg, params.fine.cfg
    packed32 = k6.pack_hier(params.coarse, params.fine, torch.float32)
    Nc, Nf = 64, 128
    g = torch.Generator(device=device).manual_seed(5)

    def kernel(ro, rd, **kw):
        return k6.render_hier_kernel(packed, cfg_c, cfg_f, ro, rd, n_coarse=Nc, n_importance=Nf, **kw)

    def plain(ro, rd, draws, weights=packed, dtype=torch.bfloat16):
        return k6.render_hier_plain(weights, cfg_c, cfg_f, ro, rd, n_coarse=Nc, n_importance=Nf,
                                    t_rand=draws[:, :Nc], u=draws[:, Nc:], dtype=dtype)

    got, want, want32 = [], [], []
    for ro, rd in batches[:8]:
        draws = torch.rand((ro.shape[0], Nc + Nf), generator=g, device=device)
        got.append(kernel(ro, rd, draws=draws))
        want.append(plain(ro, rd, draws))
        want32.append(plain(ro, rd, draws, packed32, torch.float32))
    torch.cuda.synchronize()
    cat = {k: torch.cat([o[k] for o in got]) for k in got[0]}
    ref = {k: torch.cat([o[k] for o in want]) for k in want[0]}
    ref32 = {k: torch.cat([o[k] for o in want32]) for k in want32[0]}
    for k in cat:
        require(not bool(torch.isnan(cat[k]).any()), f"K6 {k}: NaN")
    worst = 0.0
    for name in ("rgb_map", "acc_map"):
        d = (cat[name] - ref[name]).abs()
        mean, p999 = float(d.mean()), quantile(d, 0.999)
        d32 = (cat[name] - ref32[name]).abs()
        log(f"[K6] {name}: vs plain bf16 mean {mean:.3e} p99.9 {p999:.3e} max {float(d.max()):.3e} "
            f"(tol {K6_MEAN_TOL:g}/{K6_P999_TOL:g}); vs plain fp32 mean {float(d32.mean()):.3e}")
        require(mean <= K6_MEAN_TOL and p999 <= K6_P999_TOL, f"K6 {name} disagrees with its plain version")
        worst = max(worst, float(d.max()))
    fg = ref["acc_map"] > 0.5
    dz = (cat["max_z"] - ref["max_z"]).abs()
    mean_z, p99_z = float(dz[fg].mean()), quantile(dz[fg], 0.99)
    log(f"[K6] max_z on {int(fg.sum())} rays with acc > 0.5: mean {mean_z:.3e} p99 {p99_z:.3e} "
        f"(tol {K6_Z_MEAN_TOL:g}/{K6_Z_P99_TOL:g}); background rays (argmax is noise there): "
        f"mean {float(dz[~fg].mean()) if bool((~fg).any()) else 0.0:.3e}")
    require(mean_z <= K6_Z_MEAN_TOL and p99_z <= K6_Z_P99_TOL, "K6 max_z disagrees with its plain version")

    ro0, rd0 = batches[0]
    a, b, c = kernel(ro0, rd0, seed=11), kernel(ro0, rd0, seed=11), kernel(ro0, rd0, seed=12)
    torch.cuda.synchronize()
    require(same_bits(a, b), "K6: one seed gave two results")
    require(not torch.equal(a["max_z"], c["max_z"]), "K6: seed+1 gave the same max_z")
    sum_k = sum_p = 0.0
    for i, (ro, rd) in enumerate(batches):
        sum_k += float(kernel(ro, rd, seed=1000 + i)["rgb_map"].mean())
        draws = torch.rand((ro.shape[0], Nc + Nf), generator=g, device=device)
        sum_p += float(plain(ro, rd, draws)["rgb_map"].mean())
    delta = abs(sum_k - sum_p) / len(batches)
    log(f"[K6] in-kernel draws: seed 11 twice bit-identical, seed 12 differs; over {len(batches)} "
        f"batches |mean rgb - mean rgb of plain with torch draws| {delta:.3e} (tol {K6_MEAN_RGB_TOL:g})")
    require(delta <= K6_MEAN_RGB_TOL, "K6: in-kernel draws shift the mean rgb")

    big_o = torch.cat([b[0] for b in batches[:16]])
    big_d = torch.cat([b[1] for b in batches[:16]])
    occ = k6.kernel_occupancy(Nc, Nf)
    ms = cuda_ms(lambda: kernel(ro0, rd0, seed=1), 20)
    ms_big = cuda_ms(lambda: kernel(big_o, big_d, seed=1), 5)
    one = occ["rays_per_block"]  # one block alone: no other SM competes for L2
    ms_one = cuda_ms(lambda: kernel(ro0[:one], rd0[:one], seed=1), 20)
    draws0 = torch.rand((ro0.shape[0], Nc + Nf), generator=g, device=device)
    plain_ms = cuda_ms(lambda: plain(ro0, rd0, draws0), 5)
    log(f"[K6] {ro0.shape[0]} rays x ({Nc} sigma-only + {Nc + Nf} full) samples: {ms:.3f} ms per "
        f"launch; {big_o.shape[0]} rays: {ms_big:.3f} ms; one block of {one} rays alone: {ms_one:.3f} ms; "
        f"plain bf16 version at {ro0.shape[0]} rays {plain_ms:.3f} ms")
    slots = occ["blocks_per_sm"] * occ["sms"]
    for n in (ro0.shape[0], big_o.shape[0]):
        blocks = -(-n // occ["rays_per_block"])
        log(f"[K6] occupancy at {n} rays: {blocks} blocks of {occ['rays_per_block']} rays "
            f"({occ['threads']} threads, {occ['smem_bytes']} bytes of shared memory), "
            f"{occ['blocks_per_sm']} resident per SM x {occ['sms']} SMs = {slots} slots, "
            f"{blocks / slots:.2f} waves")
    flop = 2 * ro0.shape[0] * (Nc * module_macs(params.coarse, True) + (Nc + Nf) * module_macs(params.fine))
    return kernel_record("render_hier_kernel", "render_hier.cu", "nerf_sampling_tpu/kernels/fused_hier.py:255",
                         worst, ms, plain_ms, flop, nbytes(ro0, rd0, packed, a), core=CORE)


def run_slice(device, scene, K) -> tuple[dict[str, int], list[float]]:
    """The render path: the committed checkpoint's 4 test views through
    render_path on K1 and K2; returns the launch counts of that run and the
    per-view PSNRs."""
    import dataclasses

    from nerf_sampling_tpu_torch.render import render_image, render_path
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    H, W, focal = scene.hwf
    pipe = production_pipeline("cuda")
    params = load_render_params(CKPT, pipe, device)
    test_poses = [scene.poses[i] for i in scene.i_test]
    gts = scene.images[scene.i_test]

    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(os.path.join(OUT_DIR, "psnr.txt")):  # render_path appends
        os.remove(os.path.join(OUT_DIR, "psnr.txt"))
    reset_launches("depth_net_kernel", "render_around_depth_kernel")
    rgbs, _, avg = render_path(pipe, params, test_poses, (H, W, focal), K, device=device,
                               gt_imgs=gts, savedir=OUT_DIR, verbose=False)
    torch.cuda.synchronize()
    counts = launched("depth_net_kernel", "render_around_depth_kernel")
    log(f"[slice] launches during render_path: {counts}")
    for name, count in counts.items():
        require(count > 0, f"{name} was not launched by the render path")
    require(rgbs.shape == (len(test_poses), H, W, 3) and bool(np.isfinite(rgbs).all()),
            "the render is not finite or has the wrong shape")
    psnrs = [float(-10 * np.log10(np.mean((r - g) ** 2))) for r, g in zip(rgbs, gts)]
    with open(EXPECTED) as fp:
        expected = json.load(fp)["example"]
    psnr0, std0 = psnrs[0], float(rgbs[0].std())
    log(f"[slice] per-view PSNR {['%.4f' % p for p in psnrs]} (avg {avg:.4f}); view 0 "
        f"{psnr0:.4f} dB (JAX fp32 reference {REFERENCE_PSNR_VIEW0} +- {PSNR_TOL}; "
        f"expected.json's TPU v5e record {expected['psnr_view0']}), std {std0:.5f} "
        f"(expected {expected['img_std']} +- {STD_TOL})")
    require(abs(psnr0 - REFERENCE_PSNR_VIEW0) <= PSNR_TOL, "view 0 PSNR off the JAX reference")
    require(abs(std0 - expected["img_std"]) <= STD_TOL, "view 0 image std off the recorded value")

    plain_pipe = dataclasses.replace(pipe, mlp_impl="plain")

    def render(p):
        return render_image(p, params, H, W, K, test_poses[0][:3, :4], device=device)

    img = render(plain_pipe)["depth_net_rgb_map"].float().cpu().numpy()
    psnr_plain = float(-10 * np.log10(np.mean((img - gts[0]) ** 2)))
    log(f"[slice] view 0 on the plain fp32 path: {psnr_plain:.4f} dB (kernel path {psnr0:.4f}, "
        f"|delta| {abs(psnr_plain - psnr0):.4f}, tol {PLAIN_PSNR_TOL})")
    require(abs(psnr_plain - psnr0) <= PLAIN_PSNR_TOL, "kernel and plain fp32 paths disagree")

    ms_kernel = frame_ms(lambda: render(pipe), 7)
    ms_plain = frame_ms(lambda: render(plain_pipe), 3)
    log(f"[slice] median per 400x400 frame, DEPTH_NET uniform/64: kernels {ms_kernel:.2f} ms "
        f"({H * W / ms_kernel * 1e3:.0f} rays/s), plain fp32 {ms_plain:.2f} ms "
        f"({H * W / ms_plain * 1e3:.0f} rays/s)")
    profile_frame(lambda: render(pipe))
    return counts, psnrs


def plain_chunks(fn, n: int, chunk: int = 16384) -> dict[str, torch.Tensor]:
    """fn(slice) over [0, n) in chunks of rays, the outputs concatenated."""
    parts = [fn(slice(s, s + chunk)) for s in range(0, n, chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def check_k8(params, scene, K, device) -> tuple[dict, dict[str, int]]:
    """K8 over the 160,000 rays of view 0 in one launch, with the fine
    NeRF's pack (the committed coarse NeRF renders little density), at 64
    and 192 samples against its plain bf16 version; fp32 on a slice
    against plain fp32; then FULL_NERF at N_importance 0 through the engine
    (K8 on the coarse NeRF) against the plain fp32 path; returns K8's
    record and its launches in that render."""
    import dataclasses

    from nerf_sampling_tpu_torch.kernels import fused_render as k89
    from nerf_sampling_tpu_torch.render import EvalMode, render_image

    t0 = time.perf_counter()
    ro, rd = view0_rays(device)
    n = ro.shape[0]
    cfg, packed = params.fine.cfg, params.kernels.nerf

    def plain(S, weights=packed, dtype=torch.bfloat16, rays=(ro, rd)):
        return plain_chunks(lambda s: k89.render_linspace_plain(weights, cfg, rays[0][s], rays[1][s], n_samples=S,
                                                                dtype=dtype), rays[0].shape[0])

    worst = 0.0
    for S in (64, 192):
        got = k89.fused_render(packed, cfg, ro, rd, n_samples=S)
        torch.cuda.synchronize()
        want = plain(S)
        require(all(bool(torch.isfinite(got[k]).all()) for k in got), f"K8 S={S}: non-finite maps")
        for name, scale in (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0)):
            mean, mx = errors(got[name], want[name])
            log(f"[k8] {n} rays x {S}: |{name}| vs plain bf16 mean {mean:.3e} max {mx:.3e} "
                f"(tol {K2_MEAN_TOL * scale:g}/{K2_MAX_TOL * scale:g})")
            require(mean <= K2_MEAN_TOL * scale and mx <= K2_MAX_TOL * scale, f"K8 {name} disagrees at S={S}")
            if name == "rgb_map" and S == 64:
                worst, got64 = mx, got
    packed32 = k89.pack_nerf(params.fine, torch.float32)
    sub = (ro[:16384], rd[:16384])
    got32 = k89.fused_render(packed32, cfg, *sub, n_samples=64, dtype=torch.float32)
    want32 = plain(64, packed32, torch.float32, sub)
    mean32, mx32 = errors(got32["rgb_map"], want32["rgb_map"])
    log(f"[k8] fp32 mode, {sub[0].shape[0]} rays x 64: |rgb| vs plain fp32 mean {mean32:.3e} max {mx32:.3e} "
        f"(tol {FP32_RGB_TOL:g})")
    require(mx32 <= FP32_RGB_TOL, "K8 in fp32 disagrees with its plain fp32 version")
    ms = cuda_ms(lambda: k89.fused_render(packed, cfg, ro, rd, n_samples=64), 5)
    ms192 = cuda_ms(lambda: k89.fused_render(packed, cfg, ro, rd, n_samples=192), 3)
    plain_ms = cuda_ms(lambda: plain(64), 1)
    log(f"[k8] {ms:.3f} ms per launch at {n} rays x 64 ({ms192:.3f} ms x 192); plain bf16 version {plain_ms:.3f} ms")

    pipe = dataclasses.replace(production_pipeline("cuda"), depth=None, N_importance=0)
    Hs, Ws, _ = scene.hwf
    pose0, gt0 = scene.poses[int(scene.i_test[0])][:3, :4], scene.images[int(scene.i_test[0])]
    reset_launches("render_linspace_kernel")
    img = render_image(pipe, params, Hs, Ws, K, pose0, device=device, mode=EvalMode.FULL_NERF)
    torch.cuda.synchronize()
    counts = launched("render_linspace_kernel")
    img_p = render_image(dataclasses.replace(pipe, mlp_impl="plain"), params, Hs, Ws, K, pose0, device=device,
                         mode=EvalMode.FULL_NERF)
    psnrs = [float(-10 * np.log10(np.mean((m["depth_net_rgb_map"].float().cpu().numpy() - gt0) ** 2)))
             for m in (img, img_p)]
    log(f"[k8] FULL_NERF at N_importance 0 (the coarse NeRF, 64 samples), view 0: kernels {psnrs[0]:.4f} dB, "
        f"plain fp32 {psnrs[1]:.4f} dB (|delta| {abs(psnrs[0] - psnrs[1]):.4f}, tol {FULL_PSNR_TOL}); "
        f"launches {counts}")
    require(counts["render_linspace_kernel"] == 1, "FULL_NERF at N_importance 0 did not launch K8 once")
    require(abs(psnrs[0] - psnrs[1]) <= FULL_PSNR_TOL, "FULL_NERF at N_importance 0: kernel and plain disagree")
    log(f"[k8] phase {time.perf_counter() - t0:.1f} s")
    rec = kernel_record("render_linspace_kernel", "render_around_depth.cu",
                        "nerf_sampling_tpu/kernels/fused_render.py:390", worst, ms, plain_ms,
                        2 * n * 64 * module_macs(params.fine), nbytes(ro, rd, packed, got64), core=CORE)
    return rec, counts


def check_k9(params, device) -> dict:
    """K9 over view 0 against its plain versions at bf16 and fp32: the
    uniform population around K1's depth, a sorted gaussian population, and
    input_unsorted on a per-ray shuffled copy of it, which must equal the
    sorted input; K9 fp32 runs the wgmma core's fp32 path (3xTF32): its time
    against both bounds, launch shape, one block alone, registers, and a
    launch without its slices must be refused. Returns the fp32 mode's
    record (COMPARE's)."""
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_render as k89

    t0 = time.perf_counter()
    ro, rd = view0_rays(device)
    n, S = ro.shape[0], 64
    cfg = params.fine.cfg
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd).reshape(n, 1)
    offsets = torch.from_numpy(k89.uniform_population_offsets(S, 1.0)).to(device)
    g = torch.Generator(device=device).manual_seed(21)
    pops = {
        "uniform": torch.clamp(depth + offsets[None, :], 2.0, 6.0).contiguous(),
        "gaussian": k89.gaussian_population(depth, torch.randn((n, S - 1), generator=g, device=device), 1.0),
    }
    perm = torch.argsort(torch.rand((n, S), generator=g, device=device), dim=1)
    shuffled = torch.gather(pops["gaussian"], 1, perm).contiguous()
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        tag = k89.dtype_name(dtype)
        packed = params.kernels.nerf if dtype == torch.bfloat16 else k89.pack_nerf(params.fine, torch.float32)
        mean_tol, max_tol = (K2_MEAN_TOL, K2_MAX_TOL) if dtype == torch.bfloat16 else (FP32_RGB_TOL, FP32_RGB_TOL)
        for pop, z in pops.items():
            got = k89.fused_shade(packed, cfg, ro, rd, z, dtype=dtype)
            torch.cuda.synchronize()
            want = plain_chunks(lambda s: k89.shade_plain(packed, cfg, ro[s], rd[s], z[s], dtype=dtype), n)
            require(all(bool(torch.isfinite(got[k]).all()) for k in got), f"K9 {tag} {pop}: non-finite maps")
            for name, scale in (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0)):
                mean, mx = errors(got[name], want[name])
                log(f"[k9] {tag} {pop}, {n} rays x {S}: |{name}| vs plain {tag} mean {mean:.3e} max {mx:.3e} "
                    f"(tol {mean_tol * scale:g}/{max_tol * scale:g})")
                require(mean <= mean_tol * scale and mx <= max_tol * scale, f"K9 {tag} {pop} {name} disagrees")
            if pop == "uniform":
                worst, got_u = errors(got["rgb_map"], want["rgb_map"])[1], got
        unsorted = k89.fused_shade(packed, cfg, ro, rd, shuffled, assume_sorted=False, dtype=dtype)
        d = max(float((unsorted[k] - got[k]).abs().max()) for k in got)
        log(f"[k9] {tag} input_unsorted on a per-ray shuffled copy vs input on the sorted gaussian "
            f"population: max |delta| over the maps {d:.3e} (tol 1e-6)")
        require(d <= 1e-6, f"K9 {tag}: input_unsorted is not the sort of its input")
        ms = cuda_ms(lambda: k89.fused_shade(packed, cfg, ro, rd, pops["uniform"], dtype=dtype), 3)
        plain_ms = cuda_ms(lambda: plain_chunks(lambda s: k89.shade_plain(
            packed, cfg, ro[s], rd[s], pops["uniform"][s], dtype=dtype), n), 1)
        log(f"[k9] {tag} (wgmma core): {ms:.3f} ms per launch at {n} rays x {S}; plain {tag} version {plain_ms:.3f} ms")
        if dtype == torch.float32:
            flop = 2 * n * S * module_macs(params.fine)
            fp32_bounds(f"[k9] {tag} (3xTF32 on the wgmma core)", ms, flop)
            # the launch shape, one block alone, the registers, and no launch without the slices
            occ = k89.kernel_occupancy(S, fp32=True)
            one = occ["rays_per_block"]
            blocks, slots = -(-n // one), occ["blocks_per_sm"] * occ["sms"]
            ms_one = cuda_ms(lambda: k89.fused_shade(packed, cfg, ro[:one], rd[:one], pops["uniform"][:one],
                                                     dtype=dtype), 20)
            log(f"[k9] render_around_depth_kernel<float> at {n} rays: {blocks} blocks of {one} rays "
                f"({occ['threads']} threads, {occ['smem_bytes']} bytes of shared memory), {occ['blocks_per_sm']} "
                f"resident per SM x {occ['sms']} SMs = {slots} slots, {blocks / slots:.2f} waves; one block of {one} "
                f"rays alone {ms_one:.3f} ms against a wave's share of the launch {ms * slots / blocks:.3f} ms; "
                f"{ptxas_usage(build.build_info['log'], 'render_around_depth_kernelIfE')}")
            require(occ["threads"] == 160 and occ["blocks_per_sm"] == 1,
                    "K9 fp32 does not launch as the fp32 path of the wgmma core (160 threads, one block per SM)")
            arr, count = build.pointer_array([ro, rd, None, pops["uniform"], torch.empty((6, n), device=device)]
                                             + k89.epilogue_vectors(packed, dtype=dtype))
            rc = build.load_library().nst_shade(arr, count, n, S, cfg.D, sum(1 << i for i in packed["skip_w"]), 1, 1,
                                                1, None, build.current_stream(device))
            log(f"[k9] an fp32 shading launch without the weight slices: cudaError_t {rc} (refused)")
            require(rc != 0, "K9 fp32: a launch without the weight slices was not refused")
            rec = kernel_record("shade_kernel_fp32", "render_around_depth.cu",
                                "nerf_sampling_tpu/kernels/fused_render.py:390", worst, ms, plain_ms, flop,
                                nbytes(ro, rd, pops["uniform"], packed, got_u), "tf32x3", core=CORE)
    log(f"[k9] phase {time.perf_counter() - t0:.1f} s")
    return rec


def fp32_bounds(tag: str, ms: float, flop: float) -> None:
    """An fp32 kernel's time against its two bounds: the FMA units' (67
    TFLOP/s) and 3xTF32's on the tensor cores (three tf32 products at
    494.7 TFLOP/s, its record's)."""
    fma_ms, tc_ms = flop / PEAK["fp32"] * 1e3, flop / PEAK["tf32x3"] * 1e3
    log(f"{tag}: {ms:.3f} ms per launch ({flop / ms / 1e9:.1f} TFLOP/s of fp32 work); {100 * fma_ms / ms:.1f}% of the "
        f"FMA-unit bound ({fma_ms:.3f} ms at 67 TFLOP/s), {100 * tc_ms / ms:.1f}% of the 3xTF32 bound ({tc_ms:.3f} ms "
        f"at 494.7/3 TFLOP/s)")


def check_fp32(params, device) -> list[dict]:
    """The COMPARE mode's fp32 K1 and K7 against their plain fp32 versions:
    K1 on view 0 and 64 rays that miss the sphere (depth within 1e-4, the
    NaN mask equal), K7 over view 0 in one launch (max_z within 1e-3 on the
    rays that hit the sphere, rgb within FP32_RGB_TOL); both run the wgmma
    core's fp32 path (3xTF32): each one's time against both bounds (the FMA
    units' and 3xTF32's, its record's), launch shape, one block alone,
    registers, and a launch without its slices must be refused."""
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_hier as k7
    from nerf_sampling_tpu_torch.kernels import fused_render as k289

    t0 = time.perf_counter()
    ro, rd = k1_rays(device)
    model, cfg = params.depth, params.depth.cfg
    packed = k1.pack_depth_net(model, torch.float32)
    A, B = k1.depth_net_inputs(cfg, ro, rd, torch.float32)
    got = k1.depth_net_kernel(packed, cfg, A, B)
    torch.cuda.synchronize()
    want = k1.depth_net_plain(packed, cfg, A, B, torch.float32)
    require(bool(torch.equal(torch.isnan(got), torch.isnan(want))), "K1 fp32: NaN mask differs")
    require(bool(torch.isnan(got[-64:]).all()) and not bool(torch.isnan(got[:-64]).any()),
            "K1 fp32: NaN must mark exactly the 64 rays that miss the sphere")
    mean, mx = errors(got, want)
    log(f"[fp32] K1 fp32, {got.numel()} rays: |depth| vs plain fp32 mean {mean:.3e} max {mx:.3e} "
        f"(tol {K1_FP32_TOL:g}); NaN mask equal")
    require(mx <= K1_FP32_TOL, "K1 fp32 disagrees with its plain fp32 version")
    ms = cuda_ms(lambda: k1.depth_net_kernel(packed, cfg, A, B), 5)
    plain_ms = cuda_ms(lambda: k1.depth_net_plain(packed, cfg, A, B, torch.float32), 3)
    log(f"[fp32] K1 fp32: {ms:.3f} ms per launch; plain fp32 version {plain_ms:.3f} ms")
    flop = 2 * got.numel() * module_macs(model)
    fp32_bounds("[fp32] K1 fp32 (3xTF32 on the wgmma core)", ms, flop)
    check_k1_launch("[fp32]", packed, cfg, A, B, ms, device)
    recs = [kernel_record("depth_net_kernel_fp32", "depth_net.cu", "nerf_sampling_tpu/kernels/fused_depth_net.py:181",
                          mx, ms, plain_ms, flop, nbytes(A, B, packed, got), "tf32x3", core=CORE)]

    hit = ~torch.isnan(got[:-64])
    ro, rd = ro[:-64], rd[:-64]
    n = ro.shape[0]
    hier = k7.pack_hier(params.coarse, params.fine, torch.float32)
    cfg_c, cfg_f = params.coarse.cfg, params.fine.cfg
    got = k7.render_hier_kernel(hier, cfg_c, cfg_f, ro, rd, dtype=torch.float32)
    torch.cuda.synchronize()
    want = plain_chunks(lambda s: k7.render_hier_plain(hier, cfg_c, cfg_f, ro[s], rd[s], dtype=torch.float32), n)
    dz = (got["max_z"] - want["max_z"]).abs()[hit]
    d = (got["rgb_map"] - want["rgb_map"]).abs()
    mx_rgb, p999 = float(d.max()), quantile(d, 0.999)
    log(f"[fp32] K7 fp32, {n} rays: |max_z| on the {int(hit.sum())} rays that hit the sphere max "
        f"{float(dz.max()):.3e} mean {float(dz.mean()):.3e} (tol {K7_FP32_Z_TOL:g}); |rgb| mean {float(d.mean()):.3e} "
        f"p99.9 {p999:.3e} max {mx_rgb:.3e} (tol {FP32_RGB_TOL:g})")
    require(float(dz.max()) <= K7_FP32_Z_TOL, "K7 fp32: max_z disagrees with its plain fp32 version")
    require(mx_rgb <= FP32_RGB_TOL, "K7 fp32: rgb disagrees with its plain fp32 version")
    ms = cuda_ms(lambda: k7.render_hier_kernel(hier, cfg_c, cfg_f, ro, rd, dtype=torch.float32), 1)
    plain_ms = cuda_ms(lambda: plain_chunks(lambda s: k7.render_hier_plain(
        hier, cfg_c, cfg_f, ro[s], rd[s], dtype=torch.float32), n), 1)
    flop = 2 * n * (64 * module_macs(params.coarse, True) + 192 * module_macs(params.fine))
    fp32_bounds("[fp32] K7 fp32 (3xTF32 on the wgmma core)", ms, flop)
    log(f"[fp32] K7 fp32: plain fp32 version {plain_ms:.3f} ms")
    # the kernel on the wgmma core: its launch shape, one block alone, its
    # registers, and no launch without its slices
    occ = k7.kernel_occupancy(64, 128, fp32=True)
    one = occ["rays_per_block"]
    blocks, slots = -(-n // one), occ["blocks_per_sm"] * occ["sms"]
    ms_one = cuda_ms(lambda: k7.render_hier_kernel(hier, cfg_c, cfg_f, ro[:one], rd[:one], dtype=torch.float32), 20)
    log(f"[fp32] render_hier_kernel<float> at {n} rays: {blocks} blocks of {one} rays ({occ['threads']} threads, "
        f"{occ['smem_bytes']} bytes of shared memory), {occ['blocks_per_sm']} resident per SM x {occ['sms']} SMs = "
        f"{slots} slots, {blocks / slots:.2f} waves; one block of {one} rays alone {ms_one:.3f} ms; "
        f"{ptxas_usage(build.build_info['log'], 'render_hier_kernelIfE')}")
    require(occ["threads"] == 160 and occ["blocks_per_sm"] == 1,
            "K7 fp32 does not launch as the fp32 path of the wgmma core (160 threads, one block per SM)")
    arr, count = build.pointer_array([ro, rd, None, torch.empty((11, n), device=device)]
                                     + k289.epilogue_vectors(hier["coarse"], sigma_only=True, dtype=torch.float32)
                                     + k289.epilogue_vectors(hier["fine"], dtype=torch.float32))
    rc = build.load_library().nst_render_hier(
        arr, count, n, 64, 128, cfg_c.D, sum(1 << i for i in hier["coarse"]["skip_w"]), cfg_f.D,
        sum(1 << i for i in hier["fine"]["skip_w"]), 2.0, 6.0, 0, 1, None, 0, 0, 1, 1, None, None,
        build.current_stream(device))
    log(f"[fp32] an fp32 hierarchical launch without the weight slices: cudaError_t {rc} (refused)")
    require(rc != 0, "K7 fp32: a launch without the weight slices was not refused")
    recs.append(kernel_record("render_hier_kernel_det_fp32", "render_hier.cu",
                              "nerf_sampling_tpu/kernels/fused_hier.py:255", mx_rgb, ms, plain_ms, flop,
                              nbytes(ro, rd, hier, got), "tf32x3", core=CORE))
    log(f"[fp32] phase {time.perf_counter() - t0:.1f} s")
    return recs


def check_modes(params, scene, K, device) -> None:
    """COMPARE_NERF and NERF_MAX over view 0 through render_image, kernels
    against the plain fp32 path: COMPARE's PSNR within MODE_COMPARE_PSNR_TOL,
    its compare MSE within 1% and max_z within 1e-3 on the rays that hit the
    sphere; NERF_MAX's PSNR within FULL_PSNR_TOL."""
    import dataclasses

    from nerf_sampling_tpu_torch.render import EvalMode, render_image
    from nerf_sampling_tpu_torch.render.path import compare_mse

    t0 = time.perf_counter()
    pipe = production_pipeline("cuda")
    Hs, Ws, _ = scene.hwf
    pose0, gt0 = scene.poses[int(scene.i_test[0])][:3, :4], scene.images[int(scene.i_test[0])]

    def psnr(m):
        return float(-10 * np.log10(np.mean((m["depth_net_rgb_map"].float().cpu().numpy() - gt0) ** 2)))

    for mode in (EvalMode.COMPARE_NERF, EvalMode.NERF_MAX):
        out = {impl: render_image(dataclasses.replace(pipe, mlp_impl=impl), params, Hs, Ws, K, pose0, device=device,
                                  mode=mode) for impl in ("cuda", "plain")}
        torch.cuda.synchronize()
        pk, pp = psnr(out["cuda"]), psnr(out["plain"])
        tol = MODE_COMPARE_PSNR_TOL if mode == EvalMode.COMPARE_NERF else FULL_PSNR_TOL
        msg = (f"[modes] {mode.name} view 0: PSNR kernels {pk:.4f} dB, plain fp32 {pp:.4f} dB "
               f"(|delta| {abs(pk - pp):.4f}, tol {tol})")
        require(abs(pk - pp) <= tol, f"{mode.name}: kernel and plain PSNR disagree")
        if mode == EvalMode.COMPARE_NERF:
            mk, mp = compare_mse(out["cuda"]), compare_mse(out["plain"])
            hit = torch.isfinite(out["plain"]["depth_net_z_vals"]).all(-1)
            dz = (out["cuda"]["max_z_vals"] - out["plain"]["max_z_vals"]).abs()[..., 0][hit]
            rel = abs(mk - mp) / abs(mp)
            msg += (f"; compare MSE kernels {mk:.6e}, plain {mp:.6e} (rel {rel:.2e}, tol {MODE_MSE_REL_TOL:g}); "
                    f"|max_z| on the {int(hit.sum())} rays that hit the sphere max {float(dz.max()):.3e} "
                    f"(tol {K7_FP32_Z_TOL:g})")
            require(rel <= MODE_MSE_REL_TOL, "COMPARE: the compare MSE of the kernels and plain disagree")
            require(float(dz.max()) <= K7_FP32_Z_TOL, "COMPARE: max_z of the kernels and plain disagree")
        log(msg)
        ms_k = frame_ms(lambda: render_image(pipe, params, Hs, Ws, K, pose0, device=device, mode=mode), 1)
        log(f"[modes] {mode.name}: {ms_k:.2f} ms per 400x400 frame on the kernels")
    log(f"[modes] phase {time.perf_counter() - t0:.1f} s")


def hold_int8(tag: str, got: dict, want: dict, names, nan_rows=None) -> float:
    """An int8 kernel's maps against its plain int8 version: the NaN mask
    equal (exactly nan_rows where given), then mean and p99.9 of |delta|
    within K10_MEAN_TOL / K10_P999_TOL (x scale); returns rgb's max."""
    worst = 0.0
    for name, scale in names:
        a, b = got[name], want[name]
        require(bool(torch.equal(torch.isnan(a), torch.isnan(b))), f"{tag} {name}: NaN mask differs")
        if nan_rows is not None:
            nan_a = torch.isnan(a).reshape(nan_rows.shape[0], -1)
            require(bool(nan_a[nan_rows].all()) and not bool(nan_a[~nan_rows].any()),
                    f"{tag} {name}: NaN must mark exactly the NaN-depth rays")
        d = (a - b).abs()
        d = d[~torch.isnan(d)]
        mean, p999, mx = float(d.mean()), quantile(d, 0.999), float(d.max())
        log(f"[k10] {tag} {name}: vs plain int8 mean {mean:.3e} p99.9 {p999:.3e} max {mx:.3e} "
            f"(tol {K10_MEAN_TOL * scale:g}/{K10_P999_TOL * scale:g})")
        require(mean <= K10_MEAN_TOL * scale and p999 <= K10_P999_TOL * scale, f"{tag} {name} disagrees with "
                "its plain int8 version")
        if name == "rgb_map":
            worst = mx
    return worst


def hold_int8_z(tag: str, got: dict, want: dict) -> None:
    """K6/K7-int8's max_z (what the depth step and NERF_MAX read) and
    depth_map against the plain int8 version's on the rays with acc > 0.5
    there (the argmax is noise on background rays): mean and p99 of |delta|
    within K10_Z_MEAN_TOL / K10_Z_P99_TOL."""
    fg = want["acc_map"] > 0.5
    for name in ("max_z", "depth_map"):
        d = (got[name] - want[name]).abs()[fg]
        mean, p99 = float(d.mean()), quantile(d, 0.99)
        log(f"[k10] {tag} {name} on the {int(fg.sum())} rays with acc > 0.5: vs plain int8 mean {mean:.3e} "
            f"p99 {p99:.3e} max {float(d.max()):.3e}, {int((d > 0).sum())} rays differ "
            f"(tol {K10_Z_MEAN_TOL:g}/{K10_Z_P99_TOL:g})")
        require(mean <= K10_Z_MEAN_TOL and p99 <= K10_Z_P99_TOL, f"{tag} {name} disagrees with its plain int8 version")


def check_k10(params, scene, K, device, batches) -> tuple[list[dict], dict[str, int]]:
    """The int8 mode: calibration of the committed NeRFs on the example
    scene, then every int8 kernel against its plain int8 version on the
    card, K6-int8 against bf16 K6, FULL_NERF at N_importance 0 in int8
    through the engine, and the int8 DEPTH_NET frame beside the bf16 one;
    returns the int8 records (K9-int8, on no path, only printed) and K8
    int8's launches in the engine render."""
    import dataclasses

    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_hier as k67
    from nerf_sampling_tpu_torch.kernels import fused_render as k289
    from nerf_sampling_tpu_torch.render import EvalMode, pack_kernel_weights, render_image
    from nerf_sampling_tpu_torch.render.quantize import calibrate_pipeline

    t0 = time.perf_counter()
    pipe = calibrate_pipeline(production_pipeline("cuda_int8"), params, scene)
    qc, qf = pipe.quant_calib
    log(f"[k10] calibration of the coarse NeRF on the first train view (512 rays x 17 z): {qc}")
    log(f"[k10] calibration of the fine NeRF: {qf}")
    q = pack_kernel_weights(params, with_hier=True, with_coarse=True, quant_pair=(qc, qf)).kernels
    ro, rd = view0_rays(device)
    n, S = ro.shape[0], 64
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    nan_idx = torch.linspace(0, n - 1, 16, device=device).long()
    depth[nan_idx] = float("nan")
    nan_rows = torch.zeros(n, dtype=torch.bool, device=device)
    nan_rows[nan_idx] = True
    cfg = params.fine.cfg
    offsets = torch.from_numpy(k289.uniform_population_offsets(S, 1.0)).to(device)
    noise = torch.randn((n, S - 1), generator=torch.Generator(device=device).manual_seed(3), device=device)
    pop = torch.clamp(depth.reshape(n, 1) + offsets[None, :], 2.0, 6.0).contiguous()  # NaN rows stay NaN
    names = (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0), ("disp_map", 6.0))
    flop, iflop = 2 * n * S * module_macs(params.fine), 2 * n * S * int8_macs(params.fine)
    cases = [  # name, kernel, plain version over a slice of rays, the NaN rows, the inputs it reads
        ("render_around_depth_kernel_int8", lambda: k289.render_around_depth_kernel(q.nerf, cfg, ro, rd, depth, offsets),
         lambda s: k289.render_around_depth_plain(q.nerf, cfg, ro[s], rd[s], depth[s], offsets), nan_rows,
         (ro, rd, depth, offsets)),
        ("render_gaussian_kernel_int8", lambda: k289.render_gaussian_kernel(q.nerf, cfg, ro, rd, depth, n_samples=S,
                                                                             std=1.0, noise=noise),
         lambda s: k289.render_gaussian_plain(q.nerf, cfg, ro[s], rd[s], depth[s], noise[s], std=1.0), nan_rows,
         (ro, rd, depth, noise)),
        ("render_linspace_kernel_int8", lambda: k289.fused_render(q.nerf, cfg, ro, rd, n_samples=S),
         lambda s: k289.render_linspace_plain(q.nerf, cfg, ro[s], rd[s], n_samples=S), None, (ro, rd)),
        ("shade_kernel_int8", lambda: k289.fused_shade(q.nerf, cfg, ro, rd, pop),
         lambda s: k289.shade_plain(q.nerf, cfg, ro[s], rd[s], pop[s]), nan_rows, (ro, rd, pop)),
    ]
    recs, k9 = [], None
    for name, kernel, plain, nans, inputs in cases:
        got = kernel()
        torch.cuda.synchronize()
        want = plain_chunks(plain, n)
        tag = name.replace("_kernel_int8", "")
        worst = hold_int8(tag, got, want, names if nans is not None else names[:3], nans)
        ms = cuda_ms(kernel, 3)
        plain_ms = cuda_ms(lambda: plain_chunks(plain, n), 1)
        rec = kernel_record(name, "render_around_depth.cu", "nerf_sampling_tpu/kernels/quant.py:353", worst, ms,
                            plain_ms, flop, nbytes(*inputs, q.nerf, got), int8_flop=iflop, core=CORE)
        log(f"[k10] {tag}: {ms:.3f} ms per launch at {n} rays x {S}; plain int8 version {plain_ms:.3f} ms; "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
        if name == "shade_kernel_int8":
            k9 = rec  # no card path launches K9 in int8 (JAX: only under interpret)
        else:
            recs.append(rec)
    bf16 = k289.render_around_depth_kernel(params.kernels.nerf, cfg, ro, rd, depth, offsets)
    int8 = k289.render_around_depth_kernel(q.nerf, cfg, ro, rd, depth, offsets)
    d = (int8["rgb_map"] - bf16["rgb_map"]).abs()
    log(f"[k10] K2 int8 against K2 bf16 over view 0: |rgb| mean {float(d[~torch.isnan(d)].mean()):.3e} "
        f"max {float(d[~torch.isnan(d)].max()):.3e} (not gated); K9-int8 record (on no path): {json.dumps(k9)}")
    # the int8 render kernel on the wgmma core (s8): its launch shape, one block
    # alone against its share of a wave, and no launch without its slices
    occ = k289.kernel_occupancy(S, int8=True)
    one = occ["rays_per_block"]
    blocks, slots = -(-n // one), occ["blocks_per_sm"] * occ["sms"]
    ms_one = cuda_ms(lambda: k289.render_around_depth_kernel(q.nerf, cfg, ro[:one], rd[:one], depth[:one], offsets),
                     20)
    ms2 = recs[0]["ms"]
    log(f"[k10] render_around_depth_kernel<int8_t> (wgmma core, s8) at {n} rays x {S}: {blocks} blocks of {one} rays "
        f"({occ['threads']} threads, {occ['smem_bytes']} bytes of shared memory), {occ['blocks_per_sm']} resident per "
        f"SM x {occ['sms']} SMs = {slots} slots, {blocks / slots:.2f} waves; one block of {one} rays alone "
        f"{ms_one:.3f} ms against a wave's share of the K2 launch {ms2 * slots / blocks:.3f} ms; "
        f"bf16 K2 {cuda_ms(lambda: k289.render_around_depth_kernel(params.kernels.nerf, cfg, ro, rd, depth, offsets), 3):.3f} "
        f"ms in the same call")
    require(occ["threads"] == 288 and occ["blocks_per_sm"] == 1,
            "K10 in K2 does not launch as the wgmma core's kernel (288 threads, one block per SM)")
    pa = k289.pack_args(q.nerf, cfg)
    arr, count = build.pointer_array([ro, rd, depth, offsets, torch.empty((6, n), device=device)] + pa.vectors)
    rc = build.load_library().nst_render_around_depth(
        arr, count, n, S, cfg.D, pa.skip_mask, 2.0, 6.0, 1, build.host_pointer(pa.plan), build.current_stream(device))
    log(f"[k10] an int8 render launch without the weight slices: cudaError_t {rc} (refused)")
    require(rc != 0, "K10 in K2: an int8 launch without the weight slices was not refused")

    # K7 over view 0, one launch
    cfg_c = params.coarse.cfg
    ro, rd = view0_rays(device)
    got = k67.render_hier_kernel(q.hier, cfg_c, cfg, ro, rd)
    torch.cuda.synchronize()
    want = plain_chunks(lambda s: k67.render_hier_plain(q.hier, cfg_c, cfg, ro[s], rd[s]), n)
    worst = hold_int8("render_hier_det", got, want, names[:2])
    hold_int8_z("render_hier_det", got, want)
    ms = cuda_ms(lambda: k67.render_hier_kernel(q.hier, cfg_c, cfg, ro, rd), 2)
    plain_ms = cuda_ms(lambda: plain_chunks(lambda s: k67.render_hier_plain(q.hier, cfg_c, cfg, ro[s], rd[s]), n), 1)
    flop = 2 * n * (64 * module_macs(params.coarse, True) + 192 * module_macs(params.fine))
    iflop = 2 * n * (64 * int8_macs(params.coarse, True) + 192 * int8_macs(params.fine))
    recs.append(kernel_record("render_hier_kernel_det_int8", "render_hier.cu", "nerf_sampling_tpu/kernels/quant.py:353",
                              worst, ms, plain_ms, flop, nbytes(ro, rd, q.hier, got), int8_flop=iflop, core=CORE))
    log(f"[k10] render_hier_det (K7): {ms:.3f} ms per launch over view 0; plain int8 version {plain_ms:.3f} ms; "
        f"bound {recs[-1]['bound_ms']:.3f} ms")

    # K6 on train batches with injected draws, against its plain version and bf16 K6
    Nc, Nf = 64, 128
    g = torch.Generator(device=device).manual_seed(5)
    got, want, ref16 = [], [], []
    for bro, brd in batches[:8]:
        draws = torch.rand((bro.shape[0], Nc + Nf), generator=g, device=device)
        got.append(k67.render_hier_kernel(q.hier, cfg_c, cfg, bro, brd, n_coarse=Nc, n_importance=Nf, draws=draws))
        want.append(k67.render_hier_plain(q.hier, cfg_c, cfg, bro, brd, n_coarse=Nc, n_importance=Nf,
                                          t_rand=draws[:, :Nc], u=draws[:, Nc:]))
        ref16.append(k67.render_hier_kernel(params.kernels.hier, cfg_c, cfg, bro, brd, n_coarse=Nc, n_importance=Nf,
                                            draws=draws))
    torch.cuda.synchronize()
    cat = {k: torch.cat([o[k] for o in got]) for k in got[0]}
    ref = {k: torch.cat([o[k] for o in want]) for k in want[0]}
    worst = hold_int8("render_hier (K6)", cat, ref, names[:2])
    hold_int8_z("render_hier (K6)", cat, ref)
    r16 = {k: torch.cat([o[k] for o in ref16]) for k in ref16[0]}
    fg = r16["acc_map"] > 0.5
    dz = (cat["max_z"] - r16["max_z"]).abs()[fg]
    med = float(dz.median())
    log(f"[k10] K6 int8 against bf16 K6, same draws, max_z on the {int(fg.sum())} rays with acc > 0.5: median "
        f"{med:.3e} mean {float(dz.mean()):.3e} p90 {quantile(dz, 0.9):.3e} (gate: median < (far - near)/Nc = "
        f"{4.0 / Nc:g}); |acc| mean {float((cat['acc_map'] - r16['acc_map']).abs().mean()):.3e}")
    require(med < 4.0 / Nc, "K6 int8's max_z strays from bf16 K6's")
    bro, brd = batches[0][:2]
    ms = cuda_ms(lambda: k67.render_hier_kernel(q.hier, cfg_c, cfg, bro, brd, n_coarse=Nc, n_importance=Nf, seed=1), 20)
    ms16 = cuda_ms(lambda: k67.render_hier_kernel(params.kernels.hier, cfg_c, cfg, bro, brd, n_coarse=Nc,
                                                  n_importance=Nf, seed=1), 20)
    draws0 = torch.rand((bro.shape[0], Nc + Nf), generator=g, device=device)
    plain_ms = cuda_ms(lambda: k67.render_hier_plain(q.hier, cfg_c, cfg, bro, brd, n_coarse=Nc, n_importance=Nf,
                                                     t_rand=draws0[:, :Nc], u=draws0[:, Nc:]), 5)
    m = bro.shape[0]
    flop = 2 * m * (Nc * module_macs(params.coarse, True) + (Nc + Nf) * module_macs(params.fine))
    iflop = 2 * m * (Nc * int8_macs(params.coarse, True) + (Nc + Nf) * int8_macs(params.fine))
    recs.append(kernel_record("render_hier_kernel_int8", "render_hier.cu", "nerf_sampling_tpu/kernels/quant.py:353",
                              worst, ms, plain_ms, flop, nbytes(bro, brd, q.hier, got[0]), int8_flop=iflop, core=CORE))
    log(f"[k10] render_hier (K6): {ms:.3f} ms per launch at {m} rays (bf16 K6 {ms16:.3f} ms, same call); plain int8 "
        f"version {plain_ms:.3f} ms; bound {recs[-1]['bound_ms']:.3f} ms")
    # the int8 kernel on the wgmma core: its launch shape, one block alone, and no launch without its slices
    occ = k67.kernel_occupancy(Nc, Nf, int8=True)
    one = occ["rays_per_block"]
    blocks, slots = -(-m // one), occ["blocks_per_sm"] * occ["sms"]
    ms_one = cuda_ms(lambda: k67.render_hier_kernel(q.hier, cfg_c, cfg, bro[:one], brd[:one], n_coarse=Nc,
                                                    n_importance=Nf, seed=1), 20)
    log(f"[k10] render_hier_kernel<int8_t> (wgmma core, s8) at {m} rays: {blocks} blocks of {one} rays "
        f"({occ['threads']} threads, {occ['smem_bytes']} bytes of shared memory), {occ['blocks_per_sm']} resident "
        f"per SM x {occ['sms']} SMs = {slots} slots, {blocks / slots:.2f} waves; one block of {one} rays alone "
        f"{ms_one:.3f} ms")
    require(occ["threads"] == 288 and occ["blocks_per_sm"] == 1 and blocks == 128,
            "K6-int8 does not launch as the wgmma core's kernel (288 threads, one block per SM, 128 blocks)")
    c, f = k289.pack_args(q.hier["coarse"], cfg_c, sigma_only=True), k289.pack_args(q.hier["fine"], cfg)
    arr, count = build.pointer_array([bro, brd, None, torch.empty((11, m), device=device)] + c.vectors + f.vectors)
    rc = build.load_library().nst_render_hier(
        arr, count, m, Nc, Nf, cfg_c.D, c.skip_mask, cfg.D, f.skip_mask, 2.0, 6.0, 0, 1, None, 1, 0, 0, 0,
        build.host_pointer(c.plan), build.host_pointer(f.plan), build.current_stream(device))
    log(f"[k10] an int8 hierarchical launch without the weight slices: cudaError_t {rc} (refused)")
    require(rc != 0, "K6-int8: a launch without the weight slices was not refused")

    # FULL_NERF at N_importance 0 through the engine: K8 int8 on the coarse NeRF
    Hs, Ws, _ = scene.hwf
    pose0, gt0 = scene.poses[int(scene.i_test[0])][:3, :4], scene.images[int(scene.i_test[0])]

    def psnr(m_):
        return float(-10 * np.log10(np.mean((m_["depth_net_rgb_map"].float().cpu().numpy() - gt0) ** 2)))

    reset_launches("render_linspace_kernel_int8")
    img = render_image(dataclasses.replace(pipe, depth=None, N_importance=0), params, Hs, Ws, K, pose0,
                       device=device, mode=EvalMode.FULL_NERF)
    torch.cuda.synchronize()
    counts = launched("render_linspace_kernel_int8")
    log(f"[k10] FULL_NERF at N_importance 0 in int8 (K8 on the coarse NeRF), view 0: {psnr(img):.4f} dB; "
        f"launches {counts}")
    require(counts["render_linspace_kernel_int8"] == 1, "FULL_NERF at N_importance 0 did not launch K8-int8 once")

    # the DEPTH_NET frame in int8 beside bf16 (no gate: JAX's TPU record is -8.8 dB on trained fields)
    params_q = pack_kernel_weights(params, quant_pair=(qc, qf))
    pipe16 = production_pipeline("cuda")

    def frame(p, prm):
        return render_image(p, prm, Hs, Ws, K, pose0, device=device)

    p8, p16 = psnr(frame(pipe, params_q)), psnr(frame(pipe16, params))
    ms8, ms16 = frame_ms(lambda: frame(pipe, params_q), 5), frame_ms(lambda: frame(pipe16, params), 5)
    log(f"[k10] DEPTH_NET view 0 (uniform/64/1.0): int8 {p8:.4f} dB, bf16 {p16:.4f} dB ({p8 - p16:+.4f} dB, not "
        f"gated); median frame int8 {ms8:.2f} ms, bf16 {ms16:.2f} ms")
    profile_frame(lambda: frame(pipe, params_q), "one int8 DEPTH_NET frame")
    log(f"[k10] phase {time.perf_counter() - t0:.1f} s")
    return recs, counts


def run_render_cli(device, slice_psnrs: list[float]) -> dict[str, int]:
    """experiments/render.py's main on the card over the 4 test views (a
    copy of the example scene with its test views and one train view):
    the default DEPTH_NET (uniform/64/1.0, the render slice's setting: the
    same PSNRs), -nc, -nm and -nf, each checked for its PNGs, psnr.txt and
    kernel launches; then the -e grid on one view; then one render_only
    render of the spiral path with its video. Returns the launches of the
    four mode runs, by kernel."""
    import shutil

    from PIL import Image

    from nerf_sampling_tpu_torch.data.example import generate_example_dataset
    from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.experiments import render as rcli
    from nerf_sampling_tpu_torch.train.trainer import Trainer
    from nerf_sampling_tpu_torch.utils.config import load_trainer_config

    t0 = time.perf_counter()
    shutil.rmtree(RENDER_DIR, ignore_errors=True)
    datadir = os.path.join(RENDER_DIR, "scene")
    generate_example_dataset(datadir, H=800, W=800, n_train=1, n_val=1, n_test=4)
    common = ["-dp", datadir, "-m", "recommended_depth_net_module", "--ft_path", CKPT, "--n_samples", "64",
              "--distance", "1.0", "--device", torch.device(device).type]
    base = common + ["--testskip", "1", "--basedir", RENDER_DIR]
    counters = ("depth_net_kernel", "depth_net_kernel_fp32", "render_around_depth_kernel", "shade_kernel_fp32",
                "render_hier_kernel_det", "render_hier_kernel_det_fp32", "render_around_depth_kernel_int8",
                "render_hier_kernel_det_int8")
    int8 = ["--mlp_impl", "pallas_int8", "--basedir", os.path.join(RENDER_DIR, "int8")]
    runs = {"": ([], ("depth_net_kernel", "render_around_depth_kernel")),
            "-nc": (["-nc"], ("depth_net_kernel_fp32", "shade_kernel_fp32", "render_hier_kernel_det_fp32")),
            "-nm": (["-nm"], ("render_hier_kernel_det",)), "-nf": (["-nf"], ("render_hier_kernel_det",)),
            "int8": (int8, ("depth_net_kernel", "render_around_depth_kernel_int8")),
            "-nf int8": (["-nf"] + int8, ("render_hier_kernel_det_int8",))}
    counts: dict[str, int] = {}
    psnrs_of: dict[str, list[float]] = {}
    for flag, (extra, names) in runs.items():
        reset_launches(*counters)
        argv = base + extra
        log(f"[render] python3 -m nerf_sampling_tpu_torch.experiments.render {' '.join(argv)}")
        t1 = time.perf_counter()
        tr = rcli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        run_counts = launched(*names)
        d = os.path.join(tr.expdir, "renderonly_test_000000")
        lines = open(os.path.join(d, "psnr.txt")).read().splitlines()
        psnrs = [float(ln.split("PSNR: ")[1].split(",")[0]) for ln in lines[:4]]
        log(f"[render] {flag or 'DEPTH_NET'}: {wall:.1f} s, per-view PSNR {['%.4f' % p for p in psnrs]}, "
            f"launches {run_counts}; psnr.txt: {lines[4:]}")
        psnrs_of[flag] = psnrs
        if flag.endswith("int8"):
            base16 = psnrs_of[flag.replace("int8", "").strip()]
            require(tr.pipeline.mlp_impl == "cuda_int8", f"{flag}: the render did not run cuda_int8")
            log(f"[render] {flag}: int8 average {np.mean(psnrs):.4f} dB against bf16 {np.mean(base16):.4f} dB "
                f"({np.mean(psnrs) - np.mean(base16):+.4f} dB, not gated)")
        require(all(os.path.exists(os.path.join(d, f"{i:03d}.png")) for i in range(4)), f"{flag}: PNGs missing")
        require(lines[4] == "Avg of 4 images:" and len(lines) == (7 if flag == "-nc" else 6),
                f"{flag}: psnr.txt has the wrong lines")
        require(all((", MSE: " in ln) == (flag == "-nc") for ln in lines[:4]), f"{flag}: psnr.txt MSE lines")
        require(all(c > 0 for c in run_counts.values()), f"{flag}: a kernel of the mode was not launched")
        if not flag:
            require(max(abs(a - b) for a, b in zip(psnrs, slice_psnrs)) <= 1e-4,
                    "the CLI's DEPTH_NET render differs from the render slice's")
        counts.update(run_counts)

    t1 = time.perf_counter()
    grid_dir = os.path.join(RENDER_DIR, "grid")
    rcli.main(common + ["--testskip", "4", "--basedir", grid_dir, "-e"])
    torch.cuda.synchronize()
    lines = open(os.path.join(grid_dir, "experiments", "experiments_results.txt")).read().splitlines()
    grid = [float(ln.split("PSNR: ")[1]) for ln in lines if ln.startswith("    Distance: ")]
    log(f"[render] -e grid, 1 view: {len(grid)} renders in {time.perf_counter() - t1:.1f} s; PSNR uniform "
        f"{grid[:16]}, gaussian {grid[16:]}")
    require(len(grid) == 32 and all(np.isfinite(grid)) and lines[0] == "Experiments", "the -e grid is incomplete")

    t1 = time.perf_counter()
    cfg = load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    cfg.datadir, cfg.basedir, cfg.expname, cfg.ft_path = datadir, RENDER_DIR, "path", CKPT
    cfg.render_only, cfg.render_test, cfg.mlp_impl = True, False, "cuda"
    cfg.sampling_mode, cfg.n_depth_samples, cfg.distance = "uniform", 64, 1.0
    tr = Trainer(cfg, device=device)
    tr.train(N_iters=1)
    video = os.path.join(tr.expdir, "renderonly_path_000000", "video.gif")
    with Image.open(video) as im:
        frames = im.n_frames
    log(f"[render] render_only over the spiral path: {frames} frames in {time.perf_counter() - t1:.1f} s, {video}")
    require(frames == len(tr.scene.render_poses), "the path video is missing frames")
    log(f"[render] phase {time.perf_counter() - t0:.1f} s")
    return counts



def profile_frame(fn, what: str = "one frame", top: int = 12):
    """Device time by kernel over one run of ``fn`` (torch.profiler);
    returns (wall ms, kernel rows)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a first device op inside the profiler, so that fn's first kernel is
        # recorded like the rest (one run dropped the depth step's K6 row)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernel rows only: an aten op's row repeats the time of its kernels
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # a record_function range shows on the device as a span over its kernels
    spans = [e for e in cuda if getattr(e, "is_user_annotation", False)]
    rows = [e for e in cuda if not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    log(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms, kernels {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of the wall time; device idle {100 - 100 * busy / wall_us:.1f}%)")
    for e in rows[:top]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    for e in spans:
        log(f"[profile] range {e.key}: {e.device_time_total / 1e3:.3f} ms on the device")
    return wall_us / 1e3, rows


def train_batches(scene, device, n: int, seed: int = 0):
    """n train batches of 1024 rays from the port's RaySampler, on ``device``."""
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig

    sampler = RaySampler(scene, SamplerConfig(N_rand=1024), seed=seed)
    out = []
    for i in range(1, n + 1):
        ro, rd, target = sampler.sample(i)
        out.append(tuple(torch.from_numpy(x).to(device) for x in (ro, rd, target)))
    return out


def write_nerf_only_checkpoint(path: str) -> None:
    """The committed checkpoint's NeRFs alone, as a JAX-layout .npz."""
    from nerf_sampling_tpu_torch.train import checkpoint as ck

    tree, _ = ck.read_npz_tree(CKPT)
    sds = ck.params_from_jax(tree["params"])
    sds.pop("depth")
    ck.save_checkpoint(path, {"params": ck.JaxNeRFParams(**ck.params_to_jax(sds))}, 0)


def run_training(device, scene, K) -> tuple[dict[str, int], object]:
    """The training slice through the CLI's main, in process: the recipe
    (recommended_depth_net_module with run.py's overrides) on the example
    scene, a fresh DepthNet against the committed NeRF, kernel path."""
    import shutil

    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.render import pack_kernel_weights, render_path
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    ft_path = os.path.join(TRAIN_DIR, "nerf_only.npz")
    write_nerf_only_checkpoint(ft_path)
    argv = ["-d", "example", "-m", "recommended_depth_net_module", "--mlp_impl", "cuda",
            "--ft_path", ft_path, "--n_iters", str(TRAIN_ITERS), "-ip", str(TRAIN_PRINT), "--seed", "42",
            "--basedir", TRAIN_DIR, "--testskip", "1"]
    log(f"[train] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
    reset_launches("depth_net_kernel", "render_gaussian_kernel", "render_hier_kernel")
    t0 = time.perf_counter()
    trainer = run.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launched("depth_net_kernel", "render_gaussian_kernel", "render_hier_kernel")
    log(f"[train] {trainer.global_step} steps in {wall:.1f} s (evals and checkpoints included); "
        f"launches during the run: {counts}")
    for name, count in counts.items():
        require(count > 0, f"{name} was not launched by the training run")
    with open(os.path.join(trainer.expdir, "psnr.txt")) as fp:
        lines = [ln for ln in fp if ln.startswith("Iter:")]
    losses = [float(ln.split("Depth Net Loss: ")[1].split(",")[0]) for ln in lines]
    log(f"[train] Depth Net Loss at step {lines[0].split()[1]}: {losses[0]:.6f}, at step "
        f"{lines[-1].split()[1]}: {losses[-1]:.6f}")
    require(losses[-1] < losses[0], "the depth-net loss did not fall")
    late = [loss for ln, loss in zip(lines, losses) if int(ln.split()[1]) > TRAIN_ITERS // 2]
    median = float(np.median(late))
    log(f"[train] median Depth Net Loss over the {len(late)} logged steps after step {TRAIN_ITERS // 2}: "
        f"{median:.6f} (gate: at most {DEPTH_LOSS_TOL}; the same run logged 0.007654 in "
        "scripts/torch_parity_runs.py's D1, the TPU run of the recipe 0.0105 and 0.0080 at steps 1000 and 2000)")
    require(median <= DEPTH_LOSS_TOL, "the depth-net loss sits above the reference's level")
    with open(os.path.join(trainer.expdir, "metrics.jsonl")) as fp:
        rates = [json.loads(ln) for ln in fp if '"steps_per_sec"' in ln]
    if rates:
        log(f"[train] steady-state rate at step {rates[-1]['step']}: {rates[-1]['steps_per_sec']:.1f} "
            f"steps/s ({rates[-1]['rays_per_sec']:.0f} rays/s), evals included")
    best = os.path.join(trainer.expdir, "best", f"depth_{EVAL_STEP:06d}.npz")
    require(os.path.exists(best), f"{best} was not written")

    # the committed DepthNet under the same eval, in the same run
    pipe = trainer.pipeline
    committed = pack_kernel_weights(load_render_params(CKPT, pipe, device))
    _, _, ref_avg = render_path(
        pipe, committed, scene.poses[scene.i_test], scene.hwf, K, device=device,
        gt_imgs=scene.images[scene.i_test], verbose=False,
        generator=torch.Generator(device=device).manual_seed(0),
    )
    trained = trainer._avg_eval_psnr
    log(f"[train] step-{EVAL_STEP} eval over {len(scene.i_test)} test views "
        f"({pipe.sampling_mode}/{pipe.n_depth_samples}/{pipe.distance}): trained DepthNet "
        f"{trained:.4f} dB, committed DepthNet {ref_avg:.4f} dB, gap {ref_avg - trained:+.4f} dB "
        f"(gate: at most {EVAL_GAP_TOL} dB below)")
    require(trained >= ref_avg - EVAL_GAP_TOL, "the trained DepthNet evaluates too far below the committed one")
    return counts, trainer


def run_int8_training(device, scene, K, bf16_eval: float) -> dict[str, int]:
    """[int8-train]: the CLI with --mlp_impl pallas_int8, the training
    slice's recipe and seed against the same NeRF-only copy: K6 and K3 in
    int8 must launch and bf16 K6 must not; the loss must fall; the best
    DepthNet under the bf16 protocol (the bf16 kernels, the recipe's eval)
    within INT8_EVAL_TOL dB of the bf16 run's step-TRAIN_ITERS eval; then
    --mode nerf with int8 must raise. Returns the int8 launches."""
    import dataclasses
    import shutil

    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.render import pack_kernel_weights, render_path
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    t0 = time.perf_counter()
    shutil.rmtree(INT8_TRAIN_DIR, ignore_errors=True)
    os.makedirs(INT8_TRAIN_DIR)
    ft_path = os.path.join(INT8_TRAIN_DIR, "nerf_only.npz")
    write_nerf_only_checkpoint(ft_path)
    argv = ["-d", "example", "-m", "recommended_depth_net_module", "--mlp_impl", "pallas_int8",
            "--ft_path", ft_path, "--n_iters", str(TRAIN_ITERS), "-ip", str(TRAIN_PRINT), "--seed", "42",
            "--basedir", INT8_TRAIN_DIR, "--testskip", "1"]
    log(f"[int8-train] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
    reset_launches("render_gaussian_kernel", "render_gaussian_kernel_int8", "render_hier_kernel",
                   "render_hier_kernel_int8")
    trainer = run.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launched("render_hier_kernel_int8", "render_gaussian_kernel_int8")
    log(f"[int8-train] {trainer.global_step} steps in {wall:.1f} s (evals and checkpoints included); launches: "
        f"{counts}, bf16 K6 {n_launches('render_hier_kernel')}, bf16 K3 {n_launches('render_gaussian_kernel')}; "
        f"calib {trainer.pipeline.quant_calib}")
    for name, count in counts.items():
        require(count > 0, f"{name} was not launched by the int8 training run")
    require(n_launches("render_hier_kernel") == 0, "the int8 training run launched bf16 K6")
    with open(os.path.join(trainer.expdir, "psnr.txt")) as fp:
        lines = [ln for ln in fp if ln.startswith("Iter:")]
    losses = [float(ln.split("Depth Net Loss: ")[1].split(",")[0]) for ln in lines]
    log(f"[int8-train] Depth Net Loss at step {lines[0].split()[1]}: {losses[0]:.6f}, at step "
        f"{lines[-1].split()[1]}: {losses[-1]:.6f}")
    require(losses[-1] < losses[0], "the int8 run's depth-net loss did not fall")
    best = os.path.join(trainer.expdir, "best", f"depth_{EVAL_STEP:06d}.npz")
    require(os.path.exists(best), f"{best} was not written")
    pipe = dataclasses.replace(trainer.pipeline, mlp_impl="cuda", quant_calib=None)
    params = pack_kernel_weights(load_render_params(best, pipe, device))
    _, _, avg = render_path(pipe, params, scene.poses[scene.i_test], scene.hwf, K, device=device,
                            gt_imgs=scene.images[scene.i_test], verbose=False,
                            generator=torch.Generator(device=device).manual_seed(0))
    log(f"[int8-train] step-{EVAL_STEP} eval ({pipe.sampling_mode}/{pipe.n_depth_samples}/{pipe.distance}, "
        f"{len(scene.i_test)} test views): the int8 run's own (int8 kernels) {trainer._avg_eval_psnr:.4f} dB; its best "
        f"DepthNet under the bf16 protocol {avg:.4f} dB, the bf16 run's {bf16_eval:.4f} dB (delta "
        f"{avg - bf16_eval:+.4f}, tol {INT8_EVAL_TOL})")
    require(abs(avg - bf16_eval) <= INT8_EVAL_TOL, "the int8-oracle DepthNet is off the bf16 run's")
    try:
        run.main(["-d", "example", "--mode", "nerf", "--mlp_impl", "pallas_int8", "--n_iters", "1",
                  "--basedir", os.path.join(INT8_TRAIN_DIR, "nerf")])
        raised = ""
    except ValueError as e:
        raised = str(e)
    log(f"[int8-train] --mode nerf --mlp_impl pallas_int8 raises: {raised[:100]!r}")
    require("frozen NeRF" in raised, "--mode nerf with int8 did not raise the frozen-NeRF guard")
    log(f"[int8-train] phase {time.perf_counter() - t0:.1f} s")
    return counts


def check_train_step(trainer, scene, device) -> None:
    """One step on both paths from one state, batch and draws; the step's
    time on both paths; a profiled kernel-path step."""
    import copy
    import dataclasses

    from nerf_sampling_tpu_torch.render import make_ray_batch
    from nerf_sampling_tpu_torch.train.state import init_state
    from nerf_sampling_tpu_torch.train.steps import StepDraws, depth_net_loss, make_depth_net_train_step

    frozen = trainer.params
    pipes = {impl: dataclasses.replace(trainer.pipeline, mlp_impl=impl) for impl in ("cuda", "plain")}
    (ro, rd, target), = train_batches(scene, device, 1, seed=123)
    g = torch.Generator(device=device).manual_seed(9)
    p = trainer.pipeline
    draws = StepDraws(torch.rand((ro.shape[0], p.N_samples), generator=g, device=device),
                      torch.rand((ro.shape[0], p.N_importance), generator=g, device=device))
    res = {}
    for impl, pipe in pipes.items():
        depth = copy.deepcopy(frozen.depth)
        rays = make_ray_batch(pipe, ro, rd)
        loss, m = depth_net_loss(pipe, frozen, depth, rays, target, 0, draws)
        loss.backward()
        res[impl] = ({k: float(v) for k, v in m.items()},
                     torch.cat([q.grad.flatten() for q in depth.parameters()]))
    (mk, gk), (mp, gp) = res["cuda"], res["plain"]
    img_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    dep_rel = abs(mk["depth_net_loss"] - mp["depth_net_loss"]) / max(abs(mp["depth_net_loss"]), 1e-12)
    cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
    log(f"[step] one step from one state, batch and draws, cuda vs plain: img_loss {mk['loss']:.6e} vs "
        f"{mp['loss']:.6e} (rel {img_rel:.2e}, tol {STEP_IMG_TOL:g}); depth_net_loss "
        f"{mk['depth_net_loss']:.6e} vs {mp['depth_net_loss']:.6e} (rel {dep_rel:.2e}, tol "
        f"{STEP_DEPTH_TOL:g}); gradient cosine {cos:.6f} (tol {STEP_COS_TOL:g})")
    require(img_rel <= STEP_IMG_TOL and dep_rel <= STEP_DEPTH_TOL and cos >= STEP_COS_TOL,
            "the kernel and plain train steps disagree")

    batches = train_batches(scene, device, 12, seed=321)
    times = {}
    for impl, reps in (("cuda", 10), ("plain", 3)):
        state = init_state(copy.deepcopy(frozen.depth), trainer.cfg.depth_net_lr)
        step = make_depth_net_train_step(pipes[impl], frozen)

        def one(i, state=state, step=step):
            step(state, batches[i % len(batches)], 1000 + i)

        times[impl] = frame_ms(lambda it=iter(range(100)), one=one: one(next(it)), reps)
    log(f"[step] median ms per train step ({ro.shape[0]} rays, {p.N_samples}+{p.N_importance} "
        f"samples): kernel path {times['cuda']:.3f} ms, plain fp32 path {times['plain']:.3f} ms")

    state = init_state(copy.deepcopy(frozen.depth), trainer.cfg.depth_net_lr)
    step = make_depth_net_train_step(pipes["cuda"], frozen)
    step(state, batches[0], 7)
    wall, rows = profile_frame(lambda: step(state, batches[1], 8), "one kernel-path train step", top=8)
    k6_ms = sum(e.self_device_time_total for e in rows if "render_hier" in e.key) / 1e3
    log(f"[profile] K6 {k6_ms:.3f} ms: {100 * k6_ms / wall:.1f}% of the profiled {wall:.3f} ms step, "
        f"{100 * k6_ms / times['cuda']:.1f}% of the median unprofiled step ({times['cuda']:.3f} ms)")
    phase_times(state, frozen, pipes["cuda"], batches[2])


def phase_times(state, frozen, pipe, batch) -> None:
    """Device time of each phase of one kernel-path step (CUDA events):
    the K6 oracle, the DepthNet forward with the depth-point query, the
    backward and Adam."""
    from nerf_sampling_tpu_torch.core.compositing import raw2outputs
    from nerf_sampling_tpu_torch.core.metrics import img2mse
    from nerf_sampling_tpu_torch.core.sampling import z_to_points
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6
    from nerf_sampling_tpu_torch.render import make_ray_batch
    from nerf_sampling_tpu_torch.render.engine import query_fine_or_coarse

    ro, rd, target = batch
    rays = make_ray_batch(pipe, ro, rd)
    reps = 10
    parts, walls = np.zeros(4), []
    for rep in range(reps + 1):  # the first is a warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        with torch.no_grad():
            hm = k6.render_hier_kernel(frozen.kernels.hier, frozen.coarse.cfg, frozen.fine.cfg, ro, rd,
                                       n_coarse=pipe.N_samples, n_importance=pipe.N_importance, seed=rep)
        ev[1].record()
        depth_z = state.model(ro, rd)
        raw = query_fine_or_coarse(pipe, frozen, z_to_points(ro, rd, depth_z), rays)
        rgb = raw2outputs(raw, depth_z, rd, 0.0, pipe.white_bkgd).rgb_map
        loss = img2mse(rgb, target) + img2mse(depth_z, hm["max_z"][:, None])
        ev[2].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        state.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            walls.append((time.perf_counter() - t0) * 1e3)
            parts += [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    names = ("K6 oracle", "DepthNet forward + depth-point query + loss", "backward", "Adam")
    log(f"[phases] mean over {reps} steps, stream time between CUDA events (host gaps included): "
        + "; ".join(f"{n} {t / reps:.3f} ms" for n, t in zip(names, parts))
        + f"; host wall {np.mean(walls):.3f} ms")


def step_queries(params, scene, device):
    """The NeRF queries of one 1024-ray train step, as the nerf step makes
    them (plain sampling, injected draws): (rays, target, coarse points
    [65,536, 3], fine points [196,608, 3], fine z [1024, 192])."""
    import dataclasses

    from nerf_sampling_tpu_torch.render import make_ray_batch, sample_as_in_nerf

    (ro, rd, target), = train_batches(scene, device, 1, seed=77)
    pipe = dataclasses.replace(production_pipeline("plain"), depth=None)
    rays = make_ray_batch(pipe, ro, rd)
    g = torch.Generator(device=device).manual_seed(4)
    with torch.no_grad():
        hier = sample_as_in_nerf(pipe, params, rays, t_rand=torch.rand((ro.shape[0], 64), generator=g, device=device),
                                 u=torch.rand((ro.shape[0], 128), generator=g, device=device))
    coarse_pts = (rays.rays_o[:, None, :] + rays.rays_d[:, None, :] * hier.coarse_z_vals[..., None]).reshape(-1, 3)
    return rays, target, coarse_pts.contiguous(), hier.fine_pts.reshape(-1, 3).contiguous(), hier.fine_z_vals


def check_k4(params, queries) -> dict:
    """K4 on the coarse (65,536) and fine (196,608) queries of a step,
    against its plain bf16 version, which is held against fp32; K4 runs
    the wgmma core: its launch shape, one block alone and its registers at
    both sizes."""
    from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
    from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf, pack_slices

    rays, _, coarse_pts, fine_pts, _ = queries
    dirs = rays.viewdirs.contiguous()
    rec = {}
    build.load_library()
    log(f"[k4] nerf_points_kernel (wgmma core): {ptxas_usage(build.build_info['log'], 'nerf_points_kernel')}")
    for name, model, pts in (("coarse", params.coarse, coarse_pts), ("fine", params.fine, fine_pts)):
        packed, packed32 = pack_nerf(model), pack_nerf(model, torch.float32)
        sl = pack_slices(packed)
        got = k4.nerf_points_kernel(packed, model.cfg, pts, dirs, slices=sl)
        torch.cuda.synchronize()
        plain = k4.nerf_points_plain(packed, model.cfg, pts, dirs)
        ref32 = k4.nerf_points_plain(packed32, model.cfg, pts, dirs, dtype=torch.float32)
        mean, mx = errors(got, plain)
        mean32, mx32 = errors(plain, ref32)
        log(f"[k4] {name} NeRF, {pts.shape[0]} points: |raw| kernel vs plain bf16 mean {mean:.3e} max {mx:.3e}; "
            f"plain bf16 vs plain fp32 mean {mean32:.3e} max {mx32:.3e}")
        require(bool(torch.isfinite(got).all()), f"K4 {name}: non-finite raw")
        require(mean <= mean32 and mx <= mx32, f"K4 {name}: further from its plain bf16 version than bf16 is from fp32")
        ms = cuda_ms(lambda: k4.nerf_points_kernel(packed, model.cfg, pts, dirs, slices=sl), 10)
        plain_ms = cuda_ms(lambda: k4.nerf_points_plain(packed, model.cfg, pts, dirs), 3)
        occ = k4.kernel_occupancy(pts.shape[0])
        # one block alone: its rows, walked as in the full launch (sized as for a card of one SM)
        rows, S, sms = 128 * occ["tiles_per_block"], pts.shape[0] // dirs.shape[0], build.sm_count
        build.sm_count = lambda device: 1
        try:
            ms_one = cuda_ms(lambda: k4.nerf_points_kernel(packed, model.cfg, pts[:rows], dirs[:rows // S], slices=sl),
                             20)
        finally:
            build.sm_count = sms
        log(f"[k4] {name}: {ms:.3f} ms per launch; plain bf16 version {plain_ms:.3f} ms "
            f"({2 * 0.593e6 * pts.shape[0] / ms / 1e9:.1f} TFLOP/s at 2 x 593K MAC per row); launch shape "
            f"{occ['blocks']} blocks of {occ['tiles_per_block']} tiles of 128 rows ({occ['threads']} threads, "
            f"{occ['smem_bytes']} bytes of shared memory), {occ['blocks_per_sm']} resident per SM x {occ['sms']} SMs, "
            f"{occ['blocks'] / (occ['blocks_per_sm'] * occ['sms']):.2f} waves; one block of {rows} rows alone "
            f"{ms_one:.3f} ms")
        require(occ["threads"] == 288 and occ["blocks_per_sm"] == 1 and occ["blocks"] <= occ["sms"],
                f"K4 {name}: not the wgmma core's launch (288 threads, one block per SM, one wave)")
        rec = kernel_record("nerf_points_kernel", "nerf_points.cu", "nerf_sampling_tpu/kernels/fused_nerf.py:301",
                            mx, ms, plain_ms, 2 * pts.shape[0] * module_macs(model), nbytes(pts, dirs, packed, got),
                            core=CORE)
    return rec  # the fine query's numbers


def step_cotangent(params, queries) -> torch.Tensor:
    """dL/draw [196,608, 4] of the fine query under a step's loss
    (img2mse of the composited fine rgb), from the fp32 plain path."""
    from nerf_sampling_tpu_torch.core.compositing import raw2outputs
    from nerf_sampling_tpu_torch.core.metrics import img2mse
    from nerf_sampling_tpu_torch.kernels import fused_nerf as k4
    from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf

    rays, target, _, fine_pts, fine_z = queries
    raw = k4.nerf_points_plain(pack_nerf(params.fine, torch.float32), params.fine.cfg, fine_pts,
                               rays.viewdirs.contiguous(), dtype=torch.float32).requires_grad_(True)
    out = raw2outputs(raw.reshape(*fine_z.shape, 4), fine_z, rays.rays_d, 0.0, True)
    img2mse(out.rgb_map, target).backward()
    return raw.grad.contiguous()


def check_k5(params, queries) -> dict:
    """K5 on the fine query with a real step's cotangent: against its plain
    bf16 version (per-tensor error, both want_dx settings), bits across
    launches and across want_dx, cosine to fp32 autograd of the module;
    then the coarse NeRF's cosine on its own query."""
    from nerf_sampling_tpu_torch.kernels import fused_nerf_vjp as k5
    from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf
    from nerf_sampling_tpu_torch.render.engine import Pipeline, query_nerf

    rays, _, coarse_pts, fine_pts, _ = queries
    dirs = rays.viewdirs.contiguous()
    g_fine = step_cotangent(params, queries)

    def flat(grads):
        return torch.cat([x.flatten().float() for x in grads])

    def autograd_fp32(model, pts, g):
        model.zero_grad(set_to_none=True)
        raw = query_nerf(Pipeline(nerf=model.cfg), model, pts.reshape(dirs.shape[0], -1, 3), dirs)
        (raw.reshape(-1, 4) * g).sum().backward()
        out = flat([q.grad for q in model.parameters()])
        model.zero_grad(set_to_none=True)
        return out

    model = params.fine
    packed = pack_nerf(model)
    worst = 0.0
    grads = {}
    for want_dx in (False, True):
        d, dpts, ddirs = k5.nerf_points_bwd_kernel(packed, model.cfg, fine_pts, dirs, g_fine, want_dx=want_dx)
        torch.cuda.synchronize()
        dp, dpts_p, ddirs_p = k5.nerf_points_bwd_plain(packed, model.cfg, fine_pts, dirs, g_fine, want_dx=want_dx)
        got, want = k5.grads_to_params(model, d), k5.grads_to_params(model, dp)
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(got, want))
        msg = f"[k5] want_dx={want_dx}: worst per-tensor max|d grad| / max|grad| vs plain bf16 {rel:.3e} (tol {K5_REL_TOL:g})"
        if want_dx:
            for name, a, b in (("d pts", dpts, dpts_p), ("d dirs", ddirs, ddirs_p)):
                r = float((a - b).abs().max()) / float(b.abs().max())
                msg += f"; {name} {r:.3e}"
                rel = max(rel, r)
        log(msg)
        require(rel <= K5_REL_TOL, f"K5 (want_dx={want_dx}) disagrees with its plain version")
        worst = max(worst, rel)
        grads[want_dx] = flat(got)
    again = flat(k5.grads_to_params(model, k5.nerf_points_bwd_kernel(packed, model.cfg, fine_pts, dirs, g_fine,
                                                                     want_dx=False)[0]))
    require(torch.equal(grads[False], grads[True]), "K5: param grads differ with want_dx on and off")
    require(torch.equal(grads[False], again), "K5: two launches on the same inputs gave different bits")
    cos_fine = float(torch.nn.functional.cosine_similarity(grads[False], autograd_fp32(model, fine_pts, g_fine), dim=0))
    g_coarse = torch.randn(coarse_pts.shape[0], 4, generator=torch.Generator(device=dirs.device).manual_seed(6),
                           device=dirs.device) * float(g_fine.abs().mean())
    d_c, _, _ = k5.nerf_points_bwd_kernel(pack_nerf(params.coarse), params.coarse.cfg, coarse_pts, dirs, g_coarse,
                                          want_dx=False)
    cos_coarse = float(torch.nn.functional.cosine_similarity(
        flat(k5.grads_to_params(params.coarse, d_c)), autograd_fp32(params.coarse, coarse_pts, g_coarse), dim=0))
    log(f"[k5] param grads identical with want_dx off and on and across two launches; cosine to fp32 autograd: "
        f"fine {cos_fine:.6f} (step cotangent), coarse {cos_coarse:.6f} (random cotangent) (tol {K5_COS_TOL})")
    require(cos_fine >= K5_COS_TOL and cos_coarse >= K5_COS_TOL, "K5 gradients point away from fp32 autograd")
    ms = cuda_ms(lambda: k5.nerf_points_bwd_kernel(packed, model.cfg, fine_pts, dirs, g_fine, want_dx=False), 5)
    ms_dx = cuda_ms(lambda: k5.nerf_points_bwd_kernel(packed, model.cfg, fine_pts, dirs, g_fine, want_dx=True), 3)
    plain_ms = cuda_ms(lambda: k5.nerf_points_bwd_plain(packed, model.cfg, fine_pts, dirs, g_fine, want_dx=False), 3)
    passes = [0.0, 0.0, 0.0]
    reps = 5
    for _ in range(reps):  # each pass between CUDA events recorded on the launching stream
        events = []
        k5.nerf_points_bwd_kernel(packed, model.cfg, fine_pts, dirs, g_fine, want_dx=False, events=events)
        torch.cuda.synchronize()
        for k in range(3):
            passes[k] += events[k].elapsed_time(events[k + 1]) / reps
    library_ms = k5_library_ms(model, fine_pts.shape[0], dirs.device)
    rows = fine_pts.shape[0]
    log(f"[k5] {rows} rows: {ms:.3f} ms per launch (want_dx off), {ms_dx:.3f} ms (on); plain bf16 "
        f"version {plain_ms:.3f} ms ({3 * 2 * 0.593e6 * rows / ms / 1e9:.1f} TFLOP/s at 3 x 2 x 593K "
        "MAC per row: recompute, d_h chain, weight grads)")
    log(f"[k5] by pass (CUDA events, mean of {reps}): (a) row pass on the wgmma core {passes[0]:.3f} ms "
        f"({2 * 2 * 0.593e6 * rows / passes[0] / 1e9:.1f} TFLOP/s at 2 x 2 x 593K MAC per row), (b) weight-grad "
        f"GEMMs {passes[1]:.3f} ms ({2 * 0.593e6 * rows / passes[1] / 1e9:.1f} TFLOP/s), (c) reductions "
        f"{passes[2]:.3f} ms; torch.matmul of (b)'s products on the same shapes {library_ms:.3f} ms")
    # the recompute, the d_h chain and the weight grads: three products of the forward's size; the
    # inputs, the weights and the grads (as many values as the weights) once each
    return kernel_record("nerf_points_bwd_kernel", "nerf_points_bwd.cu",
                         "nerf_sampling_tpu/kernels/fused_nerf_vjp.py:272", worst, ms, plain_ms,
                         3 * 2 * fine_pts.shape[0] * module_macs(model),
                         nbytes(fine_pts, dirs, g_fine, packed, packed), library_ms=library_ms, core=CORE)


def k5_library_ms(model, rows: int, device) -> float:
    """The yardstick of K5's pass (b): torch.matmul of its weight-grad
    products A^T @ dZ (bf16 operands [rows, K] and [rows, N], one call each,
    fp32 accumulation inside cuBLAS) on random data of the same shapes;
    timed here, used nowhere in the port."""
    from nerf_sampling_tpu_torch.kernels import fused_nerf_vjp as k5
    from nerf_sampling_tpu_torch.kernels.fused_render import pack_nerf

    g = torch.Generator(device=device).manual_seed(12)
    ops = [(torch.randn(rows, K, generator=g, device=device).bfloat16(),
            torch.randn(rows, N, generator=g, device=device).bfloat16())
           for _, _, K, N in k5.grad_jobs(pack_nerf(model))]

    def products():
        for a, b in ops:
            torch.matmul(a.T, b)

    ms = cuda_ms(products, 5)
    del ops
    return ms


def check_k7(params, scene, K, device) -> dict:
    """K7 over the 160,000 rays of test view 0 in one launch against its
    plain bf16 version; FULL_NERF of view 0 on the kernels against the
    plain fp32 path; the 4 test views on the kernels; frame times."""
    import dataclasses

    from nerf_sampling_tpu_torch.core.rays import get_rays
    from nerf_sampling_tpu_torch.kernels import fused_hier as k67
    from nerf_sampling_tpu_torch.render import EvalMode, render_image

    H, W, Kc, c2w = view0_camera()
    ro, rd = get_rays(H, W, Kc, c2w, device)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    packed = params.kernels.hier
    cfg_c, cfg_f = params.coarse.cfg, params.fine.cfg
    got = k67.render_hier_kernel(packed, cfg_c, cfg_f, ro, rd)
    torch.cuda.synchronize()
    chunk = 16384
    parts = [k67.render_hier_plain(packed, cfg_c, cfg_f, ro[s:s + chunk], rd[s:s + chunk])
             for s in range(0, ro.shape[0], chunk)]
    plain = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    d = (got["rgb_map"] - plain["rgb_map"]).abs()
    mean, p999, mx = float(d.mean()), quantile(d, 0.999), float(d.max())
    log(f"[k7] {ro.shape[0]} rays, one launch: |rgb| vs plain bf16 mean {mean:.3e} p99.9 {p999:.3e} max {mx:.3e} "
        f"(tol {K7_MEAN_TOL:g}/{K7_P999_TOL:g})")
    require(mean <= K7_MEAN_TOL and p999 <= K7_P999_TOL, "K7 disagrees with its plain version")

    pipe = dataclasses.replace(production_pipeline("cuda"), depth=None)
    plain_pipe = dataclasses.replace(pipe, mlp_impl="plain")
    gts = scene.images[scene.i_test]
    poses = [scene.poses[i][:3, :4] for i in scene.i_test]

    Hs, Ws, _ = scene.hwf

    def render(p, c2w_):
        return render_image(p, params, Hs, Ws, K, c2w_, device=device, mode=EvalMode.FULL_NERF)

    def psnr(img, gt):
        return float(-10 * np.log10(np.mean((img["depth_net_rgb_map"].float().cpu().numpy() - gt) ** 2)))

    reset_launches("render_hier_kernel_det")
    psnrs = [psnr(render(pipe, c), gt) for c, gt in zip(poses, gts)]
    require(n_launches("render_hier_kernel_det") == len(poses),
            "the FULL_NERF kernel path did not launch K7 once per view")
    psnr_plain = psnr(render(plain_pipe, poses[0]), gts[0])
    log(f"[k7] FULL_NERF on the kernels, per test view {['%.4f' % p for p in psnrs]}; view 0 on the plain fp32 "
        f"path {psnr_plain:.4f} dB (|delta| {abs(psnrs[0] - psnr_plain):.4f}, tol {FULL_PSNR_TOL})")
    require(abs(psnrs[0] - psnr_plain) <= FULL_PSNR_TOL, "FULL_NERF: kernel and plain fp32 paths disagree")
    ms = cuda_ms(lambda: k67.render_hier_kernel(packed, cfg_c, cfg_f, ro, rd), 3)
    plain_ms = cuda_ms(lambda: [k67.render_hier_plain(packed, cfg_c, cfg_f, ro[s:s + chunk], rd[s:s + chunk])
                                for s in range(0, ro.shape[0], chunk)], 1)
    frame_k = frame_ms(lambda: render(pipe, poses[0]), 3)
    frame_p = frame_ms(lambda: render(plain_pipe, poses[0]), 1)
    log(f"[k7] {ms:.3f} ms per launch; plain bf16 version {plain_ms:.3f} ms (chunks of {chunk} rays); FULL_NERF "
        f"400x400 frame {frame_k:.2f} ms on the kernels, {frame_p:.2f} ms on the plain fp32 path")
    flop = 2 * ro.shape[0] * (64 * module_macs(params.coarse, True) + 192 * module_macs(params.fine))
    return kernel_record("render_hier_kernel_det", "render_hier.cu", "nerf_sampling_tpu/kernels/fused_hier.py:255",
                         mx, ms, plain_ms, flop, nbytes(ro, rd, packed, got), core=CORE)


def mip_gaps(got: dict, want: dict) -> dict[str, float]:
    """[mip]'s numbers: |rgb| mean, p99.9 and max, |depth| mean over the rays
    ``want`` finds opaque (acc > 0.5), |acc| mean."""
    d = (got["rgb_map"] - want["rgb_map"]).abs()
    fg = want["acc_map"] > 0.5
    return {"rgb_mean": float(d.mean()), "rgb_p999": quantile(d, 0.999), "rgb_max": float(d.max()),
            "depth": float((got["depth_map"][fg] - want["depth_map"][fg]).abs().mean()),
            "acc": float((got["acc_map"] - want["acc_map"]).abs().mean())}


def mip_within(g: dict) -> bool:
    return (g["rgb_mean"] <= MIP_RGB_MEAN_TOL and g["rgb_p999"] <= MIP_RGB_P999_TOL and g["depth"] <= MIP_DEPTH_TOL
            and g["acc"] <= MIP_ACC_TOL)


def check_mip(device) -> tuple[dict, dict[str, int]]:
    """K11 on mip-NeRF's published widths with glorot weights from MIP_SEED:
    an 800x800 frame (test view 0's pose) through render_image in one launch,
    equal to the direct launch; every ray of it and MIP_RAGGED ragged
    launches against the plain version in chunks; K11 without the
    integration must fail the same tolerances. Returns K11's record (640,000
    rays, 128 + 128 intervals) and its launches on the render path."""
    import dataclasses

    from nerf_sampling_tpu_torch.core.rays import get_rays_mip
    from nerf_sampling_tpu_torch.data.example import _CAMERA_ANGLE_X
    from nerf_sampling_tpu_torch.kernels import fused_mip as k11
    from nerf_sampling_tpu_torch.models.mipnerf import MipNeRF, MipNeRFConfig, init_glorot
    from nerf_sampling_tpu_torch.render import EvalMode, render_image
    from nerf_sampling_tpu_torch.render.engine import NeRFParams, Pipeline, make_nerf_slices, pack_kernel_weights

    cfg = MipNeRFConfig()
    model = init_glorot(MipNeRF(cfg), torch.Generator().manual_seed(MIP_SEED)).to(device)
    H = W = 800
    focal = 0.5 * W / np.tan(0.5 * _CAMERA_ANGLE_X)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float32)
    c2w = view0_camera()[3]
    pipe = Pipeline(nerf=cfg, near=2.0, far=6.0, white_bkgd=True, mlp_impl="cuda")
    params = pack_kernel_weights(NeRFParams(coarse=model))
    make_nerf_slices(params.kernels)
    packed = params.kernels.mip
    ro, rd, rr = (t.reshape(-1, t.shape[-1]).contiguous() for t in get_rays_mip(H, W, K, c2w, device))
    n = ro.shape[0]

    reset_launches("render_mip_kernel")
    frame = render_image(pipe, params, H, W, K, c2w, device=device, mode=EvalMode.FULL_NERF)
    torch.cuda.synchronize()
    require(n_launches("render_mip_kernel") == 1,
            f"render_image of an {H}x{W} mip-NeRF frame made {n_launches('render_mip_kernel')} K11 launches, not 1")
    got = k11.render_mip_kernel(packed, cfg, ro, rd, rr)
    require(all(torch.equal(frame[a].reshape(-1), got[b].reshape(-1)) for a, b in (
        ("depth_net_rgb_map", "rgb_map"), ("depth_net_z_vals", "depth_map"), ("depth_net_weights", "acc_map"))),
        "[mip] render_image's maps differ from the direct K11 launch on the same rays")

    chunk = 4096

    def plain(o, d, r):
        parts = [k11.render_mip_plain(packed, cfg, o[s:s + chunk], d[s:s + chunk], r[s:s + chunk])
                 for s in range(0, o.shape[0], chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    want = plain(ro, rd, rr)
    frame_gaps = mip_gaps(got, want)
    rows = [torch.linspace(0, n - 1, m, device=device).long() for m in MIP_RAGGED]
    reset_launches("render_mip_kernel")
    ragged = [k11.render_mip_kernel(packed, cfg, ro[r], rd[r], rr[r]) for r in rows]
    require(n_launches("render_mip_kernel") == len(MIP_RAGGED), "[mip] a ragged call did not launch K11 once")
    cat = torch.cat(rows)
    ragged_gaps = mip_gaps({k: torch.cat([g[k] for g in ragged]) for k in got},
                           {k: v[cat] for k, v in want.items()})
    fault = k11.render_mip_kernel(packed, dataclasses.replace(cfg, disable_integration=True), ro, rd, rr)
    fault_gaps = mip_gaps(fault, want)
    tols = (f"tol rgb mean {MIP_RGB_MEAN_TOL:g}, p99.9 {MIP_RGB_P999_TOL:g}, depth {MIP_DEPTH_TOL:g}, "
            f"acc {MIP_ACC_TOL:g}")
    for tag, g in ((f"{H}x{W} frame, {n} rays", frame_gaps), (f"ragged {MIP_RAGGED}", ragged_gaps),
                   ("without the integration (a fault)", fault_gaps)):
        log(f"[mip] K11 vs plain, {tag}: |rgb| mean {g['rgb_mean']:.3e} p99.9 {g['rgb_p999']:.3e} "
            f"max {g['rgb_max']:.3e}, |depth| {g['depth']:.3e}, |acc| {g['acc']:.3e} ({tols})")
    require(mip_within(frame_gaps), "[mip] K11 disagrees with its plain version over the frame")
    require(mip_within(ragged_gaps), "[mip] K11 disagrees with its plain version on ragged launches")
    require(not mip_within(fault_gaps), "[mip] K11 without the integration passes the tolerances")

    ms = cuda_ms(lambda: k11.render_mip_kernel(packed, cfg, ro, rd, rr), 3)
    plain_ms = cuda_ms(lambda: plain(ro, rd, rr), 1)
    occ = k11.kernel_occupancy(cfg.num_samples)
    log(f"[mip] {ms:.3f} ms per launch ({n} rays, {cfg.num_samples} + {cfg.num_samples} intervals; {occ}); "
        f"plain version {plain_ms:.3f} ms (chunks of {chunk} rays)")
    macs = module_macs(model, sigma_only=False)
    coarse_macs = sum(lin.weight.numel() for lin in model.pts_linears) + model.density_linear.weight.numel()
    flop = 2 * n * cfg.num_samples * (coarse_macs + macs)
    rec = kernel_record("render_mip_kernel", "render_mip.cu", "none: the JAX package has no mip-NeRF",
                        frame_gaps["rgb_max"], ms, plain_ms, flop, nbytes(ro, rd, rr, packed, got), core=CORE)
    log(f"[mip] bound {rec['bound_ms']:.2f} ms ({rec['bound_by']}): {100 * rec['bound_ms'] / ms:.1f}% of it")
    return rec, {"render_mip_kernel": 1}


def check_nerf_steps(scene, device) -> None:
    """One nerf step and one joint step from one state, batch and draws,
    cuda against plain; the median step time of both paths; one profiled
    kernel-path nerf step."""
    import copy
    import dataclasses

    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params
    from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
    from nerf_sampling_tpu_torch.train.steps import StepDraws, make_joint_train_step, make_nerf_train_step

    base = load_render_params(CKPT, production_pipeline("plain"), device)
    pipes = {impl: production_pipeline(impl) for impl in ("cuda", "plain")}
    batch, = train_batches(scene, device, 1, seed=124)
    n = batch[0].shape[0]
    g = torch.Generator(device=device).manual_seed(10)
    draws = StepDraws(torch.rand((n, 64), generator=g, device=device),
                      torch.rand((n, 128), generator=g, device=device))

    def states(joint):
        nerf = init_nerf_state(nerf_modules(copy.deepcopy(base.coarse), copy.deepcopy(base.fine)), 5e-4, 500)
        return (nerf, init_state(copy.deepcopy(base.depth), 1e-4)) if joint else (nerf,)

    def net_grads(st, net):
        return torch.cat([q.grad.flatten() for name, q in st.model.named_parameters() if name.startswith(net + ".")])

    res = {}
    for impl, pipe in pipes.items():
        (nst,) = states(False)
        _, m = make_nerf_train_step(pipe)(nst, batch, 0, draws)
        jn, jd = states(True)
        _, _, jm = make_joint_train_step(pipe)(jn, jd, batch, 0, draws)
        grads = {f"nerf {net}": net_grads(nst, net) for net in ("coarse", "fine")}
        grads.update({f"joint {net}": net_grads(jn, net) for net in ("coarse", "fine")})
        grads["joint depth"] = torch.cat([q.grad.flatten() for q in jd.model.parameters()])
        res[impl] = ({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in jm.items()}, grads)
    (mk, jmk, gk), (mp, jmp, gp) = res["cuda"], res["plain"]
    for what, a, b in (("nerf", mk, mp), ("joint", jmk, jmp)):
        rel = abs(a["img_loss"] - b["img_loss"]) / b["img_loss"]
        log(f"[step] {what} step, cuda vs plain from one state, batch and draws: img_loss {a['img_loss']:.6e} vs "
            f"{b['img_loss']:.6e} (rel {rel:.2e}, tol {NSTEP_IMG_TOL:g})")
        require(rel <= NSTEP_IMG_TOL, f"the {what} steps' img_loss disagree")
    for net in gk:
        if float(gp[net].norm()) == 0.0:
            log(f"[step] {net}: zero gradient on the plain path (no density on this batch); kernel path norm "
                f"{float(gk[net].norm()):.3e}")
            require(float(gk[net].norm()) == 0.0, f"{net}: the kernel path has a gradient where plain has none")
            continue
        cos = float(torch.nn.functional.cosine_similarity(gk[net], gp[net], dim=0))
        log(f"[step] {net}: gradient cosine cuda vs plain {cos:.6f} (tol {NSTEP_COS_TOL})")
        require(cos >= NSTEP_COS_TOL, f"{net}: the kernel and plain gradients disagree")

    batches = train_batches(scene, device, 12, seed=322)
    times = {}
    for impl, reps in (("cuda", 10), ("plain", 3)):
        (nst,) = states(False)
        nstep = make_nerf_train_step(pipes[impl])
        jn, jd = states(True)
        jstep = make_joint_train_step(pipes[impl])
        it = iter(range(100))
        times[impl, "nerf"] = frame_ms(lambda: nstep(nst, batches[next(it) % 12], 1000), reps)
        it2 = iter(range(100))
        times[impl, "joint"] = frame_ms(lambda: jstep(jn, jd, batches[next(it2) % 12], 1000), reps)
    log(f"[step] median ms per step (1024 rays, 64+128 samples): nerf {times['cuda', 'nerf']:.3f} on the kernels, "
        f"{times['plain', 'nerf']:.3f} plain fp32; joint {times['cuda', 'joint']:.3f} on the kernels, "
        f"{times['plain', 'joint']:.3f} plain fp32")
    (nst,) = states(False)
    nstep = make_nerf_train_step(pipes["cuda"])
    nstep(nst, batches[0], 7)
    wall, rows = profile_frame(lambda: nstep(nst, batches[1], 8), "one kernel-path nerf step", top=10)
    k4_ms = sum(e.self_device_time_total for e in rows if "nerf_points_kernel" in e.key) / 1e3
    k5_ms = sum(e.self_device_time_total for e in rows
                if any(k in e.key for k in ("nerf_bwd_rows", "wgrad_kernel", "reduce_kernel"))) / 1e3
    log(f"[profile] K4 {k4_ms:.3f} ms, K5 {k5_ms:.3f} ms: {100 * (k4_ms + k5_ms) / wall:.1f}% of the profiled "
        f"{wall:.3f} ms step, {100 * (k4_ms + k5_ms) / times['cuda', 'nerf']:.1f}% of the median unprofiled step")


def nerf_losses(expdir: str) -> list[tuple[int, float]]:
    with open(os.path.join(expdir, "psnr.txt")) as fp:
        return [(int(ln.split()[1]), float(ln.split("Loss: ")[1].split(",")[0])) for ln in fp if ln.startswith("Iter:")]


def run_nerf_cli(device) -> dict[str, int]:
    """--mode nerf from scratch through the CLI's main, on the kernels and
    on the plain path, same seed, batches and draws; returns the kernel
    run's launch counts."""
    import shutil

    from nerf_sampling_tpu_torch.experiments import run

    shutil.rmtree(NERF_DIR, ignore_errors=True)
    evals, counts = {}, {}
    for impl in ("cuda", "plain"):
        argv = ["-d", "example", "--mode", "nerf", "--mlp_impl", impl, "--seed", "0", "--testskip", "1",
                "--n_iters", str(NERF_ITERS), "--i_testset", str(NERF_ITERS), "-ip", str(NERF_PRINT),
                "--basedir", os.path.join(NERF_DIR, impl)]
        log(f"[nerf] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
        reset_launches("nerf_points_kernel", "nerf_points_bwd_kernel", "render_hier_kernel_det")
        t0 = time.perf_counter()
        trainer = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the center-crop phase's losses (precrop_iters): the later full-image batches see
        # rays the crop never trained, so their loss is no measure of the fall
        losses = [(i, v) for i, v in nerf_losses(trainer.expdir) if i < trainer.cfg.precrop_iters]
        evals[impl] = trainer._avg_eval_psnr
        log(f"[nerf] {impl}: {trainer.global_step} steps in {wall:.1f} s (the eval included); loss at step "
            f"{losses[0][0]} {losses[0][1]:.6f}, at step {losses[-1][0]} {losses[-1][1]:.6f} (the center-crop "
            f"phase, precrop_iters {trainer.cfg.precrop_iters}); FULL_NERF eval over "
            f"{len(trainer.scene.i_test)} test views {evals[impl]:.4f} dB")
        require(losses[-1][1] < losses[0][1], f"the {impl} nerf-mode loss did not fall")
        if impl == "cuda":
            counts = launched("nerf_points_kernel", "nerf_points_bwd_kernel", "render_hier_kernel_det")
            log(f"[nerf] launches during the kernel run: {counts}")
            for name, count in counts.items():
                require(count > 0, f"{name} was not launched by the nerf-mode run")
    log(f"[nerf] eval: kernels {evals['cuda']:.4f} dB, plain {evals['plain']:.4f} dB, |delta| "
        f"{abs(evals['cuda'] - evals['plain']):.4f} (tol {NERF_EVAL_TOL})")
    require(abs(evals["cuda"] - evals["plain"]) <= NERF_EVAL_TOL, "the kernel and plain nerf-mode runs disagree")
    return counts


def write_full_checkpoint(path: str) -> None:
    """The committed checkpoint's NeRFs and DepthNet, as a JAX-layout .npz at step 0."""
    from nerf_sampling_tpu_torch.train import checkpoint as ck

    tree, _ = ck.read_npz_tree(CKPT)
    ck.save_checkpoint(path, {"params": ck.JaxNeRFParams(**ck.params_to_jax(ck.params_from_jax(tree["params"])))}, 0)


def run_joint_cli(device, scene, K) -> dict[str, int]:
    """--mode joint through the CLI's main from the committed NeRFs and
    DepthNet with a warmup, on the kernels and on the plain path (same
    seed, batches and draws); returns the kernel run's launch counts."""
    import dataclasses
    import shutil

    import yaml

    from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.render import pack_kernel_weights, render_path
    from nerf_sampling_tpu_torch.train import checkpoint as ck
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    shutil.rmtree(JOINT_DIR, ignore_errors=True)
    os.makedirs(JOINT_DIR)
    ft_path = os.path.join(JOINT_DIR, "committed.npz")
    write_full_checkpoint(ft_path)
    # the recipe with a checkpoint every JOINT_WARMUP steps, to read the DepthNet at the warmup's end
    with open(REFERENCE_CONFIG) as fp:
        entry = yaml.safe_load(fp)["recommended_depth_net_module"]
    entry["kwargs"]["i_weights"] = JOINT_WARMUP
    config = os.path.join(JOINT_DIR, "joint.yaml")
    with open(config, "w") as fp:
        yaml.safe_dump({"recommended_depth_net_module": entry}, fp)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [np.asarray(tree, np.float32)]

    start = leaves(ck.read_npz_tree(ft_path)[0]["params"]["depth"])
    evals, counts = {}, {}
    for impl in ("cuda", "plain"):
        argv = ["-c", config, "-m", "recommended_depth_net_module", "-d", "example", "--mode", "joint",
                "--mlp_impl", impl, "--joint_depth_warmup", str(JOINT_WARMUP), "--n_iters", str(JOINT_ITERS),
                "--i_testset", str(JOINT_ITERS), "-ip", str(NERF_PRINT), "--ft_path", ft_path, "--seed", "0",
                "--testskip", "1", "--basedir", os.path.join(JOINT_DIR, impl)]
        log(f"[joint] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
        reset_launches("depth_net_kernel", "render_gaussian_kernel", "nerf_points_kernel", "nerf_points_bwd_kernel")
        t0 = time.perf_counter()
        trainer = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        evals[impl] = trainer._avg_eval_psnr
        log(f"[joint] {impl}: {trainer.global_step} steps in {wall:.1f} s (evals and checkpoints included); "
            f"step-{JOINT_ITERS} eval ({trainer.pipeline.sampling_mode}/{trainer.pipeline.n_depth_samples}/"
            f"{trainer.pipeline.distance}) {evals[impl]:.4f} dB")
        at = {i: leaves(ck.read_npz_tree(os.path.join(trainer.expdir, f"{i:06d}.npz"))[0]["params"]["depth"])
              for i in (JOINT_WARMUP, JOINT_ITERS)}
        frozen = all(np.array_equal(a, b) for a, b in zip(at[JOINT_WARMUP], start))
        moved = not all(np.array_equal(a, b) for a, b in zip(at[JOINT_ITERS], start))
        with open(os.path.join(trainer.expdir, "metrics.jsonl")) as fp:
            live = [(r["step"], r["depth_live"]) for r in map(json.loads, fp) if "depth_live" in r]
        log(f"[joint] {impl}: DepthNet at step {JOINT_WARMUP} bit-identical to the start: {frozen}; at step "
            f"{JOINT_ITERS} changed: {moved}; depth_live by step {live}")
        require(frozen and moved, f"{impl}: the DepthNet was not held through the warmup and trained after it")
        require(live[0][1] == 0.0 and live[-1][1] == 1.0, f"{impl}: depth_live did not go from 0 to 1")
        if impl == "cuda":
            counts = launched("nerf_points_kernel", "nerf_points_bwd_kernel", "depth_net_kernel",
                              "render_gaussian_kernel")
            log(f"[joint] launches during the kernel run: {counts}")
            for name, count in counts.items():
                require(count > 0, f"{name} was not launched by the joint run")
    pipe = dataclasses.replace(trainer.pipeline, mlp_impl="cuda")
    committed = pack_kernel_weights(load_render_params(CKPT, pipe, device))
    _, _, ref_avg = render_path(pipe, committed, scene.poses[scene.i_test], scene.hwf, K, device=device,
                                gt_imgs=scene.images[scene.i_test], verbose=False,
                                generator=torch.Generator(device=device).manual_seed(0))
    log(f"[joint] step-{JOINT_ITERS} eval: kernels {evals['cuda']:.4f} dB, plain {evals['plain']:.4f} dB "
        f"(|delta| {abs(evals['cuda'] - evals['plain']):.4f}, tol {NERF_EVAL_TOL}); the committed pair under the "
        f"same eval {ref_avg:.4f} dB: kernel run {evals['cuda'] - ref_avg:+.4f} dB, plain run "
        f"{evals['plain'] - ref_avg:+.4f} dB")
    require(abs(evals["cuda"] - evals["plain"]) <= NERF_EVAL_TOL, "the kernel and plain joint runs disagree")
    return counts


def run_tar(device, scene, K) -> dict[str, int]:
    """[tar]: the reference's .tar format through the port's entry points
    on the kernels; returns the phase's launches by kernel."""
    import copy
    import dataclasses
    import shutil

    import yaml

    from nerf_sampling_tpu_torch.data.example import generate_example_dataset
    from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.experiments import render as rcli
    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.train import checkpoint as ck
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
    from nerf_sampling_tpu_torch.train.state import init_nerf_state, nerf_modules
    from nerf_sampling_tpu_torch.train.steps import StepDraws, make_nerf_train_step
    from nerf_sampling_tpu_torch.utils.precision import strict_fp32
    from nerf_sampling_tpu_torch.utils.profiling import TRACE_FILE, read_trace

    t0 = time.perf_counter()
    shutil.rmtree(TAR_DIR, ignore_errors=True)
    os.makedirs(TAR_DIR)
    tree, step = ck.read_npz_tree(CKPT)
    sds = ck.params_from_jax(tree["params"])
    tar, nerf_tar = os.path.join(TAR_DIR, "example_depth.tar"), os.path.join(TAR_DIR, "nerf_only.tar")
    ck.export_torch_checkpoint(tar, step, sds["coarse"], sds["fine"], sds["depth"])
    ck.export_torch_checkpoint(nerf_tar, 0, sds["coarse"], sds["fine"])
    back = ck.import_torch_checkpoint(tar)
    n_tensors = sum(len(sd) for sd in sds.values())
    require(back["global_step"] == step and all(
        back[net].keys() == sd.keys() and all(back[net][k].dtype == v.dtype and torch.equal(back[net][k], v)
                                              for k, v in sd.items()) for net, sd in sds.items()),
            "the .tar did not read back to the checkpoint bit for bit")
    log(f"[tar] {os.path.basename(CKPT)} -> {tar} ({os.path.getsize(tar)} bytes) -> {n_tensors} tensors "
        f"back bit for bit, global_step {step}")

    # view 0 through the render CLI's loader (the Trainer), from the .tar and the .npz, on a
    # copy of the example scene with its test views and one train view
    datadir = os.path.join(TAR_DIR, "scene")
    generate_example_dataset(datadir, H=800, W=800, n_train=1, n_val=1, n_test=4)
    common = ["-dp", datadir, "-m", "recommended_depth_net_module", "--n_samples", "64", "--distance", "1.0",
              "--testskip", "1", "--device", torch.device(device).type]
    reset_launches("depth_net_kernel", "render_around_depth_kernel")
    tr_tar = rcli.main(common + ["--ft_path", tar, "--basedir", os.path.join(TAR_DIR, "render_tar")])
    torch.cuda.synchronize()
    counts = launched("depth_net_kernel", "render_around_depth_kernel")
    log(f"[tar] render CLI from the .tar over {len(tr_tar.scene.i_test)} test views: launches {counts}")
    for name, count in counts.items():
        require(count > 0, f"{name} was not launched by the .tar render")
    tr_npz = rcli.main(common + ["--ft_path", CKPT, "--basedir", os.path.join(TAR_DIR, "render_npz")])
    views = []
    for tr in (tr_tar, tr_npz):
        i0 = tr.scene.i_test[:1]
        rgbs, _, psnr = tr._render(tr.scene.poses[i0], gt_imgs=tr.scene.images[i0], verbose=False)
        views.append((rgbs[0], psnr))
    (img_tar, psnr_tar), (img_npz, psnr_npz) = views
    log(f"[tar] view 0 from the .tar {psnr_tar:.4f} dB, from the .npz {psnr_npz:.4f} dB, images bit-identical: "
        f"{np.array_equal(img_tar, img_npz)} (JAX fp32 reference {REFERENCE_PSNR_VIEW0} +- {PSNR_TOL})")
    require(np.array_equal(img_tar, img_npz), "the .tar render of view 0 differs from the .npz render")
    require(abs(psnr_tar - REFERENCE_PSNR_VIEW0) <= PSNR_TOL, "the .tar render's view 0 PSNR is off the reference")
    del tr_tar, tr_npz

    # the DepthNet trained from the NeRF-only .tar through run.py, the profiler on
    with open(REFERENCE_CONFIG) as fp:
        entry = yaml.safe_load(fp)["recommended_depth_net_module"]
    entry["kwargs"].update(i_weights=TAR_ITERS, i_testset=TAR_ITERS)  # the .tar export and the eval at the end
    cfg_path = os.path.join(TAR_DIR, "tar.yaml")
    with open(cfg_path, "w") as fp:
        yaml.safe_dump({"tar_module": entry}, fp)
    prof_dir = os.path.join(TAR_DIR, "profile")
    argv = ["-d", "example", "-c", cfg_path, "-m", "tar_module", "--mlp_impl", "cuda", "--ft_path", nerf_tar,
            "--n_iters", str(TAR_ITERS), "-ip", "20", "--seed", "42", "--basedir", os.path.join(TAR_DIR, "train"),
            "--testskip", "1", "--profile_dir", prof_dir, "--device", torch.device(device).type]
    log(f"[tar] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
    reset_launches("depth_net_kernel", "render_gaussian_kernel", "render_hier_kernel")
    t1 = time.perf_counter()
    trainer = run.main(argv)
    torch.cuda.synchronize()
    train_counts = launched("render_hier_kernel", "depth_net_kernel", "render_gaussian_kernel")
    log(f"[tar] {trainer.global_step} steps from the .tar in {time.perf_counter() - t1:.1f} s (the eval, the "
        f"profiled steps and the checkpoint included); launches {train_counts}")
    for name in ("render_hier_kernel", "depth_net_kernel"):
        require(train_counts[name] > 0, f"{name} was not launched by the training run from the .tar")
    counts["depth_net_kernel"] += train_counts.pop("depth_net_kernel")
    counts.update(train_counts)
    trace_path = os.path.join(prof_dir, TRACE_FILE)
    require(os.path.exists(trace_path), f"{trace_path} was not written")
    summary = read_trace(trace_path)
    k6_names = [n for n in summary["kernels"] if "render_hier_kernel" in n]
    require(summary["steps"] == 20 and k6_names, "the trace does not hold 20 steps with K6's kernel")
    log(f"[tar] trace {trace_path} ({os.path.getsize(trace_path)} bytes): {summary['steps']} steps in "
        f"{summary['window_ms']:.2f} ms ({summary['window_ms'] / summary['steps']:.3f} ms a step, the profiler's "
        f"Python tracing on), kernels {summary['kernel_ms']:.2f} ms, device idle {100 * summary['device_idle']:.1f}%")
    for name, ms in sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:5]:
        log(f"[tar] kernel {ms:9.3f} ms  {name[:100]}")
    for name, ms in summary["host"]:
        log(f"[tar] host self {ms:9.3f} ms  {name[:100]}")
    # the sampler's host time without the profiler: a fresh one replays the run's draws, whose
    # steps 21-40 visit images whose rays it has not cached yet; then the same steps warm
    cfg = trainer.cfg
    sampler = RaySampler(trainer.scene, SamplerConfig(N_rand=cfg.N_rand, use_batching=not cfg.no_batching,
                                                      precrop_iters=cfg.precrop_iters), seed=cfg.seed)
    per_step = {}
    for label in ("first visits", "warm"):
        times = []
        for i in range(1, 41):
            t2 = time.perf_counter()
            sampler.sample(i)
            times.append(time.perf_counter() - t2)
        per_step[label] = 1e3 * float(np.mean(times[20:]))
        sampler.rng = np.random.default_rng(cfg.seed)  # the same draws again, on a filled cache
    log(f"[tar] RaySampler.sample alone, host clock, no profiler: steps 21-40 of the run's draws "
        f"{per_step['first visits']:.3f} ms a step ({len(sampler._ray_cache)} of {len(trainer.scene.i_train)} "
        f"train views' rays cached by step 40), the same steps on the filled cache {per_step['warm']:.3f} ms")
    exported = os.path.join(trainer.expdir, f"{TAR_ITERS:06d}.tar")
    require(os.path.exists(exported), f"{exported} was not written")
    got = ck.import_torch_checkpoint(exported)
    raw = torch.load(exported, map_location="cpu", weights_only=False)
    live = {"coarse": trainer.params.coarse, "fine": trainer.params.fine, "depth": trainer.params.depth}
    same = all(torch.equal(got[net][k], v.detach().cpu()) for net, m in live.items()
               for k, v in m.state_dict().items())
    n_depth = len(got["depth"])
    require(got["global_step"] == TAR_ITERS and same
            and len(raw["sampling_optimizer_state_dict"]["state"]) == n_depth
            and raw["optimizer_state_dict"]["state"] == {},
            "the exported .tar does not hold the run's models and the DepthNet's Adam moments")
    log(f"[tar] {exported}: the run's NeRFs and DepthNet bit for bit, the DepthNet's Adam moments for its "
        f"{n_depth} tensors, the frozen NeRFs' optimizer fresh")
    del trainer

    # --precision: one plain nerf step at high against highest, same state, batch and draws
    pipe = dataclasses.replace(production_pipeline("plain"), depth=None)
    params = ck.load_render_params(CKPT, pipe, device)
    batch = train_batches(scene, device, 1)[0]
    g = torch.Generator(device="cpu").manual_seed(0)
    draws = StepDraws(torch.rand(1024, pipe.N_samples, generator=g).to(device),
                      torch.rand(1024, pipe.N_importance, generator=g).to(device))
    strict_fp32()
    losses = {}
    for prec in ("highest", "high"):
        state = init_nerf_state(nerf_modules(copy.deepcopy(params.coarse), copy.deepcopy(params.fine)).train()
                                .requires_grad_(True), 5e-4, 500)
        _, m = make_nerf_train_step(dataclasses.replace(pipe, matmul_precision=prec))(state, batch, 0, draws)
        losses[prec] = float(m["loss"])
        after = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
        require(after == ("highest", False), f"the matmul precision after the {prec} step is {after}")
    log(f"[tar] one plain nerf step: loss at --precision highest {losses['highest']:.9f}, high (TF32) "
        f"{losses['high']:.9f}, difference {losses['high'] - losses['highest']:+.3e}; torch's matmul "
        f"precision after each: highest, allow_tf32 False")
    log(f"[tar] phase {time.perf_counter() - t0:.1f} s; launches {counts}")
    return counts


def llff_pipeline_and_scene(device, impl: str):
    """The llff recipe (lego.yaml's llff_depth_net_module with run.py's
    overrides) on example_llff: its pipeline on ``impl`` with the scene's
    NDC geometry, and the scene."""
    import dataclasses

    from nerf_sampling_tpu_torch.data.llff import load_llff_scene
    from nerf_sampling_tpu_torch.definitions import DATASET_DIR, REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.utils.config import load_trainer_config

    cfg = load_trainer_config(REFERENCE_CONFIG, "llff_depth_net_module")
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius, cfg.depth_net_lr = 10, 256, 2, 1e-4
    cfg.datadir = os.path.join(DATASET_DIR, "example_llff")
    scene = load_llff_scene(cfg)  # writes near/far 0, 1 into cfg first, as the Trainer's order does
    H, W, focal = scene.hwf
    pipe = dataclasses.replace(cfg.pipeline(), mlp_impl=impl, H=H, W=W, focal=focal)
    return pipe, scene


def check_llff_steps(device, nerf_ckpt: str) -> None:
    """One NDC nerf step and one NDC depth step on both paths from one
    state, batch and draws (the NeRF of the kernel run, a DepthNet from
    seed 2): the nerf step at [step]'s gates (img_loss NSTEP_IMG_TOL, each
    net's gradient cosine NSTEP_COS_TOL), the depth step at STEP_*_TOL;
    then the median ms of a step of each on both paths."""
    import copy

    from nerf_sampling_tpu_torch.models import DepthNet
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params
    from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
    from nerf_sampling_tpu_torch.train.steps import (
        StepDraws,
        make_depth_net_train_step,
        make_nerf_train_step,
    )

    pipes = {}
    for impl in ("cuda", "plain"):
        pipes[impl], scene = llff_pipeline_and_scene(device, impl)
    base = load_render_params(nerf_ckpt, pipes["plain"], device)
    torch.manual_seed(2)
    depth0 = DepthNet(pipes["plain"].depth).to(device)
    batches = train_batches(scene, device, 12, seed=125)
    n = batches[0][0].shape[0]
    g = torch.Generator(device=device).manual_seed(11)
    draws = StepDraws(torch.rand((n, 64), generator=g, device=device), torch.rand((n, 128), generator=g, device=device))

    def nerf_state():
        return init_nerf_state(nerf_modules(copy.deepcopy(base.coarse), copy.deepcopy(base.fine)), 5e-4, 500)

    res = {}
    for impl, pipe in pipes.items():
        nst = nerf_state()
        _, m = make_nerf_train_step(pipe)(nst, batches[0], 0, draws)
        frozen = base._replace(depth=None, kernels=None)
        dst = init_state(copy.deepcopy(depth0), 1e-4)
        _, dm = make_depth_net_train_step(pipe, frozen)(dst, batches[0], 0, draws)
        grads = {net: torch.cat([q.grad.flatten() for name, q in nst.model.named_parameters()
                                 if name.startswith(net + ".")]) for net in ("coarse", "fine")}
        grads["depth"] = torch.cat([q.grad.flatten() for q in dst.model.parameters()])
        res[impl] = ({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in dm.items()}, grads)
        for model in (base.coarse, base.fine):  # the depth step froze them in place
            model.requires_grad_(True)
    (mk, dmk, gk), (mp, dmp, gp) = res["cuda"], res["plain"]
    rel = abs(mk["img_loss"] - mp["img_loss"]) / mp["img_loss"]
    log(f"[llff] NDC nerf step, cuda vs plain from one state, batch and draws: img_loss {mk['img_loss']:.6e} vs "
        f"{mp['img_loss']:.6e} (rel {rel:.2e}, tol {NSTEP_IMG_TOL:g})")
    require(rel <= NSTEP_IMG_TOL, "the NDC nerf steps' img_loss disagree")
    for net in ("coarse", "fine"):
        cos = float(torch.nn.functional.cosine_similarity(gk[net], gp[net], dim=0))
        log(f"[llff] NDC nerf step {net}: gradient cosine cuda vs plain {cos:.6f} (tol {NSTEP_COS_TOL})")
        require(cos >= NSTEP_COS_TOL, f"NDC nerf step, {net}: the kernel and plain gradients disagree")
    img_rel = abs(dmk["loss"] - dmp["loss"]) / abs(dmp["loss"])
    dep_rel = abs(dmk["depth_net_loss"] - dmp["depth_net_loss"]) / max(abs(dmp["depth_net_loss"]), 1e-12)
    cos = float(torch.nn.functional.cosine_similarity(gk["depth"], gp["depth"], dim=0))
    log(f"[llff] NDC depth step (the composable target pass: K4 queries, no K6), cuda vs plain: img_loss "
        f"{dmk['loss']:.6e} vs {dmp['loss']:.6e} (rel {img_rel:.2e}, tol {STEP_IMG_TOL:g}); depth_net_loss "
        f"{dmk['depth_net_loss']:.6e} vs {dmp['depth_net_loss']:.6e} (rel {dep_rel:.2e}, tol {STEP_DEPTH_TOL:g}); "
        f"DepthNet gradient cosine {cos:.6f} (tol {STEP_COS_TOL:g})")
    require(img_rel <= STEP_IMG_TOL and dep_rel <= STEP_DEPTH_TOL and cos >= STEP_COS_TOL,
            "the kernel and plain NDC depth steps disagree")
    times = {}
    for impl, reps in (("cuda", 10), ("plain", 3)):
        nst, nstep = nerf_state(), make_nerf_train_step(pipes[impl])
        it = iter(range(100))
        times[impl, "nerf"] = frame_ms(lambda: nstep(nst, batches[next(it) % 12], 1000), reps)
        dst = init_state(copy.deepcopy(depth0), 1e-4)
        dstep = make_depth_net_train_step(pipes[impl], base._replace(depth=None, kernels=None))
        it2 = iter(range(100))
        times[impl, "depth"] = frame_ms(lambda: dstep(dst, batches[next(it2) % 12], 1000), reps)
        for model in (base.coarse, base.fine):
            model.requires_grad_(True)
    log(f"[llff] median ms per NDC step (1024 rays, 64+128 samples): nerf {times['cuda', 'nerf']:.3f} on the "
        f"kernels, {times['plain', 'nerf']:.3f} plain fp32; depth {times['cuda', 'depth']:.3f} on the kernels, "
        f"{times['plain', 'depth']:.3f} plain fp32")


def run_llff(device) -> dict[str, int]:
    """[llff]: the forward-facing (NDC) path at the llff recipe's full width
    on the procedural example_llff scene (400x400, 24 views, llffhold 8),
    through the CLIs; returns the phase's launches by kernel."""
    import shutil

    from nerf_sampling_tpu_torch.data.example import maybe_generate_example_dataset
    from nerf_sampling_tpu_torch.definitions import DATASET_DIR
    from nerf_sampling_tpu_torch.experiments import render as rcli
    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.render import EvalMode, render_image

    def reset():
        reset_launches("depth_net_kernel", "nerf_points_kernel", "nerf_points_bwd_kernel", "render_hier_kernel",
                       "render_hier_kernel_det", "render_around_depth_kernel", "render_gaussian_kernel",
                       "render_linspace_kernel", "shade_kernel")

    def read():
        return launched("depth_net_kernel", "nerf_points_kernel", "nerf_points_bwd_kernel", "render_hier_kernel",
                        "render_hier_kernel_det", "render_around_depth_kernel", "render_gaussian_kernel")

    def require_only(counts: dict, want: set, what: str) -> None:
        launched = {name for name, c in counts.items() if c}
        log(f"[llff] {what}: launches {counts}")
        require(launched == want, f"{what} launched {sorted(launched)}, not {sorted(want)}")

    t0 = time.perf_counter()
    shutil.rmtree(LLFF_DIR, ignore_errors=True)
    datadir = os.path.join(DATASET_DIR, "example_llff")
    maybe_generate_example_dataset("example_llff", datadir)
    log(f"[llff] example_llff at {datadir} in {time.perf_counter() - t0:.1f} s")
    common = ["-d", "example_llff", "-m", "llff_depth_net_module", "--device", torch.device(device).type]
    total = dict.fromkeys(read(), 0)

    # --mode nerf from scratch on both paths: K4 and K5 in every step, K4 in the FULL_NERF eval; seed 1,
    # whose coarse NeRF starts with density (seed 0's has none, so no gradient, and check_llff_steps
    # compares each net's gradient on both paths)
    evals, nerf_ckpt = {}, None
    for impl in ("cuda", "plain"):
        argv = common + ["--mode", "nerf", "--mlp_impl", impl, "--seed", "1", "--n_iters", str(LLFF_NERF_ITERS),
                         "--i_testset",
                         str(LLFF_NERF_ITERS), "-ip", str(NERF_PRINT), "--basedir", os.path.join(LLFF_DIR, impl)]
        log(f"[llff] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
        reset()
        t1 = time.perf_counter()
        trainer = run.main(argv)
        torch.cuda.synchronize()
        counts = read()
        p = trainer.pipeline
        require(p.ndc and (p.near, p.far) == (0.0, 1.0) and (p.H, p.W, p.focal) == trainer.scene.hwf,
                "the llff run's pipeline is not the NDC one of its scene")
        losses = [(i, v) for i, v in nerf_losses(trainer.expdir) if i < trainer.cfg.precrop_iters]
        evals[impl] = trainer._avg_eval_psnr
        log(f"[llff] {impl}: {trainer.global_step} NDC nerf steps in {time.perf_counter() - t1:.1f} s (the eval "
            f"included); loss at step {losses[0][0]} {losses[0][1]:.6f}, at step {losses[-1][0]} "
            f"{losses[-1][1]:.6f}; FULL_NERF eval over {len(trainer.scene.i_test)} test views {evals[impl]:.4f} dB")
        require(losses[-1][1] < losses[0][1], f"the {impl} NDC nerf-mode loss did not fall")
        if impl == "cuda":
            require_only(counts, {"nerf_points_kernel", "nerf_points_bwd_kernel"}, "the NDC nerf-mode run")
            total = {k: total[k] + v for k, v in counts.items()}
            trainer.save_checkpoint(trainer.global_step)
            nerf_ckpt = os.path.join(trainer.expdir, f"{trainer.global_step:06d}.npz")
        del trainer
    log(f"[llff] NDC nerf eval: kernels {evals['cuda']:.4f} dB, plain {evals['plain']:.4f} dB, |delta| "
        f"{abs(evals['cuda'] - evals['plain']):.4f} (tol {NERF_EVAL_TOL})")
    require(abs(evals["cuda"] - evals["plain"]) <= NERF_EVAL_TOL, "the kernel and plain NDC nerf runs disagree")

    check_llff_steps(device, nerf_ckpt)

    # --mode depth_net from the kernel run's NeRF: K4 as the oracle's queries (K6 does not serve NDC), K1 at the eval
    argv = common + ["--mode", "depth_net", "--mlp_impl", "cuda", "--seed", "0", "--ft_path", nerf_ckpt, "--n_iters",
                     str(LLFF_DEPTH_ITERS), "--i_testset", str(LLFF_DEPTH_ITERS), "-ip", str(NERF_PRINT),
                     "--basedir", os.path.join(LLFF_DIR, "depth")]
    log(f"[llff] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
    reset()
    t1 = time.perf_counter()
    trainer = run.main(argv)
    torch.cuda.synchronize()
    counts = read()
    with open(os.path.join(trainer.expdir, "psnr.txt")) as fp:
        lines = [ln for ln in fp if ln.startswith("Iter:")]
    losses = [float(ln.split("Depth Net Loss: ")[1].split(",")[0]) for ln in lines]
    log(f"[llff] {trainer.global_step} NDC depth steps in {time.perf_counter() - t1:.1f} s; Depth Net Loss at step "
        f"{lines[0].split()[1]} {losses[0]:.6f}, at step {lines[-1].split()[1]} {losses[-1]:.6f}; DEPTH_NET eval "
        f"(gaussian/64/0.25) {trainer._avg_eval_psnr:.4f} dB")
    require(losses[-1] < losses[0], "the NDC depth-net loss did not fall")
    require_only(counts, {"nerf_points_kernel", "depth_net_kernel"}, "the NDC depth-net run")
    total = {k: total[k] + v for k, v in counts.items()}
    depth_ckpt = os.path.join(trainer.expdir, "best", f"depth_{LLFF_DEPTH_ITERS:06d}.npz")
    require(os.path.exists(depth_ckpt), f"{depth_ckpt} was not written")
    del trainer

    # the render CLI over the test views, gaussian/64/0.25, on the kernels and the plain path, one generator seed
    psnrs, trainers = {}, {}
    for impl in ("cuda", "plain"):
        argv = common + ["-rt", "--ft_path", nerf_ckpt, "--depth_net_path", depth_ckpt, "--n_samples", "64",
                         "--distance", "0.25", "--sampling_mode", "gaussian", "--mlp_impl", impl,
                         "--basedir", os.path.join(LLFF_DIR, f"render_{impl}")]
        log(f"[llff] python3 -m nerf_sampling_tpu_torch.experiments.render {' '.join(argv)}")
        reset()
        tr = rcli.main(argv)
        torch.cuda.synchronize()
        counts = read()
        trainers[impl] = tr
        with open(os.path.join(tr.expdir, f"renderonly_test_{tr.global_step:06d}", "psnr.txt")) as fp:
            psnrs[impl] = float(fp.read().split("Avg of")[1].split("PSNR: ")[1].split()[0])
        if impl == "cuda":
            require_only(counts, {"nerf_points_kernel", "depth_net_kernel"}, "the NDC render CLI")
            total = {k: total[k] + v for k, v in counts.items()}
    log(f"[llff] render CLI over {len(trainers['cuda'].scene.i_test)} test views: kernels {psnrs['cuda']:.4f} dB, "
        f"plain fp32 {psnrs['plain']:.4f} dB, |delta| {abs(psnrs['cuda'] - psnrs['plain']):.4f} "
        f"(tol {FULL_PSNR_TOL})")
    require(abs(psnrs["cuda"] - psnrs["plain"]) <= FULL_PSNR_TOL, "the kernel and plain NDC renders disagree")

    # one test view's NDC frame on both paths: DEPTH_NET (K1, K4 on 64 samples) and FULL_NERF (K4 on 64 + 192)
    tr = trainers["cuda"]
    scene = tr.scene
    H, W, _ = scene.hwf
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    params = tr.eval_params
    for mode, reps in ((EvalMode.DEPTH_NET, (7, 3)), (EvalMode.FULL_NERF, (3, 2))):
        ms = {}
        for impl, n in zip(("cuda", "plain"), reps):
            pipe = trainers[impl].pipeline

            def frame(pipe=pipe):
                return render_image(pipe, params, H, W, scene.intrinsics(), c2w, device=device, mode=mode,
                                    chunk=tr.cfg.chunk, generator=torch.Generator(device=device).manual_seed(0))

            ms[impl] = frame_ms(frame, n)
        log(f"[llff] median per {H}x{W} NDC frame, {mode.name}: kernels (the composable route) {ms['cuda']:.2f} ms "
            f"({H * W / ms['cuda'] * 1e3:.0f} rays/s), plain fp32 {ms['plain']:.2f} ms")
    pipe = trainers["cuda"].pipeline
    profile_frame(lambda: render_image(pipe, params, H, W, scene.intrinsics(), c2w, device=device,
                                       chunk=tr.cfg.chunk, generator=torch.Generator(device=device).manual_seed(0)),
                  "one NDC DEPTH_NET frame on the kernels")
    del trainers, tr, params
    log(f"[llff] phase {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def run_formats(device) -> dict[str, int]:
    """[formats]: example_linemod (per-frame K) and example_deepvoxels
    through run.py on the kernels, FORMATS_ITERS depth-net steps against a
    NeRF from seed and one eval: K6 (the oracle), K1 and K3 (the gaussian
    eval) must launch. Returns the phase's launches by kernel."""
    import shutil

    from nerf_sampling_tpu_torch.experiments import run

    t0 = time.perf_counter()
    shutil.rmtree(FORMATS_DIR, ignore_errors=True)
    total: dict[str, int] = {}
    for name, model in (("example_linemod", "linemod_depth_net_module"),
                        ("example_deepvoxels", "deepvoxels_depth_net_module")):
        argv = ["-d", name, "-m", model, "--mlp_impl", "cuda", "--n_iters", str(FORMATS_ITERS), "--i_testset",
                str(FORMATS_ITERS), "-ip", "5", "--seed", "42", "--basedir", FORMATS_DIR, "--device",
                torch.device(device).type]
        if name == "example_linemod":  # two evals of its one test view for the [memory] check
            argv[argv.index("--i_testset") + 1] = str(FORMATS_ITERS // 2)
        log(f"[formats] python3 -m nerf_sampling_tpu_torch.experiments.run {' '.join(argv)}")
        reset_launches("depth_net_kernel", "render_gaussian_kernel", "render_hier_kernel")
        t1 = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats(device)
        trainer = run.main(argv)
        torch.cuda.synchronize()
        if name == "example_linemod":
            check_eval_memory(trainer.expdir)
        counts = launched("render_hier_kernel", "depth_net_kernel", "render_gaussian_kernel")
        scene = trainer.scene
        log(f"[formats] {name}: {trainer.global_step} steps and the eval in {time.perf_counter() - t1:.1f} s, "
            f"hwf {tuple(round(float(v), 3) for v in scene.hwf)}, near/far {trainer.pipeline.near}/"
            f"{trainer.pipeline.far}, K from the frames: {scene.K is not None}; DEPTH_NET eval over "
            f"{len(scene.i_test)} test views {trainer._avg_eval_psnr:.4f} dB; launches {counts}")
        require(all(c > 0 for c in counts.values()), f"{name}: K6, K1 and K3 must all launch")
        require(np.isfinite(trainer._avg_eval_psnr) and trainer._avg_eval_psnr > 0, f"{name}: no finite eval")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del trainer
    log(f"[formats] phase {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def check_eval_memory(expdir: str) -> None:
    """[memory]: the run's peak device memory at its second eval against its
    first (the Trainer's eval lines in metrics.jsonl), within
    MEMORY_GROWTH_MIB: an eval must leave nothing on the card that the
    next one adds to."""
    with open(os.path.join(expdir, "metrics.jsonl")) as fp:
        evals = [r for r in map(json.loads, fp) if "max_memory_allocated_mib" in r]
    require(len(evals) >= 2, f"[memory] two evals expected, the run logged {len(evals)}")
    first, second = evals[0], evals[1]
    log(f"[memory] peak allocated at the eval of step {first['step']}: {first['max_memory_allocated_mib']:.2f} "
        f"MiB, of step {second['step']}: {second['max_memory_allocated_mib']:.2f} MiB; live after them "
        f"{first['memory_allocated_mib']:.2f} and {second['memory_allocated_mib']:.2f} MiB")
    require(second["max_memory_allocated_mib"] - first["max_memory_allocated_mib"] <= MEMORY_GROWTH_MIB,
            f"[memory] the second eval's peak exceeds the first's by more than {MEMORY_GROWTH_MIB} MiB")


DISPATCH_DIR = os.path.join(HERE, "logs", "chip_smoke_dispatch")  # [dispatch]'s Trainer runs (gitignored)
DISPATCH_SEEDS = (1, 2**31 - 5, 123_456_789)  # (a): K6 by value and by pointer
DISPATCH_SEED_TIME_TOL = 0.01  # (a): K6 by pointer within 1% of K6 by value, timed in turns
# (b)-(d): (chunk size K, chunks) of each step, captured against as many eager steps
DISPATCH_CHUNKS = {"depth": (25, 2), "depth_int8": (25, 2), "nerf": (10, 2), "joint": (10, 3)}
DISPATCH_WARMUP = 15  # (d): the joint step's joint_depth_warmup, inside the second chunk
DISPATCH_ITERS = 200  # (f): Trainer steps through run.main, auto against steps_per_dispatch 1
ADAM_MOVE_TOL = 1e-5  # (e): the moves' difference, in lr, beside rtol 1e-6 (check_capturable_adam)
DISPATCH_TURNS = 3  # the timing: chunks of each loop, in turns (eager, captured, captured, eager, ...)
MESH_DIR = os.path.join(HERE, "logs", "chip_smoke_mesh")  # (g)'s rendezvous, (h)'s runs (gitignored)


def dispatch_case(kind: str, params, pipes: dict, seed: int = 42, mesh=None):
    """A fresh train state from the committed checkpoint and the step of
    ``kind`` (depth, depth_int8, nerf, joint) as ``step(batch, seed) ->
    metrics``: (step, states, graph_key). With ``mesh`` the step is the
    sharded one of the rank's rows (parallel/ops.py), its all-reduces inside."""
    import copy
    import dataclasses
    import functools

    from nerf_sampling_tpu_torch.render import pack_kernel_weights
    from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
    from nerf_sampling_tpu_torch.train.steps import (
        make_depth_net_train_step,
        make_joint_train_step,
        make_nerf_train_step,
    )

    if mesh is not None:
        from nerf_sampling_tpu_torch.parallel import ops

        make_depth_net_train_step = functools.partial(ops.make_sharded_depth_train_step, mesh=mesh)
        make_nerf_train_step = functools.partial(ops.make_sharded_nerf_train_step, mesh=mesh)
        make_joint_train_step = functools.partial(ops.make_sharded_joint_train_step, mesh=mesh)
    if kind.startswith("depth"):
        pipe = pipes["cuda_int8" if kind == "depth_int8" else "cuda"]
        frozen = params if kind == "depth" else pack_kernel_weights(params, with_hier=True,
                                                                    quant_pair=pipe.quant_calib)
        state = init_state(copy.deepcopy(params.depth), 1e-4)
        step = make_depth_net_train_step(pipe, frozen._replace(depth=None))
        return (lambda batch, s: step(state, batch, s)[1]), [state], lambda: None
    coarse, fine = (copy.deepcopy(m).requires_grad_(True) for m in (params.coarse, params.fine))
    nerf = init_nerf_state(nerf_modules(coarse, fine), 5e-4, 250)
    if kind == "nerf":
        step = make_nerf_train_step(pipes["cuda"])
        return (lambda batch, s: step(nerf, batch, s)[1]), [nerf], lambda: None
    depth = init_state(copy.deepcopy(params.depth), 1e-4)
    pipe = dataclasses.replace(pipes["cuda"], joint_depth_warmup=DISPATCH_WARMUP, bg_depth_loss_weight=0.5)
    step = make_joint_train_step(pipe)
    return (lambda batch, s: step(nerf, depth, batch, s)[2]), [nerf, depth], lambda: nerf.step >= DISPATCH_WARMUP


def state_tensors(states) -> list[torch.Tensor]:
    """Every parameter and Adam moment and count of ``states``, in order."""
    out = []
    for st in states:
        for p in st.model.parameters():
            out.append(p.detach())
            out += [v for _, v in sorted(st.optimizer.state.get(p, {}).items())]
    return out


def eager_chunk(step, stack: np.ndarray, seeds, device) -> np.ndarray:
    """``step`` run once per row of ``stack`` with the int seeds (the
    per-step loop); the metrics [K, M] on the host."""
    rows = torch.from_numpy(stack).to(device)
    out = []
    for j, s in enumerate(seeds):
        batch = tuple(rows[j, :, c:c + 3].contiguous() for c in (0, 3, 6))
        m = step(batch, s)
        out.append(torch.stack([v.reshape(()).float() for v in m.values()]))
    return torch.stack(out).cpu().numpy()


def check_dispatch_steps(kind: str, params, pipes: dict, sampler, device, mesh=None) -> dict:
    """(b)-(d) for one step, and (g) with ``mesh``, the sharded step of the
    rank's rows: DISPATCH_CHUNKS[kind] chunks captured and replayed
    (train/dispatch.py) against as many eager steps, from one state, sampler
    stream and seeds: every step's metrics, the final parameters and Adam
    state bit for bit; then the median ms a step of both loops in turns,
    and one captured chunk profiled (with ``mesh``, its NCCL kernels a
    step). Returns the times, the eager metrics, the launches counted in the
    captured run and the NCCL kernels a step."""
    from nerf_sampling_tpu_torch.parallel import shard_ray_batch
    from nerf_sampling_tpu_torch.train.dispatch import StepDispatcher
    from nerf_sampling_tpu_torch.train.trainer import step_seed

    k, n_chunks = DISPATCH_CHUNKS[kind]
    tag = f"[dispatch] ({kind})" if mesh is None else f"[dispatch] (g) ({kind}, {mesh.world} {mesh.backend} rank)"
    t0 = time.perf_counter()

    def stack_of(i0: int) -> tuple[np.ndarray, list[int]]:
        rows = [sampler.sample(i) for i in range(i0, i0 + k)]
        if mesh is not None:
            rows = [shard_ray_batch(mesh, b) for b in rows]
        return np.stack([np.concatenate(b, -1) for b in rows]), [step_seed(42, i) for i in range(i0, i0 + k)]

    chunks = [stack_of(1 + c * k) for c in range(n_chunks)]
    eager_step, eager_states, _ = dispatch_case(kind, params, pipes, mesh=mesh)
    want = np.concatenate([eager_chunk(eager_step, st, sd, device) for st, sd in chunks])
    cap_step, cap_states, key = dispatch_case(kind, params, pipes, mesh=mesh)
    disp = StepDispatcher(cap_step, cap_states, device, graph_key=key)
    before = build.launches.copy()
    got, held = [], True
    for st, sd in chunks:
        got.append(disp.run(st, sd).cpu().numpy())
        if kind == "joint" and cap_states[0].step <= DISPATCH_WARMUP:  # the DepthNet held through the warmup
            held &= all(torch.equal(a, b) for a, b in zip(cap_states[1].model.parameters(), params.depth.parameters()))
    got = np.concatenate(got)
    counted = {name: build.launches[key] - before[key] for name, key in LAUNCH_KEYS.items()
               if build.launches[key] != before[key]}
    same_metrics = got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    a, b = state_tensors(eager_states), state_tensors(cap_states)
    same_state = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    n_steps = k * n_chunks
    log(f"{tag} {n_chunks} captured chunks of {k} steps against {n_steps} eager steps: metrics "
        f"{disp.names} bit for bit {same_metrics}, parameters and Adam state ({len(a)} tensors) bit for bit "
        f"{same_state}; graphs captured {len(disp._graphs)}; launches counted in the captured run {counted}")
    if not same_metrics:
        rows = np.nonzero(np.any(got != want, 1))[0] if got.shape == want.shape else []
        log(f"{tag} first differing steps {list(rows[:5])}: captured {got[rows[:1]]}, eager "
            f"{want[rows[:1]]}")
    require(same_metrics and same_state, f"{tag} the captured steps differ from the eager ones")
    per_step_launches = {"depth": "render_hier_kernel", "depth_int8": "render_hier_kernel_int8"}
    if kind in per_step_launches:
        require(counted.get(per_step_launches[kind]) == n_steps,
                f"{tag} K6 counted {counted} over {n_steps} captured steps")
    else:
        require(counted.get("nerf_points_kernel", 0) > 0 and counted.get("nerf_points_bwd_kernel", 0) > 0,
                f"{tag} K4/K5 not counted over the captured steps: {counted}")
    if kind == "joint":
        live = got[:, disp.names.index("depth_live")]
        require(np.array_equal(live, (np.arange(1, n_steps + 1) > DISPATCH_WARMUP).astype(np.float32)),
                f"{tag} depth_live {live} does not turn on after step {DISPATCH_WARMUP}")
        log(f"{tag} depth_live 0 through step {DISPATCH_WARMUP}, then 1; the DepthNet bit for bit "
            f"unchanged at the chunk ends of the warmup {held}")
        require(held, f"{tag} the DepthNet moved during the warmup")

    # the two loops' time a step, chunk by chunk in turns, from where the runs stopped
    times = {"eager": [], "captured": []}
    for turn in range(DISPATCH_TURNS):
        stack, seeds = stack_of(1 + (n_chunks + turn) * k)
        order = ("eager", "captured") if turn % 2 == 0 else ("captured", "eager")
        for loop in order:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if loop == "eager":
                eager_chunk(eager_step, stack, seeds, device)
            else:
                disp.read(disp.run(stack, seeds))
            times[loop].append((time.perf_counter() - t1) * 1e3 / k)
    eager_ms, cap_ms = (float(np.median(times[n])) for n in ("eager", "captured"))
    log(f"{tag} median ms a step, chunks of {k} with one sync each, in turns: per-step loop "
        f"{eager_ms:.3f} ms, captured chunks {cap_ms:.3f} ms ({eager_ms / cap_ms:.2f}x)")
    stack, seeds = stack_of(1 + (n_chunks + DISPATCH_TURNS) * k)
    wall, rows = profile_frame(lambda: disp.read(disp.run(stack, seeds)), f"one captured chunk of {k} {kind} steps"
                               + ("" if mesh is None else f" on {mesh.world} {mesh.backend} rank"), top=6)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    nccl = {e.key[:60]: e.count / k for e in rows if "nccl" in e.key.lower()}
    if mesh is not None:
        log(f"{tag} NCCL kernels a step in the profiled captured chunk: "
            + (", ".join(f"{n} x{c:g}" for n, c in nccl.items()) or "none"))
    log(f"{tag} phase {time.perf_counter() - t0:.1f} s")
    return {"eager_ms": eager_ms, "captured_ms": cap_ms, "idle": 1 - busy / wall, "metrics": want,
            "launched": counted, "nccl": nccl}


def check_k6_seed_word(params, pipes: dict, batches, device) -> dict[str, dict[str, float]]:
    """(a): K6 with its seed in device memory, in bf16 and int8, on 1024-ray
    train batches: DISPATCH_SEEDS by pointer bit for bit equal to the same
    seeds by value; a CUDA graph holding one K6 launch, replayed after each
    rewrite of its seed word, equal to direct launches with those seeds;
    the two launches timed in turns (value, pointer, pointer, value) within
    DISPATCH_SEED_TIME_TOL. Returns the times by kernel record name."""
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6
    from nerf_sampling_tpu_torch.render import pack_kernel_weights

    cfg_c, cfg_f = params.coarse.cfg, params.fine.cfg
    q = pack_kernel_weights(params, with_hier=True, quant_pair=pipes["cuda_int8"].quant_calib).kernels
    out = {}
    for name, packed in (("render_hier_kernel", params.kernels.hier), ("render_hier_kernel_int8", q.hier)):
        ro, rd = batches[0]

        def launch(seed, ro=ro, rd=rd, packed=packed):
            return k6.render_hier_kernel(packed, cfg_c, cfg_f, ro, rd, n_coarse=64, n_importance=128, seed=seed)

        word = torch.zeros((), dtype=torch.int32, device=device)
        same = []
        for s in DISPATCH_SEEDS:
            word.fill_(s)
            same.append(same_bits(launch(s), launch(word)))
        other = not torch.equal(launch(DISPATCH_SEEDS[0])["max_z"], launch(DISPATCH_SEEDS[1])["max_z"])
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            launch(word)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = launch(word)
        replayed = []
        for s in DISPATCH_SEEDS:
            word.fill_(s)
            graph.replay()
            replayed.append(same_bits({k: v.clone() for k, v in captured.items()}, launch(s)))
        word.fill_(DISPATCH_SEEDS[2])
        t = {"value": [], "pointer": []}
        for mode in ("value", "pointer", "pointer", "value"):
            t[mode].append(cuda_ms(lambda mode=mode: launch(DISPATCH_SEEDS[2] if mode == "value" else word), 200))
        val, ptr = (float(np.mean(t[m])) for m in ("value", "pointer"))
        log(f"[dispatch] (a) {name}: seeds {DISPATCH_SEEDS} by pointer equal by value bit for bit {same}, "
            f"another seed other draws {other}; one captured K6 launch replayed after each rewrite of its seed "
            f"word equals direct launches {replayed}; ms by value {val:.4f}, by pointer {ptr:.4f} "
            f"({100 * (ptr / val - 1):+.2f}%, tol {100 * DISPATCH_SEED_TIME_TOL:g}%), in turns, 200 launches each")
        require(all(same) and other and all(replayed), f"[dispatch] {name}: K6's seed word disagrees")
        require(abs(ptr / val - 1) <= DISPATCH_SEED_TIME_TOL, f"[dispatch] {name}: by pointer off by value's time")
        out[name] = {"seed_value_ms": val, "seed_ptr_ms": ptr}
    return out


def optax_adam_np(p: np.ndarray, g: np.ndarray, mu: np.ndarray, nu: np.ndarray, count: int, lr: float,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax.adam's update of one fp32 array, in numpy fp32 (no JAX):
    scale_by_adam (the moments as (1 - b) * g^k + b * m, the bias
    corrections 1 - b**count in fp32, as
    optax.tree_utils.tree_bias_correction forms them from its int32 count),
    then scale_by_learning_rate (-lr * u) and apply_updates (p + u).
    ``count`` is the update's own (1 for the first). Returns (p, mu, nu)."""
    f = np.float32
    mu = f(1 - b1) * g + f(b1) * mu
    nu = f(1 - b2) * (g * g) + f(b2) * nu
    c = f(count)
    u = (mu / (f(1) - f(b1) ** c)) / (np.sqrt(nu / (f(1) - f(b2) ** c)) + f(eps))
    return p + f(-lr) * u, mu, nu


def check_capturable_adam(params, pipes: dict, sampler, device) -> None:
    """(e): one depth step's update by the capturable Adam (the port's on
    the card) against torch's default Adam from one state and gradient:
    each parameter within rtol 1e-6 plus ADAM_MOVE_TOL lr. The capturable
    rule forms its bias corrections on the device in fp32 (1 - 0.999f is
    1.3e-5 above 1 - 0.999, its square root 6.4e-6), the default one on the
    host in double, so every move differs by up to about 6.4e-6 of itself
    (at most lr), more than 1e-6 of a parameter near zero. The largest
    difference after 50 steps of each on the same batches and seeds is
    printed. C1: at each of the 50 steps, both rules and optax.adam's
    (``optax_adam_np``) make one update from one shared state (optax's
    parameters, moments and count) with that step's gradient; which rule
    is closer to optax's is printed, and the capturable one must stay within
    rtol 1e-6 plus ADAM_MOVE_TOL lr of it."""
    import copy

    from nerf_sampling_tpu_torch.train.state import TrainState, init_state
    from nerf_sampling_tpu_torch.train.steps import make_depth_net_train_step
    from nerf_sampling_tpu_torch.train.trainer import step_seed

    step = make_depth_net_train_step(pipes["cuda"], params._replace(depth=None))
    lr = 1e-4
    states = {True: init_state(copy.deepcopy(params.depth), lr)}  # the port's Adam on the card
    model = copy.deepcopy(params.depth)
    states[False] = TrainState(0, model, torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8))
    require(all(g["capturable"] for g in states[True].optimizer.param_groups)
            and not any(g["capturable"] for g in states[False].optimizer.param_groups), "capturable flags")
    diffs = []
    start = [p.detach().clone() for p in params.depth.parameters()]
    # C1: the shared state (optax's) and each torch rule's own parameters
    ref = [(p.cpu().numpy(), np.zeros(p.shape, np.float32), np.zeros(p.shape, np.float32)) for p in start]
    leaves = {c: [torch.nn.Parameter(p.clone()) for p in start] for c in (True, False)}
    rules = {True: torch.optim.Adam(leaves[True], lr=torch.full((), lr, device=device), betas=(0.9, 0.999),
                                    eps=1e-8, capturable=True),
             False: torch.optim.Adam(leaves[False], lr=lr, betas=(0.9, 0.999), eps=1e-8)}
    off = {c: {"max": 0.0, "first": 0.0, "unequal": 0, "outside": 0} for c in (True, False)}
    n_params = sum(p.numel() for p in start)
    for i in range(1, 51):
        batch = tuple(torch.from_numpy(x).to(device) for x in sampler.sample(i))
        for st in states.values():
            step(st, batch, step_seed(42, i))
        a, b = ([p.detach() for p in states[c].model.parameters()] for c in (True, False))
        diffs.append(max(float((x - y).abs().max()) for x, y in zip(a, b)))
        if i == 1:
            close = all(torch.all((x - y).abs() <= 1e-6 * y.abs() + ADAM_MOVE_TOL * lr) for x, y in zip(a, b))
            n_out = sum(int(((x - y).abs() > 1e-6 * y.abs()).sum()) for x, y in zip(a, b))
            moves = max(float(((x - p0) - (y - p0)).abs().max()) for x, y, p0 in zip(a, b, start)) / lr
            log(f"[dispatch] (e) one update, capturable Adam against torch's default Adam from one state and "
                f"gradient: every parameter within rtol 1e-6 plus {ADAM_MOVE_TOL:g} lr {close}; "
                f"{n_out} of {sum(x.numel() for x in a)} outside rtol 1e-6 alone; the moves differ by up to "
                f"{moves:.3e} lr")
            require(close, "[dispatch] the capturable Adam's update is off the default Adam's")
        grads = [p.grad.detach() for p in states[True].model.parameters()]
        for c, opt in rules.items():
            for q, (p0, m0, v0), g in zip(leaves[c], ref, grads):
                with torch.no_grad():
                    q.copy_(torch.from_numpy(p0))
                q.grad = g.clone()
                st = opt.state.get(q)
                if st:  # after the first update: optax's moments and count
                    st["exp_avg"].copy_(torch.from_numpy(m0))
                    st["exp_avg_sq"].copy_(torch.from_numpy(v0))
                    st["step"].fill_(i - 1)
            opt.step()
        ref = [optax_adam_np(p0, g.cpu().numpy(), m0, v0, i, lr) for (p0, m0, v0), g in zip(ref, grads)]
        for c in rules:
            worst, unequal, outside = 0.0, 0, 0
            for q, (p1, _, _) in zip(leaves[c], ref):
                got = q.detach().cpu().numpy()
                d = np.abs(got - p1)
                worst = max(worst, float(d.max()) / lr)
                unequal += int((got != p1).sum())
                outside += int((d > 1e-6 * np.abs(p1) + ADAM_MOVE_TOL * lr).sum())
            o = off[c]
            o["max"], o["unequal"], o["outside"] = max(o["max"], worst), o["unequal"] + unequal, o["outside"] + outside
            if i == 1:
                o["first"], o["first_unequal"] = worst, unequal
    log(f"[dispatch] (e) after 50 steps of each on the same batches and seeds: largest parameter difference "
        f"{diffs[-1]:.3e} (after 10: {diffs[9]:.3e})")
    names = {True: "capturable Adam (the card's)", False: "torch's default Adam (the CPU's)"}
    for c, o in off.items():
        log(f"[dispatch] (e) C1 {names[c]} against optax.adam's rule in numpy fp32, one update from optax's state "
            f"and each of 50 steps' gradients: update 1 {o['first_unequal']} of {n_params} parameters not bit for "
            f"bit, up to {o['first']:.3e} lr apart; over the 50 updates {o['unequal']} of {50 * n_params} not bit "
            f"for bit, up to {o['max']:.3e} lr apart, {o['outside']} outside rtol 1e-6 plus {ADAM_MOVE_TOL:g} lr")
    closer = min(off, key=lambda c: (off[c]["unequal"], off[c]["max"]))
    log(f"[dispatch] (e) C1: the {names[closer]} is the closer to optax's rule: "
        f"{off[not closer]['unequal']} against {off[closer]['unequal']} parameters off its bits over the 50 updates, "
        f"at most {off[not closer]['max']:.3e} against {off[closer]['max']:.3e} lr apart")
    require(off[True]["outside"] == 0, "[dispatch] (e) C1: the capturable Adam's update is off optax's rule")


def run_outputs(expdir: str) -> tuple[str, dict]:
    """An experiment's psnr.txt and every array of its checkpoints, by (file, key)."""
    with open(os.path.join(expdir, "psnr.txt")) as fp:
        text = fp.read()
    arrays = {}
    for root, _, files in os.walk(expdir):
        for f in files:
            if f.endswith(".npz"):
                with np.load(os.path.join(root, f)) as z:
                    arrays.update({(os.path.relpath(os.path.join(root, f), expdir), key): z[key] for key in z.files})
    return text, arrays


def run_dispatch_trainer(device) -> int:
    """(f): the depth-net recipe through run.main for DISPATCH_ITERS steps with
    --steps_per_dispatch 0 (auto: captured chunks) and 1, evals at every
    100: psnr.txt identical, every checkpoint array bit for bit (the keep_best
    ones and one written after each run), K6 launches equal to the steps in
    both, the chunk and the graphs each run used read from its Trainer.
    Returns the auto run's K6 launches."""
    import shutil

    from nerf_sampling_tpu_torch.experiments import run

    shutil.rmtree(DISPATCH_DIR, ignore_errors=True)
    os.makedirs(DISPATCH_DIR)
    ft_path = os.path.join(DISPATCH_DIR, "nerf_only.npz")
    write_nerf_only_checkpoint(ft_path)
    runs = {}
    for k in ("0", "1"):
        argv = ["-d", "example", "-m", "recommended_depth_net_module", "--mlp_impl", "cuda", "--ft_path", ft_path,
                "--n_iters", str(DISPATCH_ITERS), "-ip", "100", "--i_testset", "100", "--seed", "42",
                "--basedir", os.path.join(DISPATCH_DIR, f"k{k}"), "--testskip", "1", "--steps_per_dispatch", k]
        reset_launches("render_hier_kernel")
        t1 = time.perf_counter()
        trainer = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        trainer.save_checkpoint(trainer.global_step, subdir="final")
        chunk = (trainer.steps_per_dispatch, trainer.captured_graphs)
        text, arrays = run_outputs(trainer.expdir)
        runs[k] = (text, arrays, n_launches("render_hier_kernel"), chunk)
        log(f"[dispatch] (f) --steps_per_dispatch {k} (resolved {chunk[0]}, {chunk[1]} graphs captured): "
            f"{trainer.global_step} steps in {wall:.1f} s "
            f"(evals and checkpoints included), K6 launches {n_launches('render_hier_kernel')}, "
            f"eval {trainer._avg_eval_psnr:.4f} dB, "
            f"{len({n for n, _ in arrays})} checkpoints")
        del trainer
    (t0, a0, n0, c0), (t1, a1, n1, c1) = runs["0"], runs["1"]
    same = sorted(a0) == sorted(a1) and all(np.array_equal(a0[key], a1[key]) for key in a0)
    log(f"[dispatch] (f) psnr.txt identical {t0 == t1}; checkpoint arrays ({len(a0)}) bit for bit {same}")
    require(c0[0] > 1 and c0[1] >= 1 and c1 == (1, 0), f"[dispatch] (f) (chunk, graphs) {c0} and {c1}")
    require(t0 == t1 and same, "[dispatch] (f) the captured Trainer run differs from the per-step one")
    require(n0 == n1 == DISPATCH_ITERS, f"[dispatch] (f) K6 launches {n0} and {n1}, not {DISPATCH_ITERS}")
    return n0


def check_blocking_wait_capture(device) -> None:
    """(g): an all-reduce on a group formed under TORCH_NCCL_BLOCKING_WAIT=1
    (which makes a wait block the host) is captured in a CUDA graph and
    replayed to the right values. The resolver has no rule for that
    setting, so a torch or NCCL that refuses this capture, or replays it
    wrongly, fails here."""
    import torch.distributed as dist

    os.environ["TORCH_NCCL_BLOCKING_WAIT"] = "1"
    try:
        group = dist.new_group(backend="nccl")
    finally:
        del os.environ["TORCH_NCCL_BLOCKING_WAIT"]
    x = torch.ones(1024, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        dist.all_reduce(x, group=group)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            y = x * 2
            dist.all_reduce(y, group=group)
            z = y + 1
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as err:
        raise AssertionError("(g) an all-reduce on a group formed under TORCH_NCCL_BLOCKING_WAIT=1 could not be "
                             "captured and replayed: resolve_steps_per_dispatch needs a rule for that setting") from err
    right = bool((z == 3).all())
    dist.destroy_process_group(group)
    log(f"[dispatch] (g) an all-reduce on a group formed under TORCH_NCCL_BLOCKING_WAIT=1: captured, replayed to the "
        f"right values {right}")
    require(right, "(g) a captured all-reduce under TORCH_NCCL_BLOCKING_WAIT=1 replays to wrong values")


def mesh_rank(rank: int, world: int, params, pipes: dict, scene, device, one_rank: dict) -> dict:
    """(g) in this process, rank 0 of a one-rank nccl group: the sharded
    steps (make_sharded_*_train_step, their gradient and metric all-reduces
    inside each captured graph) in captured chunks against the per-step
    sharded loop, as (b)-(d); their eager metrics bit for bit those of the
    one-rank steps of (b)-(d) (at world 1 the collectives are the identity).
    Returns check_dispatch_steps' records by step."""
    from nerf_sampling_tpu_torch.parallel import make_mesh
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig

    mesh = make_mesh(world)
    require(mesh.world == 1 and mesh.backend == "nccl", f"(g) a mesh of {mesh.world} {mesh.backend} ranks")
    out = {}
    check_blocking_wait_capture(device)
    for kind in DISPATCH_CHUNKS:
        sampler = RaySampler(scene, SamplerConfig(N_rand=1024), seed=42)
        out[kind] = check_dispatch_steps(kind, params, pipes, sampler, device, mesh=mesh)
        want = one_rank[kind]["metrics"]
        same = np.array_equal(out[kind]["metrics"].view(np.uint32), want.view(np.uint32))
        log(f"[dispatch] (g) ({kind}) the sharded per-step loop on 1 nccl rank equals the one-rank steps of (b)-(d) "
            f"bit for bit: {same}")
        require(same, f"(g) the sharded {kind} steps on 1 nccl rank differ from the one-rank steps")
    torch.cuda.synchronize()
    return out


# (h): run.py's main in a subprocess, one rank of a launcher's nccl group (--multihost)
MESH_CLI = """
import json, sys
from nerf_sampling_tpu_torch.experiments import run
from nerf_sampling_tpu_torch.kernels import build
trainer = run.main(sys.argv[1:])
trainer.save_checkpoint(trainer.global_step, subdir="final")
print("MESH_CLI " + json.dumps({
    "launches": build.launches["K6", "bf16"], "steps": trainer.global_step, "world": trainer.mesh.world,
    "backend": trainer.mesh.backend, "eval": trainer._avg_eval_psnr, "expdir": trainer.expdir,
    "chunk": trainer.steps_per_dispatch, "graphs": trainer.captured_graphs}))
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_mesh_cli() -> int:
    """(h): the depth-net recipe through run.py's main with --multihost, as
    rank 0 of a one-rank nccl group that the launcher's five variables
    describe, for DISPATCH_ITERS steps with --steps_per_dispatch 0 (auto)
    and 1, each in its own process: auto resolves above 1, psnr.txt
    identical, every checkpoint array bit for bit, K6 launches equal to the
    steps in both; the chunk and the graphs each run used are read from its
    Trainer. Returns the auto run's K6 launches."""
    ft_path = os.path.join(MESH_DIR, "nerf_only.npz")
    write_nerf_only_checkpoint(ft_path)
    runs = {}
    for k in ("0", "1"):
        argv = ["-d", "example", "-m", "recommended_depth_net_module", "--mlp_impl", "cuda", "--ft_path", ft_path,
                "--n_iters", str(DISPATCH_ITERS), "-ip", "100", "--i_testset", "100", "--seed", "42",
                "--basedir", os.path.join(MESH_DIR, f"k{k}"), "--testskip", "1", "--steps_per_dispatch", k,
                "--multihost"]
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE="1", RANK="0",
                   LOCAL_RANK="0", PYTHONPATH=HERE)
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", MESH_CLI, *argv], cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t1
        with open(os.path.join(MESH_DIR, f"k{k}.log"), "w") as fp:
            fp.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            log(proc.stdout[-3000:] + proc.stderr[-3000:])
        require(proc.returncode == 0, f"(h) run.py --multihost --steps_per_dispatch {k} exited {proc.returncode}")
        rec = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith("MESH_CLI "))[9:])
        text, arrays = run_outputs(rec["expdir"])
        runs[k] = (text, arrays, rec)
        log(f"[dispatch] (h) run.py --multihost --steps_per_dispatch {k} on {rec['world']} {rec['backend']} rank "
            f"(resolved {rec['chunk']}, {rec['graphs']} graphs captured): {rec['steps']} steps in {wall:.1f} s (its process, evals and checkpoints "
            f"included), K6 launches {rec['launches']}, eval {rec['eval']:.4f} dB, "
            f"{len({n for n, _ in arrays})} checkpoints")
    (t0, a0, r0), (t1, a1, r1) = runs["0"], runs["1"]
    same = sorted(a0) == sorted(a1) and all(np.array_equal(a0[key], a1[key]) for key in a0)
    log(f"[dispatch] (h) psnr.txt identical {t0 == t1}; checkpoint arrays ({len(a0)}) bit for bit {same}")
    require(r0["world"] == r1["world"] == 1 and r0["backend"] == r1["backend"] == "nccl", "(h) not a 1-rank nccl mesh")
    require(r0["chunk"] > 1 and r0["graphs"] >= 1 and (r1["chunk"], r1["graphs"]) == (1, 0),
            f"(h) (chunk, graphs) ({r0['chunk']}, {r0['graphs']}) and ({r1['chunk']}, {r1['graphs']})")
    require(t0 == t1 and same, "(h) the captured run on the nccl mesh differs from the per-step one")
    require(r0["launches"] == r1["launches"] == DISPATCH_ITERS,
            f"(h) K6 launches {r0['launches']} and {r1['launches']}, not {DISPATCH_ITERS}")
    return r0["launches"]


def run_dispatch(params, scene, device) -> dict:
    """[dispatch]: K train steps per host sync through CUDA-graph replay
    (train/dispatch.py), gates (a)-(f); on a one-rank nccl mesh (g) the
    sharded steps and (h) run.py --multihost; the step times of both loops
    and the idle share of a captured chunk. Returns the times and launches
    for the kernels' record."""
    import shutil

    from nerf_sampling_tpu_torch.parallel import ops
    from nerf_sampling_tpu_torch.render import pack_kernel_weights
    from nerf_sampling_tpu_torch.render.quantize import calibrate_pipeline
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    fresh = pack_kernel_weights(load_render_params(CKPT, production_pipeline("cuda"), device), with_hier=True)
    pipes = {"cuda": production_pipeline("cuda"),
             "cuda_int8": calibrate_pipeline(production_pipeline("cuda_int8"), fresh, scene)}
    batches = [b[:2] for b in train_batches(scene, device, 1, seed=77)]
    seed_times = check_k6_seed_word(fresh, pipes, batches, device)
    times = {}
    for kind in DISPATCH_CHUNKS:
        sampler = RaySampler(scene, SamplerConfig(N_rand=1024), seed=42)
        times[kind] = check_dispatch_steps(kind, fresh, pipes, sampler, device)
    check_capturable_adam(fresh, pipes, RaySampler(scene, SamplerConfig(N_rand=1024), seed=43), device)
    launches = run_dispatch_trainer(device)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t1 = time.perf_counter()
    mesh = ops.spawn(mesh_rank, 1, (fresh, pipes, scene, device, times), rendezvous=os.path.join(MESH_DIR, "rendezvous"),
                     backend="nccl", timeout=SCALEOUT_TIMEOUT, rank0_here=True)
    log(f"[dispatch] (g) phase {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    mesh_launches = run_mesh_cli()
    log(f"[dispatch] (h) phase {time.perf_counter() - t1:.1f} s")
    for tag, recs in (("1 rank", times), ("1 nccl rank, sharded", mesh)):
        log(f"[dispatch] {smi}, {tag}: median ms a step, per-step loop / captured chunks: "
            + "; ".join(f"{k} {v['eager_ms']:.3f} / {v['captured_ms']:.3f}" for k, v in recs.items())
            + "; device idle in one profiled captured chunk: "
            + ", ".join(f"{k} {100 * v['idle']:.1f}%" for k, v in recs.items()))
    log(f"[dispatch] phase {time.perf_counter() - t0:.1f} s")
    mesh_counts: dict[str, int] = {}
    for rec in mesh.values():
        for counter, n in rec["launched"].items():
            mesh_counts[counter] = mesh_counts.get(counter, 0) + n
    return {"seed": seed_times, "steps": times, "launches": launches, "mesh_launches": mesh_launches,
            "mesh_counts": mesh_counts}


SCALEOUT_DIR = os.path.join(HERE, "logs", "chip_smoke_scaleout")  # [scaleout]'s rendezvous, inputs, runs (gitignored)
SCALEOUT_RANKS = 2  # the ranks of [scaleout], all on cuda:0 under gloo
SCALEOUT_STEPS = 5  # [scaleout] (b) and (c): steps on one rank and on two
SCALEOUT_ITERS = 60  # [scaleout] (e): Trainer steps, the eval at the last
SCALEOUT_TIMEOUT = 300.0  # s a rank's collective waits for its peer; the parent waits as long for the ranks
SCALEOUT_EVAL_TOL = 0.5  # dB between the 2-rank and 1-rank Trainers' evals after SCALEOUT_ITERS steps


def scaleout_counts(reset: bool = False) -> dict[str, int]:
    """The launch counts of the kernels [scaleout] drives (set to 0 with ``reset``)."""
    names = ("depth_net_kernel", "render_around_depth_kernel", "render_gaussian_kernel", "render_hier_kernel",
             "nerf_points_kernel", "nerf_points_bwd_kernel")
    if reset:
        reset_launches(*names)
    return launched(*names)


def scaleout_params(device):
    """The committed checkpoint (NeRFs 8x256, DepthNet 10x256) with its kernel packs."""
    from nerf_sampling_tpu_torch.render import pack_kernel_weights
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    return pack_kernel_weights(load_render_params(CKPT, production_pipeline("cuda"), device), with_hier=True)


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float().cpu() for t in tensors])


def scaleout_steps(kind: str, batches, device, mesh=None, shard=None) -> dict:
    """SCALEOUT_STEPS depth-net (``kind`` "depth": K6 oracle, DepthNet
    autograd) or nerf ("nerf": K4/K5, NeRFs from seed 42) steps from the
    same state, batches and seeds: one rank on the whole batch (``mesh``
    None), the rank's rows, or with ``shard=(r, world)`` and no mesh the
    one-device step on block r alone (its own gradients, not reduced);
    losses, the parameters after the first and
    the last step, the gradients of the first, and the median host time of
    the steps after the first (synchronized)."""
    from nerf_sampling_tpu_torch.parallel import ops, replicate, shard_ray_batch
    from nerf_sampling_tpu_torch.train import steps
    from nerf_sampling_tpu_torch.train.state import init_nerf_state, init_state, nerf_modules
    from nerf_sampling_tpu_torch.train.trainer import _initial_models

    pipe = production_pipeline("cuda")
    if kind == "depth":
        params = scaleout_params(device)
        state = init_state(params.depth, 1e-4)
        frozen = params._replace(depth=None)
        step = ops.make_sharded_depth_train_step(pipe, frozen, mesh) if mesh else \
            steps.make_depth_net_train_step(pipe, frozen, shard=shard or (0, 1))
        model = params.depth
    else:
        coarse, fine, _ = _initial_models(pipe, 1, with_depth=False)  # seed 1: both NeRFs start with density
        nerfs = nerf_modules(coarse.to(device), fine.to(device))
        state = init_nerf_state(nerfs, 5e-4, 250)
        step = ops.make_sharded_nerf_train_step(pipe, mesh) if mesh else \
            steps.make_nerf_train_step(pipe, shard=shard or (0, 1))
        model = nerfs
    if mesh is not None:
        replicate(mesh, model)
    out = {"losses": [], "ms": []}
    for i, batch in enumerate(batches):
        batch = tuple(t.to(device) for t in batch)
        if shard is not None:
            n = batch[0].shape[0] // shard[1]
            batch = tuple(t[shard[0] * n:(shard[0] + 1) * n] for t in batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, shard_ray_batch(mesh, batch) if mesh else batch, 1000 + i)
        out["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["p1"] = flat(model.parameters())
            out["g1"] = flat(p.grad for p in model.parameters())
    torch.cuda.synchronize()
    out["p_last"] = flat(model.parameters())
    out["ms"] = float(np.median(out["ms"][1:])) if len(out["ms"]) > 1 else out["ms"][0]
    return out


def scaleout_render(population: str, device, mesh=None) -> dict[str, torch.Tensor]:
    """View 0 at 400x400 through DEPTH_NET at ``population``/64/1.0 (K1, then
    K2 or K3): ``render_image``, or ``render_image_sharded`` over ``mesh``;
    the maps on the host and the host time of a second frame (synchronized,
    the gather included)."""
    import dataclasses

    from nerf_sampling_tpu_torch.parallel import render_image_sharded
    from nerf_sampling_tpu_torch.render import render_image

    pipe = dataclasses.replace(production_pipeline("cuda"), sampling_mode=population)
    H, W, K, c2w = view0_camera()
    params = scaleout_params(device)
    times = []
    for _ in range(2):
        kw = dict(device=device, generator=torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = render_image_sharded(pipe, params, H, W, K, c2w, mesh=mesh, **kw) if mesh else \
            render_image(pipe, params, H, W, K, c2w, **kw)
        maps = {k: maps[k].cpu() for k in ("depth_net_rgb_map", "depth_net_disp_map")}
        times.append((time.perf_counter() - t0) * 1e3)
    return {**maps, "ms": times[-1]}


def scaleout_trainer(cfg, device) -> dict:
    """(e): the Trainer for SCALEOUT_ITERS depth-net steps and the eval at the last."""
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device=device)
    final = tr.train(N_iters=SCALEOUT_ITERS + 1)
    return {"final": final, "eval": tr._avg_eval_psnr, "primary": tr.primary,
            "checksum": flat(tr.params.depth.parameters()), "expdir": tr.expdir}


def scaleout_gloo_rule(cfg, device) -> dict:
    """(i): the Trainer with an explicit steps_per_dispatch 4 on this gloo
    mesh on the card: the error it raises and the steps it ran."""
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device=device)
    try:
        tr.train(N_iters=SCALEOUT_ITERS + 1)
    except ValueError as err:
        return {"error": str(err), "steps": tr.global_step}
    return {"error": None, "steps": tr.global_step}


def scaleout_rank(rank: int, world: int, spec_path: str) -> None:
    """One rank of [scaleout] on cuda:0: (b)-(e) and (i) on its rows, each
    phase's launches counted from 0; its results to ``rank{rank}.pt``."""
    import dataclasses

    from nerf_sampling_tpu_torch.parallel import make_mesh

    spec = torch.load(spec_path, weights_only=False)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_mesh(world)
    t0 = time.perf_counter()
    rec: dict = {"counts": {}}
    for phase, fn in (("b", lambda: scaleout_steps("depth", spec["batches"], device, mesh)),
                      ("c", lambda: scaleout_steps("nerf", spec["batches"], device, mesh)),
                      ("d", lambda: {p: scaleout_render(p, device, mesh) for p in ("uniform", "gaussian")}),
                      ("e", lambda: scaleout_trainer(dataclasses.replace(
                          spec["cfg"], n_devices=world, basedir=os.path.join(SCALEOUT_DIR, f"rank{rank}")),
                          device)),
                      ("i", lambda: scaleout_gloo_rule(dataclasses.replace(
                          spec["cfg"], n_devices=world, steps_per_dispatch=4, i_print=20,
                          basedir=os.path.join(SCALEOUT_DIR, f"gloo_rule_rank{rank}")), device))):
        scaleout_counts(reset=True)
        rec[phase] = fn()
        torch.cuda.synchronize()
        rec["counts"][phase] = scaleout_counts()
    rec["seconds"] = time.perf_counter() - t0
    torch.save(rec, os.path.join(SCALEOUT_DIR, f"rank{rank}.pt"))


def check_ray_base(params, scene, device, recs: dict) -> None:
    """(a): K6 on rows 512:1024 of a 1024-ray batch with ray_base 512, and K3
    on rows 80,000:160,000 of view 0 with ray_base 80,000, against the
    matching rows of the whole launch (bits) and against their plain
    versions with the host twins' ray0 ([K6]'s and [K3]'s tolerances)."""
    from nerf_sampling_tpu_torch.kernels import fused_depth_net as k1
    from nerf_sampling_tpu_torch.kernels import fused_hier as k6
    from nerf_sampling_tpu_torch.kernels import fused_render as k3

    Nc, Nf = 64, 128
    ro, rd = train_batches(scene, device, 1, seed=3)[0][:2]
    lo = ro.shape[0] // 2
    cfg_c, cfg_f, hier = params.coarse.cfg, params.fine.cfg, params.kernels.hier
    kw = dict(n_coarse=Nc, n_importance=Nf, seed=21)
    full = k6.render_hier_kernel(hier, cfg_c, cfg_f, ro, rd, **kw)
    part = k6.render_hier_kernel(hier, cfg_c, cfg_f, ro[lo:].contiguous(), rd[lo:].contiguous(), ray_base=lo, **kw)
    plain = k6.render_hier_plain(hier, cfg_c, cfg_f, ro[lo:], rd[lo:], ray_base=lo, **kw)
    torch.cuda.synchronize()
    bits = all(torch.equal(part[k], full[k][lo:]) for k in full)
    errs = {}
    for name in ("rgb_map", "acc_map"):
        d = (part[name] - plain[name]).abs()
        errs[name] = (float(d.mean()), quantile(d, 0.999))
    log(f"[scaleout] (a) K6 rows {lo}:{2 * lo} with ray_base {lo}: bit-identical to rows {lo}:{2 * lo} of the whole "
        f"launch: {bits}; vs its plain version (philox.hier_draws ray0={lo}) mean/p99.9 "
        + ", ".join(f"{k} {m:.3e}/{p:.3e}" for k, (m, p) in errs.items()) + f" (tol {K6_MEAN_TOL:g}/{K6_P999_TOL:g})")
    require(bits, "K6: a launch at ray_base is not the slice of the whole launch")
    require(all(m <= K6_MEAN_TOL and p <= K6_P999_TOL for m, p in errs.values()),
            "K6 at ray_base disagrees with its plain version")
    recs["render_hier_kernel"]["ray_base_check"] = {"rows": f"{lo}:{2 * lo}", "bits_equal": bits,
                                                    "plain_mean_p999": errs}

    ro, rd = view0_rays(device)
    depth = k1.fused_depth_net_apply(params.kernels.depth, params.depth.cfg, ro, rd)
    n, S, std = ro.shape[0], 64, 1.0
    lo = n // 2
    packed, cfg = params.kernels.nerf, params.fine.cfg
    kw = dict(n_samples=S, std=std, seed=23)
    full = k3.render_gaussian_kernel(packed, cfg, ro, rd, depth, **kw)
    part = k3.render_gaussian_kernel(packed, cfg, ro[lo:].contiguous(), rd[lo:].contiguous(), depth[lo:].contiguous(),
                                     ray_base=lo, **kw)
    chunk = 16384
    parts = [k3.render_gaussian_plain(packed, cfg, ro[s:s + chunk], rd[s:s + chunk], depth[s:s + chunk], std=std,
                                      n_samples=S, seed=23, ray_base=s) for s in range(lo, n, chunk)]
    plain = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    torch.cuda.synchronize()
    bits = all(torch.equal(part[k], full[k][lo:]) for k in full)
    errs = {}
    for name, scale in (("rgb_map", 1.0), ("acc_map", 1.0), ("depth_map", 6.0)):
        mean, mx = errors(part[name], plain[name])
        errs[name] = (mean, mx)
        require(mean <= K2_MEAN_TOL * scale and mx <= K2_MAX_TOL * scale,
                f"K3 {name} at ray_base disagrees with its plain version")
    log(f"[scaleout] (a) K3 rows {lo}:{n} with ray_base {lo}: bit-identical to rows {lo}:{n} of the {n}-ray launch: "
        f"{bits}; vs its plain version (philox.gaussian_noise ray0={lo}) mean/max "
        + ", ".join(f"{k} {m:.3e}/{x:.3e}" for k, (m, x) in errs.items())
        + f" (tol {K2_MEAN_TOL:g}/{K2_MAX_TOL:g}, depth x6)")
    require(bits, "K3: a launch at ray_base is not the slice of the whole launch")
    recs["render_gaussian_kernel"]["ray_base_check"] = {"rows": f"{lo}:{n}", "bits_equal": bits,
                                                        "plain_mean_max": errs}


def iter_losses(expdir: str) -> list[tuple[int, float]]:
    """(step, Loss) of every Iter line of an experiment's psnr.txt."""
    with open(os.path.join(expdir, "psnr.txt")) as fp:
        return [(int(ln.split()[1]), float(ln.split("Loss: ")[1].split(",")[0])) for ln in fp if ln.startswith("Iter:")]


def run_scaleout(device, scene, recs: dict) -> dict[str, list[int]]:
    """[scaleout]: (a) K6 and K3 at ray_base; then the one-rank references
    here and SCALEOUT_RANKS ranks spawned on cuda:0 under gloo ((b) the
    depth-net step, (c) the nerf step, (d) the sharded render of view 0,
    (e) the Trainer), each held to the one rank. Returns each kernel's
    launches on the ranks over (b)-(e)."""
    import dataclasses
    import shutil

    from nerf_sampling_tpu_torch.core.metrics import psnr_np
    from nerf_sampling_tpu_torch.experiments import run
    from nerf_sampling_tpu_torch.parallel import ops
    from nerf_sampling_tpu_torch.utils.precision import matmul_precision

    t0 = time.perf_counter()
    shutil.rmtree(SCALEOUT_DIR, ignore_errors=True)
    os.makedirs(SCALEOUT_DIR)
    check_ray_base(scaleout_params(device), scene, device, recs)
    batches = [tuple(t.cpu() for t in b) for b in train_batches(scene, device, SCALEOUT_STEPS, seed=9)]
    ft_path = os.path.join(SCALEOUT_DIR, "nerf_only.npz")
    write_nerf_only_checkpoint(ft_path)
    argv = ["-d", "example", "-m", "recommended_depth_net_module", "--mlp_impl", "cuda", "--ft_path", ft_path,
            "--n_iters", str(SCALEOUT_ITERS), "--i_testset", str(SCALEOUT_ITERS), "-ip", "10", "--seed", "42",
            "--testskip", "1"]
    cfg = run.trainer_config(vars(run.build_parser().parse_args(argv)))
    t1 = time.perf_counter()
    # what the comparisons below rest on: one rank's step gives the same bits twice, and a batch of
    # 512 rows rounds the DepthNet's fp32 forward differently from the same rows in 1024
    again = [scaleout_steps("depth", batches[:1], device)["g1"] for _ in range(2)]
    params = scaleout_params(device)
    ro, rd = batches[0][0].to(device), batches[0][1].to(device)
    with matmul_precision(production_pipeline("cuda").matmul_precision), torch.no_grad():
        z_whole, z_half = params.depth(ro, rd)[512:], params.depth(ro[512:].contiguous(), rd[512:].contiguous())
    log(f"[scaleout] one rank's depth step twice from one state: grads bit-identical: "
        f"{torch.equal(again[0], again[1])}; the DepthNet's fp32 forward of rows 512:1024 in the 1024-row batch "
        f"against the 512 rows alone: max |diff| {float((z_whole - z_half).abs().max()):.3e} (cuBLAS picks its "
        "kernels by shape)")
    require(torch.equal(again[0], again[1]), "one rank's depth step is not deterministic")
    # the mean of each half's own first-step gradients, made here: what the all-reduce must give
    halves = {p: sum(scaleout_steps(k, batches[:1], device, shard=(r, SCALEOUT_RANKS))["g1"]
                     for r in range(SCALEOUT_RANKS)) / SCALEOUT_RANKS for p, k in (("b", "depth"), ("c", "nerf"))}
    want = {"b": scaleout_steps("depth", batches, device), "c": scaleout_steps("nerf", batches, device),
            "d": {p: scaleout_render(p, device) for p in ("uniform", "gaussian")},
            "e": scaleout_trainer(dataclasses.replace(cfg, basedir=os.path.join(SCALEOUT_DIR, "single")), device)}
    log(f"[scaleout] one-rank references on {torch.cuda.get_device_name(0)} in {time.perf_counter() - t1:.1f} s")
    spec = os.path.join(SCALEOUT_DIR, "inputs.pt")
    torch.save({"batches": batches, "cfg": cfg, "device": str(device)}, spec)
    t1 = time.perf_counter()
    ops.spawn(scaleout_rank, SCALEOUT_RANKS, (spec,), rendezvous=os.path.join(SCALEOUT_DIR, "rendezvous"),
              backend="gloo", timeout=SCALEOUT_TIMEOUT, join_timeout=SCALEOUT_TIMEOUT)
    ranks = [torch.load(os.path.join(SCALEOUT_DIR, f"rank{r}.pt"), weights_only=False) for r in range(SCALEOUT_RANKS)]
    log(f"[scaleout] {SCALEOUT_RANKS} gloo ranks sharing cuda:0 (a correctness check, not a scaling one) in "
        f"{time.perf_counter() - t1:.1f} s (spawn and setup included; (b)-(e) took "
        + ", ".join(f"{r['seconds']:.1f}" for r in ranks) + " s on the ranks)")
    r0, r1 = ranks

    # (b) and (c): the steps. One rank's step is deterministic on the card, but its fp32 GEMMs round a
    # row differently at another batch size (cuBLAS picks its kernels by shape), K5's weight grads are
    # bf16 sums over the rows a launch sees, and a single-sample composite is a step in the density:
    # so the 2-rank step equals the 1-rank step exactly in what the all-reduce does (the mean of the
    # two halves' own gradients, bit for bit) and to the halves' rounding in the rest
    for phase, name, lr, grad_tol in (("b", "depth-net step (K6 oracle, DepthNet autograd)", 1e-4, 1e-3),
                                      ("c", "nerf step (K4/K5)", 5e-4, 2.0**-8)):
        got, ref = r0[phase], want[phase]
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
        dp1 = (got["p1"] - ref["p1"]).abs()
        outside = float((dp1 > 1e-6 + 1e-4 * ref["p1"].abs()).float().mean())
        exact = torch.equal(got["g1"], halves[phase])
        dg = float((halves[phase] - ref["g1"]).abs().max()) / float(ref["g1"].abs().max())
        same = torch.equal(r0[phase]["p_last"], r1[phase]["p_last"])
        log(f"[scaleout] ({phase}) {name}, 2 ranks x 512 rays against 1 rank x 1024: loss rel diff per step "
            + ", ".join(f"{v:.2e}" for v in rel) + f"; the all-reduced grads equal the mean of the halves' own "
            f"grads bit for bit: {exact}; that mean against the 1024-row grads max |diff| / max |grad| {dg:.2e} "
            f"(tol {grad_tol:.2e}); after step 1 params max |diff| {float(dp1.max()):.3e} (one Adam step "
            f"{2 * lr:g}), {outside:.2e} of them outside rtol 1e-4/atol 1e-6; after step {SCALEOUT_STEPS} params "
            f"max |diff| {float((got['p_last'] - ref['p_last']).abs().max()):.3e}, the ranks' params "
            f"bit-identical: {same}; a step {got['ms']:.3f} / {r1[phase]['ms']:.3f} ms on the ranks, "
            f"{ref['ms']:.3f} ms on 1 rank (median host time of steps 2-{SCALEOUT_STEPS}); rank launches "
            f"{r0['counts'][phase]} / {r1['counts'][phase]}")
        require(r0[phase]["losses"] == r1[phase]["losses"] and same, f"({phase}): the ranks disagree")
        require(rel[0] <= 1e-5, f"({phase}): the 2-rank loss differs from the 1-rank one")
        require(exact, f"({phase}): the all-reduced grads are not the mean of the halves' grads")
        require(dg <= grad_tol, f"({phase}): the halves' grads differ from the 1-rank grads beyond rounding")
        require(float(dp1.max()) <= 2 * lr, f"({phase}): the params after step 1 differ by more than an Adam step")

    # (d): the sharded render
    gt = scene.images[int(scene.i_test[0])]
    for pop in ("uniform", "gaussian"):
        got, ref = r0["d"][pop], want["d"][pop]
        maps = ("depth_net_rgb_map", "depth_net_disp_map")
        bits = all(torch.equal(got[k], ref[k]) and torch.equal(got[k], r1["d"][pop][k]) for k in maps)
        psnr = psnr_np(got["depth_net_rgb_map"].numpy(), gt)
        log(f"[scaleout] (d) view 0 DEPTH_NET {pop}/64/1.0 over 2 ranks: bit-identical to the 1-rank render: {bits}; "
            f"PSNR {psnr:.4f} dB (1 rank {psnr_np(ref['depth_net_rgb_map'].numpy(), gt):.4f}); a frame "
            f"{got['ms']:.2f} / {r1['d'][pop]['ms']:.2f} ms on the ranks, {ref['ms']:.2f} ms on 1 rank (host "
            "clock, synchronized, gather included)")
        require(bits, f"(d): the 2-rank {pop} render differs from the 1-rank one")
    require(all(r["counts"]["d"][k] > 0 for r in ranks for k in
                ("depth_net_kernel", "render_around_depth_kernel", "render_gaussian_kernel")),
            "(d): K1, K2 and K3 must launch on every rank")

    # (e): the Trainer
    got, ref = r0["e"], want["e"]
    got_l, ref_l = iter_losses(got["expdir"]), iter_losses(ref["expdir"])
    log(f"[scaleout] (e) Trainer(n_devices=2, device='cuda:0'), {SCALEOUT_ITERS} depth-net steps from the committed "
        f"NeRF: losses at steps {[s for s, _ in got_l]} rel diff from 1 rank "
        + ", ".join(f"{abs(a[1] - b[1]) / abs(b[1]):.2e}" for a, b in zip(got_l, ref_l)) + "; eval at step "
        f"{SCALEOUT_ITERS} {got['eval']:.4f} dB (1 rank {ref['eval']:.4f}); rank launches {r0['counts']['e']} / "
        f"{r1['counts']['e']}")
    require([s for s, _ in got_l] == [s for s, _ in ref_l], "(e): the logged steps differ from 1 rank")
    require(abs(got_l[0][1] - ref_l[0][1]) <= 1e-4 * abs(ref_l[0][1]), "(e): the first logged loss differs")
    require(abs(got["eval"] - ref["eval"]) <= SCALEOUT_EVAL_TOL, "(e): the eval is too far from 1 rank's")
    # the sharded eval is the 1-rank eval of the same DepthNet: rank 0's step-60 best, evaluated here
    from nerf_sampling_tpu_torch.train.trainer import Trainer

    best = os.path.join(got["expdir"], "best", f"depth_{SCALEOUT_ITERS:06d}.npz")
    tr = Trainer(dataclasses.replace(cfg, basedir=os.path.join(SCALEOUT_DIR, "reeval"), depth_net_path=best),
                 device=device)
    tr.scene = tr.load_data()
    tr.setup_models()
    reeval = tr.eval_testset(None)
    log(f"[scaleout] (e) rank 0's step-{SCALEOUT_ITERS} DepthNet evaluated on 1 rank: {reeval:.6f} dB, the 2-rank "
        f"eval {got['eval']:.6f} dB")
    require(reeval == got["eval"], "(e): the 2-rank eval differs from the 1-rank eval of the same DepthNet")
    require(got["eval"] == r1["e"]["eval"] and torch.equal(got["checksum"], r1["e"]["checksum"]),
            "(e): the ranks disagree")
    require(r0["e"]["primary"] and not r1["e"]["primary"], "(e): rank 0 must be the primary")
    require(not os.path.exists(os.path.join(SCALEOUT_DIR, "rank1")), "(e): rank 1 wrote files")
    require(os.path.exists(os.path.join(got["expdir"], "best", f"depth_{SCALEOUT_ITERS:06d}.npz")),
            "(e): rank 0 wrote no best checkpoint")
    for phase, kernels in (("b", ("render_hier_kernel",)), ("c", ("nerf_points_kernel", "nerf_points_bwd_kernel")),
                           ("e", ("render_hier_kernel", "depth_net_kernel", "render_gaussian_kernel"))):
        require(all(r["counts"][phase][k] > 0 for r in ranks for k in kernels),
                f"({phase}): {', '.join(kernels)} must launch on every rank")
    # (i): an explicit steps_per_dispatch 4 on this gloo mesh raises before step 1 on both ranks
    for r in ranks:
        log(f"[scaleout] (i) rank: steps_per_dispatch 4 on the gloo mesh raised {r['i']['error']!r} after "
            f"{r['i']['steps']} steps; launches {r['counts']['i']}")
    require(all(r["i"]["error"] is not None and "gloo" in r["i"]["error"] and r["i"]["steps"] == 0
                and not any(r["counts"]["i"].values()) for r in ranks),
            "(i): steps_per_dispatch 4 on a gloo mesh must raise before step 1, naming gloo")
    launches = {k: [sum(r["counts"][p][k] for p in "bcde") for r in ranks] for k in r0["counts"]["b"]}
    log(f"[scaleout] launches per rank over (b)-(e): {launches}; phase {time.perf_counter() - t0:.1f} s")
    return launches


def ptxas_usage(path: str, entry: str) -> str:
    """The registers and spills that ptxas -v reported for the first entry
    function whose mangled name contains ``entry``, from a build log."""
    with open(path) as fp:
        lines = fp.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            found = []
            for nxt in lines[i + 1:i + 6]:
                if "spill" in nxt or "registers" in nxt:
                    found.append(nxt.split(":")[-1].strip() if "registers" in nxt else nxt.strip())
                if "registers" in nxt:
                    break
            return "; ".join(found)
    return "not found in the build log"


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nerf_sampling_tpu_torch.render import pack_kernel_weights
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    build.load_library()
    info = build.build_info
    log(f"[build] {'built' if info['built'] else 'cached'} {info['path']} in {info['seconds']:.1f} s")
    if info["built"]:
        with open(info["log"]) as fp:
            for line in fp:
                if "Compiling entry" in line or "registers" in line or "spill" in line or "smem" in line:
                    log("[build] " + line.rstrip()[:160])
        log(f"[build] render_around_depth_kernel<bf16> (K2, K3, K8, K9 on the wgmma core): "
            f"{ptxas_usage(info['log'], 'render_around_depth_kernelI13__nv_bfloat16')}")
        log(f"[build] render_around_depth_kernel<float> (K8, K9 in fp32 on the wgmma core, 3xTF32): "
            f"{ptxas_usage(info['log'], 'render_around_depth_kernelIfE')}")
        log(f"[build] render_around_depth_kernel<int8_t> (K10 in K2, K3, K8, K9 on the wgmma core, s8): "
            f"{ptxas_usage(info['log'], 'render_around_depth_kernelIaE')}")
        log(f"[build] depth_net_kernel<bf16> (K1 on the wgmma core): "
            f"{ptxas_usage(info['log'], 'depth_net_kernelI13__nv_bfloat16E')}")
        log(f"[build] depth_net_kernel<float> (K1 in fp32 on the wgmma core, 3xTF32): "
            f"{ptxas_usage(info['log'], 'depth_net_kernelIfE')}")
        for name, tag, mangled in (("bf16", "K6, K7 in bf16", "render_hier_kernelI13__nv_bfloat16E"),
                                   ("int8_t", "K6, K7 in int8", "render_hier_kernelIaE"),
                                   ("float", "K7 in fp32, 3xTF32", "render_hier_kernelIfE")):
            log(f"[build] render_hier_kernel<{name}> ({tag} on the wgmma core): {ptxas_usage(info['log'], mangled)}")
        log(f"[build] nerf_points_kernel (K4 on the wgmma core): {ptxas_usage(info['log'], 'nerf_points_kernel')}")
    check_core(device)

    params = pack_kernel_weights(load_render_params(CKPT, production_pipeline("cuda"), device),
                                 with_hier=True)
    scene, K = load_example_scene()
    batches = [b[:2] for b in train_batches(scene, device, 64)]
    kernels = [check_k1(params, device), check_k2(params, device), check_k3(params, device),
               check_k6(params, device, batches)]
    queries = step_queries(params, scene, device)
    kernels += [check_k4(params, queries), check_k5(params, queries), check_k7(params, scene, K, device)]
    del queries
    mip_rec, mip_counts = check_mip(device)
    kernels.append(mip_rec)
    torch.cuda.synchronize()
    k8_rec, k8_counts = check_k8(params, scene, K, device)
    kernels += [k8_rec, check_k9(params, device)] + check_fp32(params, device)
    check_modes(params, scene, K, device)
    k10_recs, k10_counts = check_k10(params, scene, K, device, batches)
    kernels += k10_recs
    del batches
    render_counts, slice_psnrs = run_slice(device, scene, K)
    cli_counts = run_render_cli(device, slice_psnrs)
    train_counts, trainer = run_training(device, scene, K)
    int8_train_counts = run_int8_training(device, scene, K, trainer._avg_eval_psnr)
    check_train_step(trainer, scene, device)
    check_nerf_steps(scene, device)
    nerf_counts = run_nerf_cli(device)
    joint_counts = run_joint_cli(device, scene, K)
    tar_counts = run_tar(device, scene, K)
    llff_counts = run_llff(device)
    formats_counts = run_formats(device)
    dispatch = run_dispatch(params, scene, device)
    scaleout_launches = run_scaleout(device, scene, {rec["name"]: rec for rec in kernels})
    torch.cuda.synchronize()
    # the count of the path each kernel serves: K2 renders, K1/K3/K6 train the
    # DepthNet, K4/K5/K7 train and evaluate the NeRF, K8 renders FULL_NERF
    # without fine samples, the fp32 K1/K7/K9 render COMPARE_NERF through the
    # render CLI; in int8, K3/K6 train the DepthNet, K2 and K7 render through
    # the CLI, K8 FULL_NERF without fine samples (the joint run's and the
    # CLI's other counts are gated above)
    for rec in kernels:
        rec["launches"] = next(c[rec["name"]] for c in (nerf_counts, train_counts, render_counts, joint_counts,
                                                        k8_counts, cli_counts, int8_train_counts, k10_counts, mip_counts)
                               if rec["name"] in c)
        for key, counts in (("tar_launches", tar_counts), ("llff_launches", llff_counts),
                            ("formats_launches", formats_counts), ("scaleout_launches", scaleout_launches)):
            if rec["name"] in counts:
                rec[key] = counts[rec["name"]]
        rec.update(dispatch["seed"].get(rec["name"], {}))  # K6 by value and by pointer, timed in turns
    next(rec for rec in kernels if rec["name"] == "render_hier_kernel")["dispatch_launches"] = dispatch["launches"]
    # the captured sharded steps on a one-rank nccl mesh ((g)) and run.py --multihost ((h))
    for name in ("render_hier_kernel", "render_hier_kernel_int8", "nerf_points_kernel", "nerf_points_bwd_kernel"):
        next(rec for rec in kernels if rec["name"] == name)["mesh_dispatch_launches"] = \
            dispatch["mesh_counts"].get(name, 0)
    next(rec for rec in kernels if rec["name"] == "render_hier_kernel")["mesh_cli_launches"] = dispatch["mesh_launches"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
