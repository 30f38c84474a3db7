"""Where the port's depth-net training departs from the JAX package's: the
experiments D1-D3.

    python3 scripts/torch_parity_runs.py run D1      # on the card: the depth recipe against the committed NeRF
    python3 scripts/torch_parity_runs.py run D2      # on the card: the oracle's targets at fixed weights
    python3 scripts/torch_parity_runs.py run D3      # on the CPU: both Trainers, in lockstep and in distribution
    python3 scripts/torch_parity_runs.py gate D1     # an arm's verdict from its evidence (CPU)
    python3 scripts/torch_parity_runs.py summary     # evidence/torch_parity/summary.json

- **D1** runs the recipe of ``evidence/example_depth_net/args.txt`` (the
  JAX package's 10k DepthNet on a TPU, against the committed checkpoint's
  NeRFs) flag for flag through the port's CLI, but for the paths,
  ``--mlp_impl`` and ``-ip 100`` (logging only), in three arms one after
  another: ``cuda`` at auto K (captured chunks), ``cuda`` at
  ``--steps_per_dispatch 1`` and ``plain`` (fp32, no K6) at
  ``--steps_per_dispatch 1``. The NeRF-only checkpoint is the committed
  file's NeRFs (as ``chip_smoke.py`` writes it). ``gate D1`` holds each
  arm's median logged ``Depth Net Loss`` at the TPU run's logged steps to
  the TPU's: within ``LEVEL`` times it is "at the TPU's level".
- **D2** takes the committed NeRFs and DepthNet and 20 train batches of
  1,024 rays and computes the oracle's ``max_z`` and ``acc`` and the depth
  loss three ways: K6 with its own Philox draws (8 seeds a batch), K6 with
  draws injected from numpy (8 sets) and the plain fp32 path with the same
  injected draws. It reports each ray's target spread over the 8 draws
  and the batch depth loss, holds K6's seeded launch to K6 given
  ``kernels/philox.py``'s draws of that seed (so the host twin's draws are
  the kernel's), tests those draws for uniformity (Kolmogorov-Smirnov) and
  independence (lag-1 correlation) across rays, samples and the steps of a
  chunk, and replays one captured K6 launch with a new seed word each time
  against eager launches at the same seeds.
- **D3** (CPU; imports both packages, as the tests do) runs the JAX
  Trainer's steps (``mlp_impl="xla"``) and the port's (``plain``) on the
  same generated scene at reduced widths, in five arms: ``nerf`` from
  scratch, ``depth`` against a frozen NeRF that JAX trained, ``joint``
  across a warmup, ``llff_depth`` under NDC and ``deepvoxels_depth`` on 30
  views, plus ``depth_full`` at the committed checkpoint's full widths for
  a few hundred steps. In lockstep both start from the same weights (the
  port draws the JAX Trainer's, ``core/prng.py``) and every port step
  takes the JAX step's draws (``draws_from_key``); the first step where the loss differs by
  more than ``LOCK_RTOL`` or a net's weights by more than ``LOCK_WTOL`` of
  their norm is reported, with the cadence it falls on. In distribution
  each package runs ``SEEDS`` seeds with its own draws and the port's mean
  is held to the JAX seeds' band (mean +- 2 std, at least +-0.1 dB in eval
  and +-20% in the median depth loss) at every logged point.

The injection hooks are this script's alone: it wraps the port's step
makers (which take ``draws=``) and patches nothing into the port.
Evidence: ``evidence/torch_parity/<arm>/``; scratch runs under
``logs/torch_parity/`` (gitignored).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "scripts")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch_r5  # noqa: E402  (the round-5 runner and its records)

LOGS = "logs/torch_parity"
EVIDENCE = "evidence/torch_parity"
CKPT = "evidence/ckpt/example_depth.npz"
TPU_D1 = "evidence/example_depth_net"  # the JAX package's 10k DepthNet on a TPU v5e against the committed NeRF
LEVEL = 2.0  # D1: an arm's median depth loss within this factor of the TPU run's is at its level
D1_ITERS = 10000
D1_ARMS = {
    "cuda_auto": ["--mlp_impl", "cuda"],
    "cuda_k1": ["--mlp_impl", "cuda", "--steps_per_dispatch", "1"],
    "plain": ["--mlp_impl", "plain", "--steps_per_dispatch", "1"],
}
D2_BATCHES, D2_DRAWS, D2_RAYS = 20, 8, 1024


def d1_argv(arm: str, ft_path: str, n_iters: int = D1_ITERS) -> list[str]:
    """The TPU run's recipe (``evidence/example_depth_net/args.txt``) on the port's CLI."""
    return ["-d", "example", "--mode", "depth_net", "-m", "recommended_depth_net_module", "--n_iters", str(n_iters),
            "--ft_path", ft_path, "-ip", "100", "--i_testset", "2500", "--seed", "42", "--testskip", "1",
            "--basedir", f"{LOGS}/D1/{arm}"] + D1_ARMS[arm]


def write_nerf_only_checkpoint(path: str) -> str:
    """The committed checkpoint's NeRFs alone, as a JAX-layout .npz."""
    from nerf_sampling_tpu_torch.train import checkpoint as ck

    tree, _ = ck.read_npz_tree(CKPT)
    sds = ck.params_from_jax(tree["params"])
    sds.pop("depth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ck.save_checkpoint(path, {"params": ck.JaxNeRFParams(**ck.params_to_jax(sds))}, 0)
    return path


def logged(path: str) -> dict[int, dict[str, float]]:
    """The ``Iter:`` lines of a psnr.txt: step -> Loss, Depth Net Loss, PSNR."""
    out = {}
    with open(path) as f:
        for ln in f:
            m = re.match(r"Iter: (\d+) Loss: (\S+), Depth Net Loss: (\S+), PSNR: (\S+)", ln)
            if m:
                out[int(m[1])] = {"loss": float(m[2]), "depth_net_loss": float(m[3]), "psnr": float(m[4])}
    return out


def medians(rows: dict[int, dict[str, float]], steps=None) -> dict:
    steps = sorted(rows) if steps is None else [s for s in steps if s in rows]
    if not steps:
        return {"n": 0}
    col = {k: [rows[s][k] for s in steps] for k in ("depth_net_loss", "loss", "psnr")}
    return {"n": len(steps), **{k: statistics.median(v) for k, v in col.items()},
            "depth_net_loss_range": [min(col["depth_net_loss"]), max(col["depth_net_loss"])]}


# ---------------------------------------------------------------- D1 (card)


def run_d1(n_iters: int = D1_ITERS, device: str = "cuda", out_name: str = "D1", arms=tuple(D1_ARMS)) -> None:
    """D1's ``arms`` into ``evidence/torch_parity/<out_name>/<arm>/`` (a
    later tree's run of the same arms goes beside the first's)."""
    ft = write_nerf_only_checkpoint(os.path.join(LOGS, "D1", "nerf_only.npz"))
    for arm in arms:
        out = os.path.join(EVIDENCE, out_name, arm)
        if os.path.exists(os.path.join(out, "step.json")):
            print(f"[parity] D1/{arm}: done before, skipped")
            continue
        shutil.rmtree(os.path.join(LOGS, "D1", arm), ignore_errors=True)
        argv = d1_argv(arm, ft, n_iters) + ([] if device == "cuda" else ["--device", device])
        rec = {"arm": arm, **torch_r5.execute("run", argv)}
        rec["n_iters"] = n_iters
        os.makedirs(out, exist_ok=True)
        expdir = os.path.join(LOGS, "D1", arm, "example_depth_net")
        for name in ("args.txt", "psnr.txt", "metrics.jsonl"):
            if not os.path.exists(os.path.join(expdir, name)):
                continue
            with open(os.path.join(out, name), "w") as f:
                f.write(torch_r5._relative_text(os.path.join(expdir, name)))
        for p in sorted(glob.glob(os.path.join(expdir, "testset_*", "psnr.txt"))):
            dst = os.path.join(out, os.path.basename(os.path.dirname(p)))
            os.makedirs(dst, exist_ok=True)
            shutil.copy(p, os.path.join(dst, "psnr.txt"))
        torch_r5.write_json(os.path.join(out, "step.json"), rec)


def gate_d1() -> bool:
    """Each arm's medians beside the TPU run's, at the TPU's logged steps
    and over every logged step; the verdict of the issue's rule."""
    tpu = logged(os.path.join(REPO, TPU_D1, "psnr.txt"))
    tpu_m = medians(tpu)
    tpu_evals = torch_r5.trajectory(os.path.join(REPO, TPU_D1))
    out = {"tpu": {"run": TPU_D1, **tpu_m, "evals": tpu_evals and tpu_evals["evals"]}, "level": LEVEL, "arms": {}}
    for arm in D1_ARMS:
        d = os.path.join(EVIDENCE, "D1", arm)
        if not os.path.exists(os.path.join(d, "psnr.txt")):
            continue
        rows = logged(os.path.join(d, "psnr.txt"))
        at_tpu = medians(rows, sorted(tpu))
        if at_tpu["n"] == 0:
            continue
        traj = torch_r5.trajectory(d)
        rec = torch_r5.read_json(os.path.join(d, "step.json"))
        out["arms"][arm] = {
            "at_tpu_steps": at_tpu, "all_logged": medians(rows), "evals": traj and traj["evals"],
            "ratio_to_tpu": at_tpu["depth_net_loss"] / tpu_m["depth_net_loss"],
            "at_tpu_level": at_tpu["depth_net_loss"] <= LEVEL * tpu_m["depth_net_loss"],
            "steps_per_dispatch": rec["steps_per_dispatch"], "captured_graphs": rec["captured_graphs"],
            "wall_s": rec["wall_s"], "card": rec["card"], "launches": rec.get("launches"),
            "by_step": {s: {"port": rows.get(s), "tpu": tpu[s]} for s in sorted(tpu)}}
    arms = out["arms"]
    if len(arms) == len(D1_ARMS):
        level = {a: v["at_tpu_level"] for a, v in arms.items()}
        if all(level.values()):
            out["verdict"] = "all arms at the TPU's level: the port's step is sound; look at the NeRF pretrain (D3 nerf)"
        elif not any(level.values()):
            out["verdict"] = "all arms high: the fault is in the step the paths share"
        elif level["plain"] and not level["cuda_k1"]:
            out["verdict"] = "cuda high, plain not: K6, the capture or the kernels' route"
        elif level["cuda_k1"] and not level["cuda_auto"]:
            out["verdict"] = "captured high, per step not: the capture"
        else:
            out["verdict"] = f"mixed: {level}"
    torch_r5.write_json(os.path.join(EVIDENCE, "D1", "verdict.json"), out)
    print(json.dumps({a: {k: v[k] for k in ("ratio_to_tpu", "at_tpu_level")} for a, v in arms.items()}
                     | {"verdict": out.get("verdict")}, indent=1))
    return "verdict" in out


# ---------------------------------------------------------------- D2 (card)


def ks_uniform(x: np.ndarray) -> float:
    """The Kolmogorov-Smirnov statistic of samples ``x`` against U[0, 1)."""
    x = np.sort(np.asarray(x, np.float64).ravel())
    n = x.size
    i = np.arange(1, n + 1)
    return float(max(np.max(i / n - x), np.max(x - (i - 1) / n)))


def lag1(x: np.ndarray, axis: int) -> float:
    """The lag-1 correlation of ``x`` along ``axis``, pooled over the other axes."""
    a = np.moveaxis(np.asarray(x, np.float64), axis, -1)
    u, v = a[..., :-1].ravel(), a[..., 1:].ravel()
    return float(np.corrcoef(u, v)[0, 1])


def draw_statistics(seeds: list[int], n_rays: int, n_draws: int) -> dict:
    """K6's draws (the host twin's, which the kernel's equal: D2 checks) of
    the steps ``seeds``: KS against U[0, 1) per axis and lag-1 correlations
    across rays, samples and steps. The 1% critical KS value of n samples
    is about 1.63 / sqrt(n)."""
    from nerf_sampling_tpu_torch.kernels import philox

    d = np.stack([philox.hier_draws(s, n_rays, n_draws).numpy() for s in seeds])  # [steps, rays, draws]

    def share_over(groups) -> dict:
        """The share of the groups whose KS statistic exceeds its 1% critical value (about 0.01 if uniform)."""
        ks = [ks_uniform(g) for g in groups]
        crit = 1.63 / math.sqrt(np.asarray(groups[0]).size)
        return {"groups": len(ks), "ks_max": max(ks), "crit_1pct": crit,
                "share_over_crit": float(np.mean([k > crit for k in ks]))}

    return {
        "n": int(d.size), "ks_all": ks_uniform(d), "ks_all_crit_1pct": 1.63 / math.sqrt(d.size),
        "per_step": share_over(list(d)), "per_sample": share_over([d[:, :, k] for k in range(n_draws)]),
        "per_ray": share_over([d[:, r, :] for r in range(n_rays)]),
        "lag1_rays": lag1(d, 1), "lag1_samples": lag1(d, 2), "lag1_steps": lag1(d, 0),
        "lag1_sd": 1.0 / math.sqrt(d.size),
        "mean": float(d.mean()), "var": float(d.var()),
    }


def run_d2(device: str = "cuda") -> dict:
    import torch

    from nerf_sampling_tpu_torch.kernels import fused_hier, philox
    from nerf_sampling_tpu_torch.render import engine
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
    from nerf_sampling_tpu_torch.train.trainer import step_seed
    from nerf_sampling_tpu_torch.utils.precision import matmul_precision

    t0 = time.perf_counter()
    scene = example_scene()
    pipes = {impl: recipe_pipeline(impl) for impl in ("cuda", "plain")}
    p = pipes["cuda"]
    params = engine.pack_kernel_weights(load_render_params(CKPT, p, device), with_hier=True)
    hier = params.kernels.hier
    fine = params.fine
    sampler = RaySampler(scene, SamplerConfig(N_rand=D2_RAYS), seed=0)
    rng = np.random.default_rng(0)
    nd = p.N_samples + p.N_importance

    def k6(rays, seed=None, draws=None):
        return fused_hier.fused_render_hier(
            hier, params.coarse.cfg, fine.cfg, rays.rays_o, rays.rays_d, n_coarse=p.N_samples,
            n_importance=p.N_importance, near=p.near, far=p.far, white_bkgd=p.white_bkgd, lindisp=p.lindisp,
            seed=seed, draws=draws, multires=p.multires, multires_views=p.multires_views)

    def loss_of(depth_z, max_z, acc):
        se = (depth_z - max_z) ** 2
        fg = (acc > 0.5).to(se.dtype)
        return float(torch.mean(fg * se)), float(torch.sum(fg * se) / torch.clamp(fg.sum(), min=1.0))

    ways = {"k6_philox": [], "k6_injected": [], "plain_injected": []}
    spread = {k: [] for k in ways}
    agree = {"k6_seed_equals_k6_with_host_draws": True, "k6_inj_vs_plain_fg_abs_dz": []}
    with torch.no_grad(), matmul_precision(p.matmul_precision):
        for b in range(1, D2_BATCHES + 1):
            ro, rd, target = (torch.from_numpy(x).to(device) for x in sampler.sample(b))
            rays = engine.make_ray_batch(p, ro, rd)
            depth_z = params.depth(ro, rd)[:, 0]
            seeds = [step_seed(42, 1000 * b + j) for j in range(D2_DRAWS)]
            draws = [torch.from_numpy(rng.random((D2_RAYS, nd), dtype=np.float32)).to(device)
                     for _ in range(D2_DRAWS)]
            z = {k: [] for k in ways}
            acc_ref = None
            for j in range(D2_DRAWS):
                a = k6(rays, seed=seeds[j])
                if j == 0:
                    host = k6(rays, draws=philox.hier_draws(seeds[j], D2_RAYS, nd).to(device))
                    agree["k6_seed_equals_k6_with_host_draws"] &= bool(
                        torch.equal(a["max_z"], host["max_z"]) and torch.equal(a["acc_map"], host["acc_map"]))
                bi = k6(rays, draws=draws[j])
                pl = engine.render_rays_train(pipes["plain"], params, engine.make_ray_batch(pipes["plain"], ro, rd),
                                              None, t_rand=draws[j][:, :p.N_samples], u=draws[j][:, p.N_samples:])
                outs = {"k6_philox": (a["max_z"], a["acc_map"]), "k6_injected": (bi["max_z"], bi["acc_map"]),
                        "plain_injected": (pl["max_z_vals"][:, 0], pl["acc_map"])}
                for k, (mz, acc) in outs.items():
                    ways[k].append(loss_of(depth_z, mz, acc))
                    z[k].append(mz)
                fgm = pl["acc_map"] > 0.5
                agree["k6_inj_vs_plain_fg_abs_dz"].append(float((bi["max_z"] - pl["max_z_vals"][:, 0])[fgm].abs().mean()))
                acc_ref = pl["acc_map"] if acc_ref is None else acc_ref
            fg = acc_ref > 0.5
            for k in ways:
                sd = torch.stack(z[k]).std(0)[fg]
                spread[k].append((float(sd.median()), float(sd.mean()), float((sd ** 2).mean())))
    res = {"card": torch_r5.card(), "torch": torch.__version__, "batches": D2_BATCHES, "draws": D2_DRAWS,
           "rays": D2_RAYS, "checkpoint": CKPT, "seconds": time.perf_counter() - t0, **agree}
    res["k6_inj_vs_plain_fg_abs_dz"] = float(np.mean(agree["k6_inj_vs_plain_fg_abs_dz"]))
    for k in ways:
        losses = np.array(ways[k])
        sp = np.array(spread[k])
        res[k] = {"depth_loss_median": float(np.median(losses[:, 0])), "depth_loss_mean": float(losses[:, 0].mean()),
                  "depth_loss_fg_median": float(np.median(losses[:, 1])),
                  "target_sd_fg_median": float(np.median(sp[:, 0])), "target_sd_fg_mean": float(sp[:, 1].mean()),
                  "target_var_fg_mean": float(sp[:, 2].mean())}
    res["draws_of_a_chunk"] = draw_statistics([step_seed(42, i) for i in range(1, 101)], D2_RAYS, nd)
    res["captured_replays"] = captured_k6_replays(k6, scene, p, device) if device == "cuda" else None
    torch_r5.write_json(os.path.join(EVIDENCE, "D2", "d2.json"), res)
    print(json.dumps(res, indent=1))
    return res


D1B_NERFS = {  # scripts/r5_100k.sh's NeRF pretrain (torch_r5.py A1's), on the kernels and on plain fp32
    "nerf_cuda": ["--mlp_impl", "cuda", "--precision", "high", "--seed", "0"],
    "nerf_plain": ["--mlp_impl", "plain", "--precision", "highest", "--seed", "0"],
    "nerf_cuda_highest": ["--mlp_impl", "cuda", "--precision", "highest", "--seed", "0"],
    "nerf_cuda_seed1": ["--mlp_impl", "cuda", "--precision", "high", "--seed", "1"],
}


def target_stats(ckpt: str, device: str = "cuda", batches: int = D2_BATCHES, draws: int = D2_DRAWS) -> dict:
    """K6's depth targets of a checkpoint's NeRFs on the example scene's
    train batches: each fg ray's target spread over ``draws`` Philox seeds,
    the fg share, and the depth loss of the checkpoint's DepthNet (the
    recipe's, background weight 0) and its fg part."""
    import torch

    from nerf_sampling_tpu_torch.kernels import fused_hier
    from nerf_sampling_tpu_torch.render import engine
    from nerf_sampling_tpu_torch.train.checkpoint import load_render_params
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
    from nerf_sampling_tpu_torch.train.trainer import step_seed

    scene = example_scene()
    p = recipe_pipeline("cuda")
    params = engine.pack_kernel_weights(load_render_params(ckpt, p, device), with_hier=True)
    sampler = RaySampler(scene, SamplerConfig(N_rand=D2_RAYS), seed=0)
    sd, fg_frac, loss, loss_fg, wide = [], [], [], [], []
    with torch.no_grad():
        for b in range(1, batches + 1):
            ro, rd, _ = (torch.from_numpy(x).to(device) for x in sampler.sample(b))
            depth_z = params.depth(ro, rd)[:, 0]
            zs, accs = [], []
            for j in range(draws):
                h = fused_hier.fused_render_hier(
                    params.kernels.hier, params.coarse.cfg, params.fine.cfg, ro, rd, n_coarse=p.N_samples,
                    n_importance=p.N_importance, near=p.near, far=p.far, white_bkgd=p.white_bkgd,
                    lindisp=p.lindisp, seed=step_seed(42, 1000 * b + j), multires=p.multires,
                    multires_views=p.multires_views)
                zs.append(h["max_z"])
                accs.append(h["acc_map"])
                fg = (h["acc_map"] > 0.5).float()
                se = (depth_z - h["max_z"]) ** 2
                loss.append(float(torch.mean(fg * se)))
                loss_fg.append(float(torch.sum(fg * se) / fg.sum().clamp(min=1)))
            fg = torch.stack(accs).mean(0) > 0.5
            spread = torch.stack(zs).std(0)[fg]
            sd.append(float(spread.median()))
            wide.append(float((spread > 0.1).float().mean()))
            fg_frac.append(float(fg.float().mean()))
    return {"checkpoint": ckpt, "batches": batches, "draws": draws, "target_sd_fg_median": float(np.median(sd)),
            "fg_share_target_sd_over_0.1": float(np.mean(wide)), "fg_frac": float(np.mean(fg_frac)),
            "depth_loss_median": float(np.median(loss)), "depth_loss_fg_median": float(np.median(loss_fg))}


def run_d1b(device: str = "cuda", nerf_iters: int = 20000, depth_iters: int = D1_ITERS) -> None:
    """The port's own NeRF pretrain (A1's command; the same on plain fp32,
    at --precision highest and at seed 1), the D1 recipe (cuda, auto K)
    against each, and K6's targets of each beside the committed NeRF's
    (``target_stats``). An arm whose depth run has its evidence runs its
    pretrain again (deterministic: the same NeRF) and nothing else, which
    leaves its NeRF under ``logs/torch_parity/D1b/<arm>/`` for ``haze``."""
    out_dir = os.path.join(EVIDENCE, "D1b")
    path = os.path.join(out_dir, "targets.json")
    stats = torch_r5.read_json(path) if os.path.exists(path) else {}
    if "committed" not in stats:
        stats["committed"] = target_stats(CKPT, device)
    for name, flags in D1B_NERFS.items():
        base = f"{LOGS}/D1b/{name}"
        shutil.rmtree(base, ignore_errors=True)
        nerf_argv = ["-d", "example", "--mode", "nerf", "--n_iters", str(nerf_iters), "-ip", "2000",
                     "--testskip", "1", "--basedir", base] + flags
        done = os.path.exists(os.path.join(out_dir, name, "depth", "step.json"))
        for tag in ("nerf",) if done else ("nerf", "depth"):
            if tag == "nerf":
                argv = nerf_argv
            else:  # against the pretrain's newest checkpoint, as torch_r5.py's A1 picks it
                newest = sorted(glob.glob(os.path.join(base, "example_nerf", "[0-9]*.npz")))[-1]
                argv = d1_argv("cuda_auto", newest, depth_iters)
                argv[argv.index("--basedir") + 1] = f"{base}/depth"
            if device != "cuda":
                argv = argv + ["--device", device]
            rec = torch_r5.execute("run", argv)
            d = os.path.join(out_dir, name, tag)
            os.makedirs(d, exist_ok=True)
            for f in ("args.txt", "psnr.txt", "metrics.jsonl"):
                src = os.path.join(rec["expdir"], f)
                if os.path.exists(src):
                    with open(os.path.join(d, f), "w") as fh:
                        fh.write(torch_r5._relative_text(src))
            for q in sorted(glob.glob(os.path.join(rec["expdir"], "testset_*", "psnr.txt"))):
                os.makedirs(os.path.join(d, os.path.basename(os.path.dirname(q))), exist_ok=True)
                shutil.copy(q, os.path.join(d, os.path.basename(os.path.dirname(q)), "psnr.txt"))
            torch_r5.write_json(os.path.join(d, "step.json"), rec)
        if done:
            continue
        stats[name] = target_stats(sorted(glob.glob(os.path.join(base, "depth", "example_depth_net",
                                                                 "depth_*.npz")))[-1], device)
        rows = logged(os.path.join(out_dir, name, "depth", "psnr.txt"))
        stats[name]["depth_run_logged"] = medians(rows)
        torch_r5.write_json(path, stats)
    torch_r5.write_json(path, stats)
    print(json.dumps(stats, indent=1))


def nerf_haze(ckpt: str, batches: int = 4, device: str = "cpu") -> dict:
    """What a NeRF checkpoint offers the DepthNet's one-point render (the
    plain fp32 fine NeRF, as the depth step queries it) on the example
    scene's train batches, from the plain hierarchical pass at fixed
    draws: on fg rays (acc > 0.5) the share of fine samples in front of
    the target (z < max_z - 0.1) with positive raw density, whose one-point
    render is the point's own colour and not the white background; the same
    on bg rays (acc < 0.1); the weight at the argmax; and the one-point
    render's MSE against the pixel at max_z and at max_z -+ 0.05."""
    import torch

    from nerf_sampling_tpu_torch.core.compositing import raw2outputs
    from nerf_sampling_tpu_torch.core.sampling import z_to_points
    from nerf_sampling_tpu_torch.models import NeRF
    from nerf_sampling_tpu_torch.render import engine
    from nerf_sampling_tpu_torch.train import checkpoint as ck
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig

    p = recipe_pipeline("plain")
    sds = ck.params_from_jax(ck.read_npz_tree(ckpt)[0]["params"])
    nets = {}
    for k, cfg in (("coarse", p.nerf), ("fine", p.fine)):
        nets[k] = NeRF(cfg).to(device)
        nets[k].load_state_dict({n: v.float() for n, v in sds[k].items()})
    params = engine.NeRFParams(nets["coarse"], nets["fine"], None)
    sampler = RaySampler(example_scene(), SamplerConfig(N_rand=D2_RAYS), seed=0)
    acc_fg, rows = [], {k: [] for k in ("front_pos", "front_sigma", "bg_pos", "max_w", "mse_at", "mse_before",
                                        "mse_behind")}
    with torch.no_grad():
        for b in range(1, batches + 1):
            ro, rd, target = (torch.from_numpy(x).to(device) for x in sampler.sample(b))
            rays = engine.make_ray_batch(p, ro, rd)
            g = torch.Generator(device=device).manual_seed(b)
            hier = engine.sample_as_in_nerf(p, params, rays, g)
            max_z, _, max_w = engine._argmax_depth(hier.fine, hier.fine_z_vals, rays)
            acc = hier.fine.acc_map
            fg, bg = acc > 0.5, acc < 0.1
            sigma = hier.fine_raw[..., 3]
            front = (hier.fine_z_vals < max_z - 0.1) & fg[:, None]
            rows["front_pos"].append(float((sigma[front] > 0).float().mean()))
            rows["front_sigma"].append(float(torch.relu(sigma[front]).mean()))
            rows["bg_pos"].append(float((sigma[bg] > 0).float().mean()) if bool(bg.any()) else float("nan"))
            rows["max_w"].append(float(max_w[fg].median()))
            for key, dz in (("mse_at", 0.0), ("mse_before", -0.05), ("mse_behind", 0.05)):
                z = max_z + dz
                raw = engine.query_fine_or_coarse(p, params, z_to_points(ro, rd, z), rays)
                rgb = raw2outputs(raw, z, rd, 0.0, p.white_bkgd).rgb_map
                rows[key].append(float(((rgb - target) ** 2)[fg].mean()))
            acc_fg.append(float(fg.float().mean()))
    out = {k: float(np.nanmean(v)) for k, v in rows.items()}
    return {"checkpoint": ckpt, "batches": batches, "fg_frac": float(np.mean(acc_fg)), **out}


def captured_k6_replays(k6, scene, p, device) -> dict:
    """One K6 launch captured with its seed in device memory, replayed with
    the seeds of a chunk's steps: each replay against an eager launch at
    that seed (bit for bit), and no two replays alike."""
    import torch

    from nerf_sampling_tpu_torch.render import engine
    from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
    from nerf_sampling_tpu_torch.train.trainer import step_seed

    ro, rd, _ = (torch.from_numpy(x).to(device) for x in RaySampler(scene, SamplerConfig(N_rand=D2_RAYS),
                                                                       seed=0).sample(1))
    rays = engine.make_ray_batch(p, ro, rd)
    word = torch.zeros((), dtype=torch.int32, device=device)
    seeds = [step_seed(42, i) for i in range(1, 9)]
    word.fill_(seeds[0])
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        k6(rays, seed=word)
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = k6(rays, seed=word)
    equal, replays = [], []
    for s in seeds:
        word.fill_(s)
        graph.replay()
        got = out["max_z"].clone()
        replays.append(got)
        equal.append(bool(torch.equal(got, k6(rays, seed=s)["max_z"])))
    distinct = all(not torch.equal(replays[i], replays[i + 1]) for i in range(len(replays) - 1))
    return {"replays": len(seeds), "each_equals_eager_at_its_seed": all(equal), "consecutive_replays_differ": distinct}


def example_scene():
    """The example scene as the Trainer loads it (400x400 on white)."""
    from nerf_sampling_tpu_torch.data.blender import load_blender_data
    from nerf_sampling_tpu_torch.data.example import maybe_generate_example_dataset
    from nerf_sampling_tpu_torch.definitions import DATASET_DIR

    datadir = os.path.join(DATASET_DIR, "example")
    maybe_generate_example_dataset("example", datadir)
    scene = load_blender_data(datadir, half_res=True, testskip=1)
    scene.composite_white_background()
    return scene


def recipe_pipeline(mlp_impl: str):
    """The D1 recipe's pipeline (``recommended_depth_net_module`` with run.py's overrides)."""
    import dataclasses

    from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.utils.config import load_trainer_config

    cfg = load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    return dataclasses.replace(cfg.pipeline(with_depth=True), mlp_impl=mlp_impl)


# ---------------------------------------------------------------- D3 (CPU): both Trainers

LOCK_RTOL = 1e-3  # D3 lockstep: a step's loss departs past this relative difference
LOCK_WTOL = 1e-3  # ... or a net's weights past this share of their norm
NETS = {"depth_net": ("depth",), "nerf": ("coarse", "fine"), "joint": ("coarse", "fine", "depth")}


def jax_on_cpu():
    """The JAX package's modules on the CPU backend (set before any JAX computation)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def draws_from_key(key, n: int, n_coarse: int, n_importance: int, mode: str):
    """The draws the JAX step of ``mode`` takes on its XLA path from its
    step key (``fold_in(PRNGKey(seed), i)``): the depth and joint steps
    split the key and hand the first half to ``sample_as_in_nerf``, the
    nerf step hands it the key; ``sample_as_in_nerf`` splits that in four
    and draws t_rand from the first and u from the third."""
    import torch

    jax = jax_on_cpu()
    from nerf_sampling_tpu_torch.train.steps import StepDraws

    if mode in ("depth_net", "joint"):
        key, _ = jax.random.split(key)
    k_strat, _, k_pdf, _ = jax.random.split(key, 4)
    return StepDraws(torch.from_numpy(np.array(jax.random.uniform(k_strat, (n, n_coarse)))),
                     torch.from_numpy(np.array(jax.random.uniform(k_pdf, (n, n_importance)))))


def flat_nets(tree: dict, nets) -> dict[str, np.ndarray]:
    """{net: its parameters as one fp32 vector} of a JAX-layout parameter tree."""
    jax = jax_on_cpu()
    return {n: np.concatenate([np.ravel(np.asarray(x, np.float32)) for x in jax.tree.leaves(tree[n])])
            for n in nets}


class Recorder:
    """What a Trainer's ``log`` sees at each step: the metrics, every
    ``every``-th step's (and each eval step's) weights, the eval PSNRs."""

    def __init__(self, nets, every: int):
        self.nets, self.every = nets, every
        self.metrics: dict[int, dict[str, float]] = {}
        self.weights: dict[int, dict[str, np.ndarray]] = {}
        self.evals: dict[int, float] = {}

    def take(self, trainer, i: int, metrics: dict, tree_of) -> None:
        self.metrics[i] = {k: float(v) for k, v in metrics.items()}
        if i % trainer.cfg.i_testset == 0:
            self.evals[i] = float(trainer._avg_eval_psnr)
        if i % self.every == 0 or i % trainer.cfg.i_testset == 0:
            self.weights[i] = flat_nets(tree_of(trainer), self.nets)


def configs(kw: dict):
    """(port TrainerConfig, JAX TrainerConfig) of the same fields, the port
    on the plain fp32 path and JAX on its XLA path."""
    jax_on_cpu()
    from nerf_sampling_tpu.utils.config import TrainerConfig as JTrainerConfig
    from nerf_sampling_tpu_torch.utils.config import TrainerConfig

    port = TrainerConfig(**{**kw, "mlp_impl": "plain"})
    return port, JTrainerConfig(**{**dataclasses.asdict(port), "mlp_impl": "xla"})


def run_jax(cfg, n_iters: int, every: int = 10) -> Recorder:
    """The JAX Trainer for steps 1 .. n_iters on the CPU, recorded."""
    jax_on_cpu()
    from nerf_sampling_tpu.train import trainer as jtrainer

    rec = Recorder(NETS[cfg.train_mode], every)

    class Recorded(jtrainer.Trainer):
        def log(self, i, metrics, state, timer=None):
            super().log(i, metrics, state, timer)
            rec.take(self, i, metrics, lambda t: t.params._asdict())

    Recorded(cfg).train(N_iters=n_iters + 1)
    return rec


def run_port(cfg, n_iters: int, every: int = 10, inject: bool = True) -> Recorder:
    """The port's Trainer on the CPU for steps 1 .. n_iters, recorded. It
    starts from the JAX Trainer's weights for the seed (``core/prng.py``);
    with ``inject`` every step takes the draws the JAX step of the same
    index takes (``draws_from_key``), through wrappers of the step makers
    that look the step up from its seed."""
    jax = jax_on_cpu()
    from nerf_sampling_tpu_torch.train import checkpoint as ck
    from nerf_sampling_tpu_torch.train import trainer as ttrainer

    rec = Recorder(NETS[cfg.train_mode], every)
    p = cfg.pipeline()
    step_of = {ttrainer.step_seed(cfg.seed, i): i for i in range(1, n_iters + 1)}
    base = jax.random.PRNGKey(cfg.seed)

    def injecting(maker):
        def make(*a, **k):
            step = maker(*a, **k)

            def run(*args):
                i = step_of[args[-1]]
                n = args[-2][0].shape[0]
                return step(*args, draws=draws_from_key(jax.random.fold_in(base, i), n, p.N_samples,
                                                        p.N_importance, cfg.train_mode))
            return run
        return make

    def tree_of(t):
        sds = {k: getattr(t.params, k).state_dict() for k in ("coarse", "fine", "depth")
               if getattr(t.params, k) is not None}
        return ck.params_to_jax(sds)

    class Recorded(ttrainer.Trainer):
        def log(self, i, metrics, timer=None):
            super().log(i, metrics, timer)
            rec.take(self, i, metrics, tree_of)

    makers = {n: getattr(ttrainer, n) for n in ("make_depth_net_train_step", "make_nerf_train_step",
                                                 "make_joint_train_step")}
    try:
        if inject:
            for n, m in makers.items():
                setattr(ttrainer, n, injecting(m))
        Recorded(cfg, device="cpu").train(N_iters=n_iters + 1)
    finally:
        for n, m in makers.items():
            setattr(ttrainer, n, m)
    return rec


def compare(port: Recorder, ref: Recorder, cadences: dict[str, int] | None = None) -> dict:
    """Per step: the loss's relative difference, and at each recorded step
    each net's weight difference over its norm; eval PSNR differences; the
    first step past ``LOCK_RTOL`` / ``LOCK_WTOL`` and the cadences it falls on."""
    steps = sorted(set(port.metrics) & set(ref.metrics))
    loss_rel = {i: abs(port.metrics[i]["loss"] - ref.metrics[i]["loss"]) / max(abs(ref.metrics[i]["loss"]), 1e-12)
                for i in steps}
    depth_rel = {i: abs(port.metrics[i]["depth_net_loss"] - ref.metrics[i]["depth_net_loss"])
                 / max(abs(ref.metrics[i]["depth_net_loss"]), 1e-12)
                 for i in steps if "depth_net_loss" in ref.metrics[i] and "depth_net_loss" in port.metrics[i]}
    w_rel = {}
    for i in sorted(set(port.weights) & set(ref.weights)):
        w_rel[i] = {n: float(np.linalg.norm(port.weights[i][n] - ref.weights[i][n])
                             / max(np.linalg.norm(ref.weights[i][n]), 1e-12)) for n in ref.weights[i]}
    first_loss = next((i for i in steps if loss_rel[i] > LOCK_RTOL), None)
    first_w = next((i for i in sorted(w_rel) if max(w_rel[i].values()) > LOCK_WTOL), None)
    evals = {i: {"port": port.evals[i], "jax": ref.evals[i], "delta": port.evals[i] - ref.evals[i]}
             for i in sorted(set(port.evals) & set(ref.evals))}
    first = min((x for x in (first_loss, first_w) if x is not None), default=None)

    def on(i):
        return [] if i is None or not cadences else [k for k, c in cadences.items() if c and i % c == 0]

    return {"steps": len(steps), "loss_rel_max": max(loss_rel.values(), default=0.0),
            "depth_net_loss_rel_max": max(depth_rel.values(), default=None),
            "weights_rel_final": w_rel[max(w_rel)] if w_rel else None,
            "weights_rel_max": {n: max(w[n] for w in w_rel.values()) for n in (w_rel[min(w_rel)] if w_rel else {})},
            "first_loss_departure": first_loss, "first_weight_departure": first_w,
            "first_departure": first, "departure_on_cadence": on(first),
            "evals": evals, "loss_rel": {str(i): loss_rel[i] for i in steps},
            "weights_rel": {str(i): w for i, w in w_rel.items()}}


def lockstep(kw: dict, n_iters: int, every: int = 10, warmup: int = 0) -> dict:
    """Both Trainers on one config in lockstep (module docstring): the JAX
    run, then the port's with its draws."""
    port_cfg, jax_cfg = configs(kw)
    port_cfg = dataclasses.replace(port_cfg, basedir=os.path.join(kw["basedir"], "port"))
    jax_cfg = dataclasses.replace(jax_cfg, basedir=os.path.join(kw["basedir"], "jax"))
    ref = run_jax(jax_cfg, n_iters, every)
    port = run_port(port_cfg, n_iters, every)
    out = compare(port, ref, {"i_testset": port_cfg.i_testset, "i_weights": port_cfg.i_weights,
                              "i_print": port_cfg.i_print})
    if warmup and out["first_departure"] is not None and out["first_departure"] >= warmup:
        out["departure_on_cadence"].append("after the warmup handover")
    out["port"], out["jax"] = port, ref
    return out


# D3's reduced widths (the CPU's): 4x64 NeRFs and DepthNet, 256 rays, 32 + 32 samples
D3_NETS = dict(netdepth=4, netwidth=64, netdepth_fine=4, netwidth_fine=64, n_layers=4, layer_width=64,
               sphere_radius=2.0, N_samples=32, N_importance=32, N_rand=256, lrate=5e-4, lrate_decay=500,
               depth_net_lr=1e-4, bg_depth_loss_weight=0.0, matmul_precision="highest", export_torch_ckpt=False,
               keep_best=True, i_print=100, i_video=10**6, testskip=1)
D3_LOCK_STEPS, D3_DIST_STEPS, D3_SEEDS, D3_FULL_STEPS = 1000, 2000, (0, 1, 2), 200
D3_ARMS = ("nerf", "depth", "joint", "llff_depth", "deepvoxels_depth", "depth_full")


def d3_scenes() -> dict[str, dict]:
    """The generated scenes of D3's arms, as Trainer config fields."""
    from nerf_sampling_tpu_torch.data import example

    root = os.path.join(LOGS, "D3", "scenes")
    made = {
        "blender": (example.generate_example_dataset, dict(H=64, W=64, n_train=30, n_val=1, n_test=4)),
        "llff": (example.generate_example_llff_dataset, dict(H=48, W=64, n_images=16)),
        "deepvoxels": (example.generate_example_deepvoxels_dataset, dict(n_train=30, n_val=1, n_test=1)),
    }
    for name, (gen, kw) in made.items():
        if not os.path.exists(os.path.join(root, name)):
            gen(os.path.join(root, name), **kw)
    return {
        "blender": dict(dataset_type="blender", datadir=os.path.join(root, "blender"), half_res=False,
                        white_bkgd=True, no_batching=True, sampling_mode="uniform", n_depth_samples=64, distance=1.0),
        "llff": dict(dataset_type="llff", datadir=os.path.join(root, "llff"), factor=1, llffhold=8, white_bkgd=False,
                     sampling_mode="gaussian", n_depth_samples=64, distance=0.25),
        "deepvoxels": dict(dataset_type="deepvoxels", datadir=os.path.join(root, "deepvoxels"), shape="cube",
                           white_bkgd=False, sampling_mode="uniform", n_depth_samples=64, distance=1.0),
    }


def jax_nerf(scene: dict, steps: int, basedir: str, seed: int = 0) -> str:
    """A frozen NeRF for a depth arm: the JAX Trainer's nerf run (its own
    draws), its newest checkpoint."""
    port_cfg, jax_cfg = configs(dict(D3_NETS, **scene, train_mode="nerf", basedir=basedir, expname="nerf",
                                     seed=seed, i_weights=steps, i_testset=steps, precrop_iters=500,
                                     precrop_frac=0.5))
    path = os.path.join(basedir, "nerf", f"{steps:06d}.npz")
    if not os.path.exists(path):
        run_jax(jax_cfg, steps, every=steps)
    return path


def committed_fp32(path: str) -> str:
    """The committed checkpoint in fp32 (JAX keeps a file's fp16 dtype)."""
    from nerf_sampling_tpu_torch.train import checkpoint as ck

    tree, step = ck.read_npz_tree(CKPT)
    sds = {k: {n: v.float() for n, v in sd.items()} for k, sd in ck.params_from_jax(tree["params"]).items()}
    ck.save_checkpoint(path, {"params": ck.JaxNeRFParams(**ck.params_to_jax(sds))}, step)
    return path


def d3_lockstep(arm: str) -> dict:
    """One D3 arm in lockstep (seed 0); its comparison, per-step series kept."""
    sc = d3_scenes()
    base = os.path.join(LOGS, "D3", "lock", arm)
    shutil.rmtree(base, ignore_errors=True)
    cad = dict(i_testset=500, i_weights=500)
    steps, warmup = D3_LOCK_STEPS, 0
    if arm == "nerf":
        kw = dict(D3_NETS, **sc["blender"], **cad, train_mode="nerf", precrop_iters=500, precrop_frac=0.5)
    elif arm == "depth":
        kw = dict(D3_NETS, **sc["blender"], **cad, train_mode="depth_net",
                  ft_path=jax_nerf(sc["blender"], 1000, os.path.join(LOGS, "D3", "nerf_blender")))
    elif arm == "joint":
        warmup = 200
        kw = dict(D3_NETS, **sc["blender"], **cad, train_mode="joint", joint_depth_warmup=warmup)
    elif arm == "llff_depth":
        kw = dict(D3_NETS, **sc["llff"], **cad, train_mode="depth_net",
                  ft_path=jax_nerf(sc["llff"], 1000, os.path.join(LOGS, "D3", "nerf_llff")))
    elif arm == "deepvoxels_depth":
        kw = dict(D3_NETS, **sc["deepvoxels"], **cad, train_mode="depth_net",
                  ft_path=jax_nerf(sc["deepvoxels"], 1000, os.path.join(LOGS, "D3", "nerf_deepvoxels")))
    else:  # depth_full: the committed checkpoint's widths and NeRFs, the recipe's batch, no eval
        from nerf_sampling_tpu_torch.data.example import maybe_generate_example_dataset
        from nerf_sampling_tpu_torch.definitions import DATASET_DIR

        datadir = os.path.join(DATASET_DIR, "example")
        maybe_generate_example_dataset("example", datadir)
        os.makedirs(base, exist_ok=True)
        kw = dict(D3_NETS, dataset_type="blender", datadir=datadir, half_res=True, white_bkgd=True, no_batching=True,
                  netdepth=8, netwidth=256, netdepth_fine=8, netwidth_fine=256, n_layers=10, layer_width=256,
                  N_rand=1024, N_samples=64, N_importance=128, train_mode="depth_net", i_testset=10**6,
                  i_weights=10**6, i_print=10, ft_path=committed_fp32(os.path.join(base, "committed_fp32.npz")))
        steps = D3_FULL_STEPS
    kw.update(basedir=base, expname=arm, seed=0)
    t0 = time.time()
    out = lockstep(kw, steps, every=10, warmup=warmup)
    port, ref = out.pop("port"), out.pop("jax")
    out.update(arm=arm, steps_run=steps, seconds=time.time() - t0,
               config={k: v for k, v in kw.items() if k not in ("basedir", "datadir")},
               depth_net_loss={str(i): [port.metrics[i].get("depth_net_loss"), ref.metrics[i].get("depth_net_loss")]
                               for i in sorted(ref.metrics) if i % 100 == 0 and "depth_net_loss" in ref.metrics[i]})
    torch_r5.write_json(os.path.join(EVIDENCE, "D3", f"lockstep_{arm}.json"), out)
    return out


def d3_dist(pkg: str, seed: int, out_name: str = "dist") -> dict:
    """D3 in distribution: a nerf run from scratch by ``pkg`` ("port" or
    "jax") at ``seed`` with its own draws, then the port's depth run
    against that NeRF (the step D1 holds sound), and K6's plain targets of
    the NeRF: whether a package's pretrain makes the DepthNet's targets."""
    sc = d3_scenes()["blender"]
    base = os.path.join(LOGS, "D3", out_name, f"{pkg}_{seed}")
    shutil.rmtree(base, ignore_errors=True)
    steps = D3_DIST_STEPS
    port_cfg, jax_cfg = configs(dict(D3_NETS, **sc, train_mode="nerf", basedir=os.path.join(base, "nerf_run"),
                                     expname="nerf", seed=seed, i_weights=steps, i_testset=500, precrop_iters=500,
                                     precrop_frac=0.5))
    nerf = run_jax(jax_cfg, steps, every=steps) if pkg == "jax" else run_port(port_cfg, steps, every=steps,
                                                                               inject=False)
    ft = os.path.join(base, "nerf_run", "nerf", f"{steps:06d}.npz")
    dcfg, _ = configs(dict(D3_NETS, **sc, train_mode="depth_net", basedir=os.path.join(base, "depth_run"),
                           expname="depth", seed=0, ft_path=ft, i_weights=steps, i_testset=500))
    depth = run_port(dcfg, steps, every=steps, inject=False)
    out = {"pkg": pkg, "seed": seed, "nerf_evals": nerf.evals,
           "nerf_loss": {str(i): m["loss"] for i, m in nerf.metrics.items() if i % 100 == 0},
           "depth_evals": depth.evals,
           "depth_net_loss": {str(i): m["depth_net_loss"] for i, m in depth.metrics.items() if i % 100 == 0},
           "depth_loss_fg": {str(i): m["depth_loss_fg"] for i, m in depth.metrics.items() if i % 100 == 0},
           "fg_frac": {str(i): m["fg_frac"] for i, m in depth.metrics.items() if i % 100 == 0}}
    torch_r5.write_json(os.path.join(EVIDENCE, "D3", out_name, f"{pkg}_{seed}.json"), out)
    return out


D3_DIST_DEPTH = {"llff_depth": ("llff", "nerf_llff"), "deepvoxels_depth": ("deepvoxels", "nerf_deepvoxels")}


def d3_dist_depth(arm: str, pkg: str, seed: int) -> dict:
    """D3 in distribution for a depth arm D1 does not drive (NDC, the
    30-view DeepVoxels scene): ``pkg``'s Trainer trains a DepthNet from
    ``seed`` against the lockstep arm's JAX NeRF with its own draws."""
    scene, nerf_dir = D3_DIST_DEPTH[arm]
    sc = d3_scenes()[scene]
    ft = jax_nerf(sc, 1000, os.path.join(LOGS, "D3", nerf_dir))
    base = os.path.join(LOGS, "D3", f"dist_{arm}", f"{pkg}_{seed}")
    shutil.rmtree(base, ignore_errors=True)
    steps = D3_DIST_STEPS
    port_cfg, jax_cfg = configs(dict(D3_NETS, **sc, train_mode="depth_net", basedir=base, expname="depth",
                                     seed=seed, ft_path=ft, i_weights=steps, i_testset=500))
    rec = run_jax(jax_cfg, steps, every=steps) if pkg == "jax" else run_port(port_cfg, steps, every=steps,
                                                                              inject=False)
    out = {"pkg": pkg, "seed": seed, "depth_evals": rec.evals,
           "depth_net_loss": {str(i): m["depth_net_loss"] for i, m in rec.metrics.items() if i % 100 == 0},
           "depth_loss_fg": {str(i): m["depth_loss_fg"] for i, m in rec.metrics.items() if i % 100 == 0}}
    torch_r5.write_json(os.path.join(EVIDENCE, "D3", f"dist_{arm}", f"{pkg}_{seed}.json"), out)
    return out


def d3_bands(port_dir: str = "dist", jax_dir: str = "dist") -> dict:
    """The port's mean against the JAX seeds' band at every logged point:
    mean +- max(2 std, 0.1 dB) for evals, +- max(2 std, 20%) for the
    median-like depth losses; an arm departs at two points in a row."""
    runs = {pkg: [torch_r5.read_json(p) for p in sorted(glob.glob(os.path.join(EVIDENCE, "D3", d, f"{pkg}_*.json")))]
            for pkg, d in (("port", port_dir), ("jax", jax_dir))}
    out = {"port_runs": port_dir, "jax_runs": jax_dir, "seeds": {k: [r["seed"] for r in v] for k, v in runs.items()}}
    for series, kind in (("nerf_evals", "db"), ("depth_evals", "db"), ("depth_net_loss", "rel"),
                         ("depth_loss_fg", "rel"), ("nerf_loss", "rel")):
        if not runs["port"] or not runs["jax"] or series not in runs["jax"][0]:
            continue
        points = sorted(set.intersection(*[set(r[series]) for r in runs["port"] + runs["jax"]]), key=int)
        rows, run_out, first = [], 0, None
        for pt in points:
            j = np.array([r[series][pt] for r in runs["jax"]])
            q = np.array([r[series][pt] for r in runs["port"]])
            half = max(2 * j.std(), 0.1 if kind == "db" else 0.2 * abs(j.mean()))
            outside = abs(q.mean() - j.mean()) > half
            run_out = run_out + 1 if outside else 0
            if run_out == 2 and first is None:
                first = int(pt)
            rows.append({"step": int(pt), "jax_mean": float(j.mean()), "jax_std": float(j.std()),
                         "port_mean": float(q.mean()), "port_std": float(q.std()), "half_band": float(half),
                         "outside": bool(outside)})
        out[series] = {"points": rows, "departs_at": first}
    name = "bands.json" if port_dir == "dist" else f"bands_{port_dir}.json"
    torch_r5.write_json(os.path.join(EVIDENCE, "D3", name), out)
    return out


def run_d3(parallel: int = 4, parts: list[str] | None = None) -> None:
    """Every D3 part (or ``parts``) in its own process, ``parallel`` at a
    time; the blender NeRF of the depth arm is made first. A part is
    ``lock:ARM``, ``dist:PKG:SEED[:DIR]`` or ``distdepth:ARM:PKG:SEED``."""
    import subprocess

    d3_scenes()
    jax_nerf(d3_scenes()["blender"], 1000, os.path.join(LOGS, "D3", "nerf_blender"))
    parts = parts or [f"lock:{a}" for a in D3_ARMS] + [f"dist:{pkg}:{s}" for s in D3_SEEDS for pkg in ("port", "jax")]
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=2")
    running, logs = [], os.path.join(LOGS, "D3", "part_logs")
    os.makedirs(logs, exist_ok=True)
    for part in parts:
        while len(running) >= parallel:
            running = [r for r in running if r.poll() is None]
            time.sleep(5)
        with open(os.path.join(logs, part.replace(":", "_") + ".log"), "w") as f:
            running.append(subprocess.Popen([sys.executable, __file__, "d3part", part], stdout=f,
                                            stderr=subprocess.STDOUT, env=env))
    for r in running:
        r.wait()
    print(json.dumps(d3_summary(), indent=1))


def d3_part(part: str) -> None:
    import torch

    torch.set_num_threads(2)
    kind, *rest = part.split(":")
    if kind == "lock":
        d3_lockstep(rest[0])
    elif kind == "distdepth":
        d3_dist_depth(rest[0], rest[1], int(rest[2]))
    else:
        d3_dist(rest[0], int(rest[1]), *rest[2:])


def d3_summary() -> dict:
    out = {"lockstep": {}, "bands": d3_bands()}
    if glob.glob(os.path.join(EVIDENCE, "D3", "dist_repaired", "port_*.json")):
        out["bands_repaired"] = d3_bands("dist_repaired")
    for arm in D3_DIST_DEPTH:
        if glob.glob(os.path.join(EVIDENCE, "D3", f"dist_{arm}", "port_*.json")):
            out[f"bands_{arm}"] = d3_bands(f"dist_{arm}", f"dist_{arm}")
    for p in sorted(glob.glob(os.path.join(EVIDENCE, "D3", "lockstep_*.json"))):
        r = torch_r5.read_json(p)
        out["lockstep"][r["arm"]] = {k: r[k] for k in (
            "steps", "loss_rel_max", "depth_net_loss_rel_max", "weights_rel_final", "first_loss_departure",
            "first_weight_departure", "first_departure", "departure_on_cadence", "evals", "seconds")}
    torch_r5.write_json(os.path.join(EVIDENCE, "D3", "summary.json"), out)
    return out


def summary() -> dict:
    """Every experiment's figures from ``evidence/torch_parity/`` in one
    file: D1's verdict and its later run, D1b's targets and haze, D2, D3."""
    def load(*parts):
        path = os.path.join(EVIDENCE, *parts)
        return torch_r5.read_json(path) if os.path.exists(path) else None

    tpu = medians(logged(os.path.join(REPO, TPU_D1, "psnr.txt")))
    later = {}
    for d in sorted(glob.glob(os.path.join(EVIDENCE, "D1_*", "*", "psnr.txt"))):
        rows = logged(d)
        later[os.path.relpath(os.path.dirname(d), EVIDENCE)] = {
            "at_tpu_steps": medians(rows, range(1000, 10001, 1000)), "all_logged": medians(rows)}
    verdict = load("D1", "verdict.json")
    out = {"tpu_d1": tpu, "d1_verdict": verdict and verdict.get("verdict"),
           "d1": verdict and {a: {k: v[k] for k in ("at_tpu_steps", "ratio_to_tpu", "evals")}
                              for a, v in verdict["arms"].items()},
           "d1_later": later, "d1b_targets": load("D1b", "targets.json"), "d1b_haze": load("D1b", "haze.json"),
           "d2": load("D2", "d2.json"), "d3": d3_summary()}
    torch_r5.write_json(os.path.join(EVIDENCE, "summary.json"), out)
    return out


# ---------------------------------------------------------------- CLI


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd in ("run", "gate"):
        sp = sub.add_parser(cmd)
        sp.add_argument("arm", choices=["D1", "D1b", "D2", "D3"])
        sp.add_argument("--n_iters", type=int, default=None, help="D1: a shorter run (a rehearsal)")
        sp.add_argument("--device", default="cuda", help="D1/D2: cpu for a rehearsal")
        sp.add_argument("--out", default="D1", help="D1: the evidence directory's name")
        sp.add_argument("--arms", default=",".join(D1_ARMS), help="D1: the arms to run, comma-separated")
        sp.add_argument("--parts", default=None, help="D3: the parts to run, comma-separated (run_d3)")
    sub.add_parser("summary", help="write evidence/torch_parity/summary.json")
    sub.add_parser("haze", help="nerf_haze of NeRF checkpoints (CPU)").add_argument("ckpt", nargs="+")
    sub.add_parser("d3part", help=argparse.SUPPRESS).add_argument("part")
    args = ap.parse_args(argv)
    os.chdir(REPO)
    if args.cmd == "run":
        if args.arm == "D1":
            run_d1(args.n_iters or D1_ITERS, args.device, args.out, tuple(args.arms.split(",")))
        elif args.arm == "D1b":
            run_d1b(args.device, **({} if args.n_iters is None else {"nerf_iters": args.n_iters,
                                                                      "depth_iters": args.n_iters}))
        elif args.arm == "D2":
            run_d2(args.device)
        else:
            run_d3(parts=args.parts.split(",") if args.parts else None)
        return 0
    if args.cmd == "haze":
        path = os.path.join(EVIDENCE, "D1b", "haze.json")
        out = torch_r5.read_json(path) if os.path.exists(path) else {}
        for c in args.ckpt:
            out[c] = nerf_haze(c)
            print(json.dumps(out[c]), flush=True)
            torch_r5.write_json(path, out)
        return 0
    if args.cmd == "d3part":
        d3_part(args.part)
        return 0
    if args.cmd == "gate":
        if args.arm != "D1":
            raise SystemExit("gate takes D1 (the other experiments report, they do not gate)")
        return 0 if gate_d1() else 1
    out = summary()
    print(json.dumps({k: out[k] for k in ("tpu_d1", "d1_verdict", "d1_later")}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
