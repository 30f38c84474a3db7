"""The port's in-program recorder (utils/profiling.py) and the trace reader.

- Off (no profiler), a dispatcher chunk and the sampler record nothing and
  open no ``record_function`` range.
- Under torch.profiler on the CPU, a tiny ``StepDispatcher`` chunk of the
  plain NeRF step and a ``RaySampler`` record ``nst.dispatch.run`` and its
  children with the right counts, self time equal to the duration less the
  children's, the phase spans of each eager step, and ``nst.*`` ranges in
  the exported Chrome trace nested inside ``nst.dispatch.run``; ``trace``
  writes the table to ``spans.json``; only ``reset`` (and ``trace``, which
  calls it) clears it. An untimed step on the card records no phase.
- ``read_trace`` takes the union of overlapping device operations, names
  idle gaps by the ``nst.*`` span the host was in, reads ``train_chunk``
  spans where there are no ``train_step`` ones and returns ``spans.json``.
- On the card (marked ``card``; skipped here): after the captures and
  three replays of the depth step, every phase's device time is positive,
  the phases sum to the step's, ``queued_steps`` lies in [0, K], the timed
  graph's replays give the plain graph's metrics bit for bit, and the
  step's time lies within 5% of a replay's in the profiler's trace (first
  kernel to last). The file imports no JAX, so the card can run it:
  ``python -m pytest --noconftest -m card tests/test_torch_tracing.py``.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from nerf_sampling_tpu_torch.data.types import SceneData
from nerf_sampling_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_sampling_tpu_torch.render.engine import Pipeline
from nerf_sampling_tpu_torch.train.dispatch import StepDispatcher
from nerf_sampling_tpu_torch.train.sampler import RaySampler, SamplerConfig
from nerf_sampling_tpu_torch.train.state import init_nerf_state, nerf_modules
from nerf_sampling_tpu_torch.train.steps import make_nerf_train_step
from nerf_sampling_tpu_torch.utils import profiling

K, N = 3, 16
PHASES = ("forward", "backward", "adam")


def tiny_nerf_step():
    """A dispatcher over the plain NeRF step of 2x16 nets on the CPU."""
    torch.manual_seed(0)
    net = NeRFConfig(D=2, W=16, input_ch=15, input_ch_views=9, output_ch=5, skips=(), use_viewdirs=True)
    pipe = Pipeline(nerf=net, fine=net, multires=2, multires_views=1, N_samples=4, N_importance=4)
    state = init_nerf_state(nerf_modules(NeRF(net), NeRF(net)))
    step = make_nerf_train_step(pipe)
    return StepDispatcher(lambda batch, s: step(state, batch, s)[1], [state], "cpu")


def stack(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    o = np.tile([0.0, 0.0, 4.0], (K, N, 1)) + 0.1 * rng.standard_normal((K, N, 3))
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    return np.concatenate([o, d, rng.random((K, N, 3))], -1).astype(np.float32)


def sampler() -> RaySampler:
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 4.0
    scene = SceneData(images=np.random.default_rng(1).random((2, 8, 8, 3)).astype(np.float32), poses=poses,
                      render_poses=poses[:1], hwf=(8, 8, 10.0), i_train=np.arange(2), i_val=np.arange(0),
                      i_test=np.arange(0), near=2.0, far=6.0)
    return RaySampler(scene, SamplerConfig(N_rand=N), seed=0)


def chunk(dispatcher: StepDispatcher, s: RaySampler) -> dict:
    for i in range(K):
        s.sample(i)
    return dispatcher.read(dispatcher.run(stack(), [1, 2, 3]))


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    real, opened = torch.autograd.profiler.record_function, []

    def opening(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", opening)
    profiling.reset()
    chunk(tiny_nerf_step(), sampler())
    assert profiling.recorded() == {} and not [n for n in opened if n.startswith("nst.")]
    assert not profiling.recording()


def test_spans_counts_and_self_time_under_the_profiler(tmp_path):
    dispatcher, s = tiny_nerf_step(), sampler()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chunk(dispatcher, s)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    t = profiling.recorded()
    calls = {name: e["calls"] for name, e in t.items()}
    assert calls == {"nst.dispatch.run": 1, "nst.dispatch.upload": 1, "nst.dispatch.read": 1,
                     "nst.sampler.sample": K, **{f"nst.step.{p}": K for p in PHASES}}
    run = t["nst.dispatch.run"]
    children = ["nst.dispatch.upload"] + [f"nst.step.{p}" for p in PHASES]
    assert run["child_seconds"] == pytest.approx(sum(t[c]["seconds"] for c in children), rel=1e-9)
    assert run["self_seconds"] == pytest.approx(run["seconds"] - run["child_seconds"], rel=1e-9)
    assert 0 < run["self_seconds"] < run["seconds"]
    for name in children + ["nst.sampler.sample", "nst.dispatch.read"]:
        assert t[name]["self_seconds"] == pytest.approx(t[name]["seconds"]) and t[name]["seconds"] > 0
    with open(tmp_path / "trace.json") as fp:
        events = [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X" and e["name"].startswith("nst.")]
    names = [e["name"] for e in events]
    assert names.count("nst.dispatch.run") == 1 and names.count("nst.sampler.sample") == K
    outer = next(e for e in events if e["name"] == "nst.dispatch.run")
    inner = [e for e in events if e["name"] in children]
    assert len(inner) == 1 + K * len(PHASES)
    assert all(outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] for e in inner)


def test_reset_and_a_new_window_clear_the_table(tmp_path):
    """Only ``reset`` clears the table, and ``trace`` calls it as its
    window opens; a bare profiler window adds to what is there."""
    dispatcher, s = tiny_nerf_step(), sampler()
    profiling.reset()
    profiling.count("nst.test", 1)  # off: nothing added
    assert profiling.recorded() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        chunk(dispatcher, s)
        assert profiling.recorded()["nst.dispatch.run"]["calls"] == 1
        profiling.reset()
        assert profiling.recorded() == {}
        profiling.count("nst.test", 2)
        profiling.count("nst.test", 3)
        assert profiling.recorded() == {"nst.test": {"calls": 2, "total": 5}}
    assert profiling.recorded() == {"nst.test": {"calls": 2, "total": 5}}  # kept after the window
    s.sample(0)  # off: nothing added, the window closed
    assert profiling.recorded() == {"nst.test": {"calls": 2, "total": 5}}
    with profile(activities=[ProfilerActivity.CPU]):
        s.sample(0)
    assert profiling.recorded()["nst.test"] == {"calls": 2, "total": 5}  # a bare window keeps it
    assert profiling.recorded()["nst.sampler.sample"]["calls"] == 1
    with profiling.trace(str(tmp_path)):
        s.sample(0)
    assert profiling.recorded() == {"nst.sampler.sample": profiling.recorded()["nst.sampler.sample"]}


@pytest.mark.parametrize("on", [False, True])
def test_an_untimed_step_on_the_card_records_no_phase(monkeypatch, on):
    """A step on the card that is not timed (the plain capture of a graph,
    an eager step with no profiler) records no event and adds nothing to
    the table; under a profiler its phases are bare ranges."""
    real, opened = torch.autograd.profiler.record_function, []

    def opening(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", opening)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) if on else contextlib.nullcontext():
        with profiling.step_phases("cuda", timed=False) as clock:
            for name in PHASES:
                with profiling.phase(name):
                    pass
    assert clock is None and profiling.recorded() == {}
    assert [n for n in opened if n.startswith("nst.")] == ([f"nst.step.{p}" for p in PHASES] if on else [])
    with profiling.step_phases("cpu") as clock:  # off the card a marker is a span
        with profiling.phase("forward"):
            pass
    assert clock is None and profiling.recorded() == {}


def test_trace_writes_the_table_beside_the_trace(tmp_path):
    dispatcher, s = tiny_nerf_step(), sampler()
    with profiling.trace(str(tmp_path)):
        with record_function("train_chunk"):
            out = dispatcher.run(stack(), [1, 2, 3])
        dispatcher.read(out)
    with open(tmp_path / profiling.SPANS_FILE) as fp:
        spans = json.load(fp)
    assert spans["nst.dispatch.run"]["calls"] == 1 and spans["nst.step.forward"]["calls"] == K
    summary = profiling.read_trace(str(tmp_path / profiling.TRACE_FILE))
    assert summary["span"] == "train_chunk" and summary["steps"] == 1 and summary["spans"] == spans
    assert summary["device_idle"] == 1.0 and summary["idle_gaps"][0][1] == summary["window_ms"]


def ev(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def test_read_trace_takes_the_union_of_overlapping_kernels(tmp_path):
    events = [
        ev("train_chunk", "user_annotation", 0, 1000),
        ev("nst.dispatch.run", "user_annotation", 0, 400),
        ev("nst.dispatch.launch", "user_annotation", 100, 50),
        ev("nst.sampler.sample", "user_annotation", 500, 400),
        ev("k_a", "kernel", 120, 200),  # 120-320
        ev("k_b", "kernel", 200, 300),  # 200-500: overlaps k_a
        ev("copy", "gpu_memcpy", 700, 100),  # 700-800
        ev("late", "kernel", 950, 150),  # began inside the window: it ends it at 1100
        ev("after", "kernel", 1200, 10),
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    s = profiling.read_trace(str(tmp_path / "trace.json"), top=3)
    assert s["span"] == "train_chunk" and s["steps"] == 1 and s["spans"] is None
    assert s["window_ms"] == pytest.approx(1.1)
    assert s["kernel_ms"] == pytest.approx(0.53)  # 120-500 and 950-1100, not 0.65 summed
    assert s["busy_ms"] == pytest.approx(0.63)
    assert s["device_idle"] == pytest.approx(1 - 0.63 / 1.1)
    assert s["kernels"] == {"k_a": pytest.approx(0.2), "k_b": pytest.approx(0.3), "late": pytest.approx(0.15)}
    assert s["idle_gaps"] == [("nst.sampler.sample", pytest.approx(0.2)), ("nst.sampler.sample", pytest.approx(0.15)),
                              ("nst.dispatch.run", pytest.approx(0.12))]
    # with launch calls, an operation counts by the call that launched it
    for e, c in zip(events[4:], (1, 2, 3, 4, 5)):
        e["args"] = {"correlation": c}
    events += [dict(ev("cudaGraphLaunch", "cuda_runtime", 900, 5), args={"correlation": 5}),
               dict(ev("cudaLaunchKernel", "cuda_runtime", 1005, 5), args={"correlation": 4})]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    s = profiling.read_trace(str(tmp_path / "trace.json"), top=3)
    assert set(s["kernels"]) == {"after"} and s["busy_ms"] == pytest.approx(0.01)
    assert s["window_ms"] == pytest.approx(1.21)
    with pytest.raises(ValueError, match="no 'other' spans"):
        profiling.read_trace(str(tmp_path / "trace.json"), span="other")


# ----------------------------------------------------------------------------- card


def sphere_rays(n: int, rng: np.random.Generator) -> np.ndarray:
    """[n, 9] rows: origins at radius 4, directions through the unit ball, random targets."""
    o = rng.standard_normal((n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, rng.random((n, 3))], -1).astype(np.float32)


def depth_dispatcher(dev: torch.device) -> StepDispatcher:
    """A dispatcher over the depth step at the reference's widths (K6 on
    the card), from the same weights at every call."""
    import dataclasses

    from nerf_sampling_tpu_torch.definitions import REFERENCE_CONFIG
    from nerf_sampling_tpu_torch.models import DepthNet
    from nerf_sampling_tpu_torch.render.engine import NeRFParams, make_nerf_slices, pack_kernel_weights
    from nerf_sampling_tpu_torch.train.state import init_state
    from nerf_sampling_tpu_torch.train.steps import make_depth_net_train_step
    from nerf_sampling_tpu_torch.utils.config import load_trainer_config

    cfg = load_trainer_config(REFERENCE_CONFIG, "recommended_depth_net_module")
    cfg.n_layers, cfg.layer_width, cfg.sphere_radius = 10, 256, 2
    pipe = dataclasses.replace(cfg.pipeline(with_depth=True), mlp_impl="cuda")
    torch.manual_seed(0)
    params = NeRFParams(NeRF(pipe.nerf).to(dev), NeRF(pipe.fine).to(dev), DepthNet(pipe.depth).to(dev))
    frozen = pack_kernel_weights(params._replace(depth=None), with_hier=True)
    make_nerf_slices(frozen.kernels)
    state = init_state(params.depth.requires_grad_(True))
    step = make_depth_net_train_step(pipe, frozen)
    return StepDispatcher(lambda batch, s: step(state, batch, s)[1], [state], dev)


@pytest.mark.card
def test_captured_phases_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the phase events are graph nodes of a captured step")
    dev = torch.device("cuda")
    dispatcher, twin = depth_dispatcher(dev), depth_dispatcher(dev)
    rng = np.random.default_rng(0)
    k = 4
    chunks = [(np.stack([sphere_rays(1024, rng) for _ in range(k)]), list(range(i0, i0 + k)))
              for i0 in (1, 1 + k, 1 + 2 * k)]

    # the eager first step, the captures and 3 replays, under the host-side
    # profiler (no CUPTI: the launches and the queue as with no profiler)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = dispatcher.read(dispatcher.run(*chunks[0]))
    t = profiling.recorded()
    assert dispatcher.graphs == 1 and t["nst.dispatch.replays"]["total"] == k - 1
    assert t["nst.dispatch.launch"]["calls"] == k - 1 and t["nst.dispatch.first_step"]["calls"] == 1
    assert 0 <= t["nst.dispatch.queued_steps"]["total"] <= k
    names = ("oracle", "forward", "backward", "adam")
    assert {n: t[f"nst.step.{n}"]["calls"] for n in names + ("total",)} == dict.fromkeys(names + ("total",), 2)
    phases = {n: t[f"nst.step.{n}"]["total"] for n in names}  # the eager step's and the last replay's
    assert all(ms > 0 for ms in phases.values()), phases
    assert sum(phases.values()) == pytest.approx(t["nst.step.total"]["total"], rel=0.01)

    # the timed graph computes what the plain one does: a twin from the same
    # weights, run with no profiler (its first step untimed, then plain
    # replays), gives the same metrics bit for bit, chunk after chunk
    for i, c in enumerate(chunks[:2]):
        if i:
            with profile(activities=[ProfilerActivity.CPU]):
                got = dispatcher.read(dispatcher.run(*c))
        want = twin.read(twin.run(*c))
        assert all(np.array_equal(got[n], want[n]) for n in want), (got, want)
    assert twin.graphs == 1

    # off: nothing added to the table
    before = profiling.recorded()
    dispatcher.read(dispatcher.run(*chunks[1]))
    assert profiling.recorded() == before

    # a chunk of replays alone, traced on the device: the last replay's phases
    # against the device's time per replay in the trace, first operation to
    # last (the events time the device's clock, gaps between kernels included)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("train_chunk"):
            out = dispatcher.run(*chunks[2])
        dispatcher.read(out)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    t = profiling.recorded()
    phases = {n: t[f"nst.step.{n}"]["total"] for n in names}
    total = t["nst.step.total"]["total"]
    summary = profiling.read_trace(str(tmp_path / "trace.json"))
    busy = summary["busy_ms"] / k
    with open(tmp_path / "trace.json") as fp:
        ops = [e for e in json.load(fp)["traceEvents"] if e.get("cat") == "kernel" and e.get("ph") == "X"]
    span = (max(e["ts"] + e["dur"] for e in ops) - min(e["ts"] for e in ops)) / 1e3 / k
    print(f"phases {phases}, total {total:.4f} ms; in the trace, a replay's {span:.4f} ms first kernel to last, "
          f"{busy:.4f} ms busy; queued {t['nst.dispatch.queued_steps']['total']} of {k}")
    assert t["nst.step.total"]["calls"] == 1 and t["nst.dispatch.replays"]["total"] == k
    assert all(ms > 0 for ms in phases.values()), phases
    assert sum(phases.values()) == pytest.approx(total, rel=0.01)
    assert 0 <= t["nst.dispatch.queued_steps"]["total"] <= k
    assert total == pytest.approx(span, rel=0.05)
