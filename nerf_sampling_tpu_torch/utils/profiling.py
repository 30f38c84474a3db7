"""Step-rate accounting, the profiler window, the in-program recorder and NaN checks
(nerf_sampling_tpu/utils/profiling.py).

- ``StepTimer`` counts steps and, where it reads the clock, first waits
  for the device (``torch.cuda.synchronize``): PyTorch returns before a
  CUDA step finishes, so an unsynchronized clock measures the enqueue.
- ``trace`` profiles the enclosed steps with torch.profiler (the host's
  aten ops and Python functions, and on the card its kernels by name) into
  ``<logdir>/trace.json``, a Chrome trace, and the recorder's table beside
  it as ``spans.json``; ``read_trace`` sums one up: the device's busy and
  idle share over the ``train_step`` (or ``train_chunk``) spans, taking the
  union of the device's intervals, the longest idle gaps named by the
  ``nst.*`` span the host was in, the kernels by name and the host's
  Python functions by self time.
- The recorder: ``span``, ``count`` and ``phase`` at the port's layer
  boundaries (``nst.*`` names). It is on exactly while torch.profiler
  records (the Trainer's ``profile_dir`` window, a benchmark's traced
  slice); off, each call costs one ``_profiler_enabled()`` check and opens
  no ``record_function`` range. On, a span is a ``record_function`` range
  (so the device trace can put an idle gap down to it) and adds its host
  seconds, its calls and its children's seconds to an in-memory table that
  ``recorded()`` returns; ``count`` adds to the same table, and so does
  ``device_ms`` (a block's device ms between two CUDA events, added by the
  next ``recorded()``). Only ``reset()`` clears the table; ``trace`` calls
  it as its window opens.
- ``phase`` marks the phases of a train step (``oracle``, ``forward``,
  ``backward``, ``all_reduce``, ``adam``). Inside ``step_phases`` on the
  card, where the step is timed, a marker records a timing CUDA event on
  the step's stream, external so that a CUDA graph capture keeps it as a
  node that every replay stamps; one more marks the step's end. A phase
  lasts from its marker to the next one or to the step's end, so the
  phases tile the step from its first marker on. After a host sync,
  ``PhaseClock.add`` puts each phase's device ms into the table as
  ``nst.step.<phase>``, and the step's as ``nst.step.total``. An untimed
  step on the card records no event; elsewhere a marker is a span.
- ``nan_checks`` stops at the first module output that holds a NaN, the
  port's counterpart of the JAX package's ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from collections import defaultdict
from typing import Iterable, Iterator

import torch
from torch import nn

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"


class StepTimer:
    """Steady-state throughput meter: call tick() once per step."""

    def __init__(self, rays_per_step: int, warmup: int = 10, device: torch.device | str = "cpu"):
        self.rays_per_step = rays_per_step
        self.warmup = warmup
        self.device = torch.device(device)
        self._count = 0
        self._t0: float | None = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def tick(self) -> None:
        self._count += 1
        if self._count == self.warmup:
            self._t0 = self._now()

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._count <= self.warmup:
            return 0.0
        return (self._count - self.warmup) / (self._now() - self._t0)

    def metrics(self) -> dict[str, float]:
        sps = self.steps_per_sec  # one clock read
        return {"steps_per_sec": sps, "rays_per_sec": sps * self.rays_per_step}


# ----------------------------------------------------------------- the recorder

_profiler_enabled = torch._C._autograd._profiler_enabled


class _Recorder:
    """The table and what is open in it."""

    def __init__(self):
        self.table: dict[str, dict] = {}
        self.open: list[_Span] = []  # the spans entered and not yet left, innermost last
        self.clock: PhaseClock | _Untimed | None = None  # the step on the card being run
        self.pending: list[PhaseClock] = []  # eager steps timed while on, not yet added
        self.timers: list[tuple] = []  # (name, start, end) of device_ms blocks, not yet added


_REC = _Recorder()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether the recorder is on: whether torch.profiler records now."""
    return _profiler_enabled()


def reset() -> None:
    """Clears the table (and the eager steps and device blocks not yet added); nothing else does."""
    _REC.table.clear()
    _REC.pending.clear()
    _REC.timers.clear()


def recorded() -> dict[str, dict]:
    """A copy of the table: a span's ``calls``, ``seconds``,
    ``child_seconds`` and ``self_seconds`` (its duration less its
    children's); a count's ``calls`` and ``total`` (the sum of its n).
    The ``device_ms`` blocks not yet added are added first, each once its
    end event has completed (this waits for it)."""
    timers, _REC.timers = _REC.timers, []
    for name, start, end in timers:
        end.synchronize()
        e = _REC.table.setdefault(name, {"calls": 0, "total": 0})
        e["calls"] += 1
        e["total"] += start.elapsed_time(end)
    out = {}
    for name, e in _REC.table.items():
        e = dict(e)
        if "seconds" in e:
            e["self_seconds"] = e["seconds"] - e["child_seconds"]
        out[name] = e
    return out


class _Span:
    """A ``record_function`` range; with ``table``, timed into the table too."""

    __slots__ = ("name", "table", "range", "t0", "children")

    def __init__(self, name: str, table: bool):
        self.name, self.table = name, table

    def __enter__(self):
        self.range = torch.autograd.profiler.record_function(self.name)
        self.range.__enter__()
        if self.table:
            self.children = 0.0
            _REC.open.append(self)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.table:
            dt = time.perf_counter() - self.t0
            _REC.open.remove(self)
            e = _REC.table.setdefault(self.name, {"calls": 0, "seconds": 0.0, "child_seconds": 0.0})
            e["calls"] += 1
            e["seconds"] += dt
            e["child_seconds"] += self.children
            if _REC.open:
                _REC.open[-1].children += dt
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A ``with`` block timed into the table under ``name`` while the recorder is on."""
    return _Span(name, True) if recording() else _OFF


def count(name: str, n: float = 1) -> None:
    """Adds ``n`` to the count ``name`` while the recorder is on."""
    if recording():
        e = _REC.table.setdefault(name, {"calls": 0, "total": 0})
        e["calls"] += 1
        e["total"] += n


@contextlib.contextmanager
def device_ms(name: str, device: torch.device | str) -> Iterator[None]:
    """While the recorder is on and ``device`` is a CUDA card: the device ms
    of the enclosed launches, between two timing events on the current
    stream, as one call of the count ``name``, added by the next
    ``recorded()`` (no host sync here). Otherwise nothing."""
    device = torch.device(device)
    if device.type != "cuda" or not recording():
        yield
        return
    stream = torch.cuda.current_stream(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    _REC.timers.append((name, start, end))


class PhaseClock:
    """The phase markers of one step on the card: a timing CUDA event at
    each marker and one at the step's end, recorded on the current stream,
    external, so that under a CUDA graph capture they become event-record
    nodes of the graph and each replay stamps them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.names: list[str] = []
        self.events: list[torch.cuda.Event] = []  # one per name, then the end

    def mark(self, name: str | None) -> None:
        """The marker of phase ``name``, or of the step's end (None)."""
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record(torch.cuda.current_stream(self.device))
        self.events.append(event)
        if name is not None:
            self.names.append(name)

    def ms(self) -> dict[str, float]:
        """Each phase's device ms and the step's (``total``), once the
        events have completed (after a host sync)."""
        out: dict[str, float] = {}
        for name, a, b in zip(self.names, self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        out["total"] = self.events[0].elapsed_time(self.events[-1])
        return out

    def add(self) -> None:
        """Each phase's device ms into the table as ``nst.step.<phase>``,
        while the recorder is on."""
        if self.names and recording():
            for name, ms in self.ms().items():
                count(f"nst.step.{name}", ms)


class _Untimed:
    """A step on the card whose phases are not timed: its markers record nothing."""

    def mark(self, name: str | None) -> None:
        pass


_UNTIMED = _Untimed()


@contextlib.contextmanager
def step_phases(device: torch.device | str, timed: bool | None = None) -> Iterator[PhaseClock | None]:
    """Runs the enclosed step on a CUDA ``device`` with its phases timed
    when ``timed`` (by default, while the recorder is on): yields its
    ``PhaseClock`` then, else None, and its markers record no event. An
    eager step timed while the recorder is on is added by the next
    ``settle``; a captured one's clock is its graph's, which its owner adds
    after the replay it wants read. Elsewhere a marker is a span."""
    device = torch.device(device)
    if device.type != "cuda":
        yield None
        return
    clock = PhaseClock(device) if (recording() if timed is None else timed) else None
    outer, _REC.clock = _REC.clock, clock or _UNTIMED
    try:
        yield clock
    finally:
        _REC.clock = outer
    if clock is not None and clock.names:
        clock.mark(None)
        if not torch.cuda.is_current_stream_capturing() and recording():
            _REC.pending.append(clock)


def settle() -> None:
    """Adds the phases of the eager steps timed while on (call after a host sync)."""
    pending, _REC.pending = _REC.pending, []
    for clock in pending:
        clock.add()


def phase(name: str):
    """The train step's phase ``name`` from here on. Inside
    ``step_phases`` on the card, a marker event where the step is timed
    (and, while the recorder is on, a ``nst.step.<name>`` range); elsewhere
    the span ``nst.step.<name>`` around the ``with`` block."""
    clock = _REC.clock
    if clock is None:
        return span(f"nst.step.{name}")
    clock.mark(name)
    return _Span(f"nst.step.{name}", False) if recording() else _OFF


# ------------------------------------------------------------- the profiler window


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = "cpu") -> Iterator[torch.profiler.profile]:
    """torch.profiler over the enclosed region, written to
    ``<logdir>/trace.json``, and the recorder's table of the region to
    ``<logdir>/spans.json``. It records the host's ops and, with
    ``with_stack``, its Python functions (which slows the host while it
    runs), and on a CUDA ``device`` the kernels; the device is synchronized
    before the trace closes, so that the last step's kernels (and their
    phases) are in it."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities, with_stack=True) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            settle()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    with open(os.path.join(logdir, SPANS_FILE), "w") as fp:
        json.dump(recorded(), fp, indent=1, sort_keys=True)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Disjoint sorted intervals covering the given ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(path: str, span: str = "train_step", top: int = 10) -> dict:
    """A Chrome trace of ``trace`` summed up over the window from the first
    ``span`` annotation's start to the last one's end, or to the end of the
    last device operation (kernel, copy, set) launched before then (by the
    host call its correlation id names; in a trace without them, begun
    before then); a trace without ``train_step`` spans is read over its ``train_chunk``
    ones. Returns ``span`` (the name read), ``steps`` (how many such spans),
    ``window_ms``, ``kernel_ms`` and ``busy_ms`` (the union of the kernels'
    and of every device operation's intervals: overlapping ones count
    once), ``device_idle`` (1 - busy_ms / window_ms), ``idle_gaps`` [(name,
    ms)], the ``top`` longest intervals with no device operation, each
    named by the innermost ``nst.*`` span the host was in when it began
    (else ``span``), ``kernels`` {name: ms, summed}, ``host`` [(Python
    function, self ms)], the ``top`` with the most self time: each
    function's time less that of the Python calls it made (a built-in
    method's object address dropped from its name), and ``spans``, the
    recorder's table from the ``spans.json`` beside the trace (None
    without one)."""
    with open(path) as fp:
        doc = json.load(fp)
    events = [e for e in (doc["traceEvents"] if isinstance(doc, dict) else doc)
              if e.get("ph") == "X" and "dur" in e]
    annotations = [e for e in events if e.get("cat") == "user_annotation"]
    steps = [e for e in annotations if e["name"] == span]
    if not steps and span == "train_step":
        span = "train_chunk"
        steps = [e for e in annotations if e["name"] == span]
    if not steps:
        raise ValueError(f"{path}: no {span!r} spans")
    t0 = min(e["ts"] for e in steps)
    t1 = max(e["ts"] + e["dur"] for e in steps)

    def inside(e) -> bool:
        return t0 <= e["ts"] and e["ts"] + e["dur"] <= t1

    # the operations the host launched inside the window (by the correlation
    # of each with its launch call), which the device may run after it
    calls = {e["args"]["correlation"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})}

    def launched(e) -> bool:
        c = e.get("args", {}).get("correlation")
        return c in calls if calls and c is not None else t0 <= e["ts"] <= t1

    device_ops = [e for e in events if e.get("cat") in DEVICE_CATS and launched(e)]
    t_end = max([t1] + [e["ts"] + e["dur"] for e in device_ops])
    kernels: dict[str, float] = defaultdict(float)
    for e in device_ops:
        if e["cat"] == "kernel":
            kernels[e["name"]] += e["dur"] / 1e3
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device_ops])
    kernel_busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device_ops if e["cat"] == "kernel"])
    ranges = [e for e in annotations if e["name"].startswith("nst.")]

    def host_at(t: float) -> str:
        open_ = [e for e in ranges if e["ts"] <= t < e["ts"] + e["dur"]]
        return min(open_, key=lambda e: e["dur"])["name"] if open_ else span

    gaps, last = [], t0
    for a, b in busy + [(t_end, t_end)]:
        if a > last:
            gaps.append((host_at(last), (a - last) / 1e3))
        last = max(last, b)
    gaps.sort(key=lambda g: -g[1])
    by_thread: dict = defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function" and inside(e):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    host: dict[str, float] = defaultdict(float)
    for calls in by_thread.values():
        calls.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []  # the open calls: [end, name, self time]
        for e in calls:
            while stack and stack[-1][0] <= e["ts"]:
                _, name, self_us = stack.pop()
                host[name] += self_us
            if stack:  # e is a call made by the innermost open one
                stack[-1][2] -= e["dur"]
            stack.append([e["ts"] + e["dur"], re.sub(r" at 0x[0-9a-f]+", "", e["name"]), e["dur"]])
        for _, name, self_us in stack:
            host[name] += self_us
    busy_ms = sum(b - a for a, b in busy) / 1e3
    window_ms = (t_end - t0) / 1e3
    spans_path = os.path.join(os.path.dirname(path), SPANS_FILE)
    recorder = None
    if os.path.exists(spans_path):
        with open(spans_path) as fp:
            recorder = json.load(fp)
    return {
        "span": span, "steps": len(steps), "window_ms": window_ms,
        "kernel_ms": sum(b - a for a, b in kernel_busy) / 1e3, "busy_ms": busy_ms,
        "device_idle": 1.0 - busy_ms / window_ms, "idle_gaps": gaps[:top], "kernels": dict(kernels),
        "host": sorted(((n, us / 1e3) for n, us in host.items()), key=lambda x: -x[1])[:top],
        "spans": recorder,
    }


@contextlib.contextmanager
def nan_checks(modules: Iterable[nn.Module]) -> Iterator[None]:
    """Fail loudly at the first NaN (the JAX package's
    ``enable_nan_debugging``, which sets ``jax_debug_nans``).

    PyTorch has no single switch for that: a forward hook on every
    submodule of ``modules`` raises FloatingPointError, naming the module,
    when its output holds a NaN, and autograd's anomaly mode
    (``check_nan=True``) raises RuntimeError at the backward function that
    makes one. Work outside those modules (a kernel's output, the
    compositing) is not checked op by op.

    NB: rays that miss the DepthNet's bounding sphere give NaN BY DESIGN
    (reference utils.py:159-217): enable this only on scenes whose cameras
    keep every ray inside the sphere, or when hunting a genuine numerics
    bug.
    """

    def hook(name: str):
        def check(module, inputs, output):
            if isinstance(output, torch.Tensor) and torch.isnan(output).any():
                raise FloatingPointError(f"NaN in the output of {name} ({type(module).__name__})")

        return check

    handles = []
    try:
        for m in modules:
            for name, sub in m.named_modules(prefix=type(m).__name__):
                handles.append(sub.register_forward_hook(hook(name)))
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()
