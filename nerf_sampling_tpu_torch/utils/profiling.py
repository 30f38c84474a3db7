"""Step-rate accounting, the profiler window and NaN checks
(nerf_sampling_tpu/utils/profiling.py).

- ``StepTimer`` counts steps and, where it reads the clock, first waits
  for the device (``torch.cuda.synchronize``): PyTorch returns before a
  CUDA step finishes, so an unsynchronized clock measures the enqueue.
- ``trace`` profiles the enclosed steps with torch.profiler (the host's
  aten ops and Python functions, and on the card its kernels by name) into
  ``<logdir>/trace.json``, a Chrome trace; ``read_trace`` sums one up: the
  device's busy and idle share over the ``train_step`` spans, the kernels
  by name and the host's Python functions by self time.
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


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = "cpu") -> Iterator[torch.profiler.profile]:
    """torch.profiler over the enclosed region, written to
    ``<logdir>/trace.json``. It records the host's ops and, with
    ``with_stack``, its Python functions (which slows the host while it
    runs), and on a CUDA ``device`` the kernels; the device is synchronized
    before the trace closes, so that the last step's kernels are in it."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, with_stack=True) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def read_trace(path: str, span: str = "train_step", top: int = 10) -> dict:
    """A Chrome trace of ``trace`` summed up over the window from the first
    ``span`` annotation's start to the last one's end, or to the end of the
    last kernel launched before then: ``steps`` (the spans),
    ``window_ms``, ``kernel_ms`` (device kernels, summed),
    ``device_idle`` (1 - kernel_ms / window_ms), ``kernels`` {name: ms} and
    ``host`` [(Python function, self ms)], the ``top`` with the most self
    time: each function's time less that of the Python calls it made (a
    built-in method's object address dropped from its name)."""
    with open(path) as fp:
        doc = json.load(fp)
    events = [e for e in (doc["traceEvents"] if isinstance(doc, dict) else doc)
              if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == span]
    if not steps:
        raise ValueError(f"{path}: no {span!r} spans")
    t0 = min(e["ts"] for e in steps)
    t1 = max(e["ts"] + e["dur"] for e in steps)

    def inside(e) -> bool:
        return t0 <= e["ts"] and e["ts"] + e["dur"] <= t1

    kernels: dict[str, float] = defaultdict(float)
    launched = [e for e in events if e.get("cat") == "kernel" and t0 <= e["ts"] <= t1]
    for e in launched:
        kernels[e["name"]] += e["dur"] / 1e3
    # the device finishes the last step's kernels after the host's span closes
    t_end = max([t1] + [e["ts"] + e["dur"] for e in launched])
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
    kernel_ms = sum(kernels.values())
    window_ms = (t_end - t0) / 1e3
    return {
        "steps": len(steps), "window_ms": window_ms, "kernel_ms": kernel_ms,
        "device_idle": 1.0 - kernel_ms / window_ms, "kernels": dict(kernels),
        "host": sorted(((n, us / 1e3) for n, us in host.items()), key=lambda x: -x[1])[:top],
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
