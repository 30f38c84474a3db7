"""The device trace of a bounded slice of the window, read down to the per-layer numbers.

``Tracer.slice`` runs torch.profiler (host and CUDA activities) over the
enclosed work, between two synchronizes, inside a ``bench_port.slice``
range; the trace goes to a Chrome trace file under ``TMPDIR``, is read and
deleted. ``read`` takes from it:

- the window: the slice range's start and end on the trace's clock;
- ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy, set) ran, clipped to the window, so that operations that
  overlap count once;
- ``device_ops``: device time by operation name, the most first;
- ``idle_gaps``: the longest intervals with no device operation, each
  named by the innermost ``bench_port.*`` range the host was in when it
  began.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Disjoint sorted intervals covering the given ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(events: list[dict], top: int = 10) -> dict:
    """The slice's numbers from Chrome-trace events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == "bench_port.slice"]
    if len(marks) != 1:
        raise ValueError(f"expected one bench_port.slice range in the trace, found {len(marks)}")
    t0, t1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    ops = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b > a:
                ops.append((a, b, e["name"]))
    busy = union([(a, b) for a, b, _ in ops])
    by_name: dict[str, float] = defaultdict(float)
    for a, b, name in ops:
        by_name[name] += (b - a) / 1e6
    spans = [e for e in xs if e.get("cat") == "user_annotation" and e["name"].startswith("bench_port.")
             and e["name"] != "bench_port.slice"]

    def host_at(t: float) -> str:
        inside = [e for e in spans if e["ts"] <= t < e["ts"] + e["dur"]]
        return min(inside, key=lambda e: e["dur"])["name"] if inside else "bench_port.slice"

    gaps, last = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > last:
            gaps.append((host_at(last), (a - last) / 1e6))
        last = max(last, b)
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": [[n, s] for n, s in gaps[:top]],
    }


class Tracer:
    """Profiles one slice of a run's window when enabled; ``result`` holds its numbers."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled, self.device = enabled, device
        self.result: dict | None = None

    @contextlib.contextmanager
    def slice(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        fd, path = tempfile.mkstemp(prefix="bench_port_trace_", suffix=".json")
        os.close(fd)
        try:
            with profile(activities=acts) as prof:
                self._sync()
                with record_function("bench_port.slice"):
                    yield
                    self._sync()
            prof.export_chrome_trace(path)
            with open(path) as fp:
                doc = json.load(fp)
            self.result = read(doc["traceEvents"] if isinstance(doc, dict) else doc)
        finally:
            os.remove(path)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
