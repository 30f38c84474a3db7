"""What every cell's run shares: its data files, spans, work counts, checks and result line.

A cell is found by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``); each
per-layer metric is read by ``metrics/<metric>.py``; each model part's
operations and bytes come from ``work/<part>.py``. A new cell,
configuration or metric is new files and ``BENCHMARK.json`` entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_sampling_tpu")

# the card's published dense bf16 peak and memory rate (NVIDIA H100 SXM data sheet, at 700 W); every
# share is taken against them, the DepthNet's fp32 training products too
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as fp:
        return json.load(fp)


def checkpoint(config: dict) -> dict:
    """The raw arrays of a configuration's checkpoint (a file of the
    repository, named from its root), refused unless its bytes hash to the
    configuration's ``checkpoint_sha256``."""
    from bench_port.reference.weights import read_params

    return read_params(os.path.join(ROOT, config["checkpoint"]), config["checkpoint_sha256"])


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def load_file_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (a metric's name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_port.{kind}.{name.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fp:
            btime = next(int(line.split()[1]) for line in fp if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


class Spans:
    """Host time by name, kept in memory over the whole window; each span
    is also a ``bench_port.<name>`` range in a device trace."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(f"bench_port.{name}"):
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return float(sum(self.seconds.get(name, ())))


def work(items: list, config: dict, rays_per_unit: float) -> tuple[float, float]:
    """(FLOPs, bytes) of one unit of a cell's work (a frame or a step).

    Each item is ``[part, net, per_ray, per_unit, passes]``: ``per_ray`` x
    the unit's rays + ``per_unit`` uses of model part ``work/<part>.py``
    with the widths of ``config[net]`` (``null``: none); ``passes`` counts
    the forward as 1, a backward to the inputs as 1 more and one to the
    weights as 1 more (a recompute is not counted)."""
    flops = nbytes = 0.0
    for part, net, per_ray, per_unit, passes in items:
        f, b = importlib.import_module(f"bench_port.work.{part}").work(
            config[net] if net else {}, per_ray * rays_per_unit + per_unit, passes)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: the run is correct when every
    number is finite and at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def emit(result: dict, checks: list[Check]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result line, with them under ``checks``, last."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result, checks={c.name: {"value": c.value, "limit": c.limit} for c in checks})
    print(json.dumps(result), flush=True)
