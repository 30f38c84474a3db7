"""The arithmetic that the trace-based per-layer readers share."""

from __future__ import annotations

from bench_port.harness import BF16_PEAK_FLOPS, HBM_BYTES_PER_S


def _traced(run: dict) -> dict | None:
    t = run.get("trace")
    return t if t and t["window_s"] > 0 and run.get("slice_units") else None


def roofline(run: dict) -> float | None:
    t = _traced(run)
    if t is None or t["busy_s"] <= 0:
        return None
    n = run["slice_units"]
    bound = max(n * run["unit_flops"] / BF16_PEAK_FLOPS, n * run["unit_bytes"] / HBM_BYTES_PER_S)
    return 100.0 * bound / t["busy_s"]


def idle_pct(run: dict) -> float | None:
    t = _traced(run)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run: dict) -> float | None:
    t = _traced(run)
    return None if t is None else 100.0 * run["slice_units"] * run["unit_flops"] / (t["window_s"] * BF16_PEAK_FLOPS)
