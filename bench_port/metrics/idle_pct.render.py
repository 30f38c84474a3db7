"""The share of the traced slice of a render window in which no device operation ran (%)."""

from bench_port.metrics_common import idle_pct


def read(run: dict) -> float | None:
    return idle_pct(run)
