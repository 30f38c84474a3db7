"""The train steps' model work in the traced slice at the card's bound, over the time a
device operation ran there (%)."""

from bench_port.metrics_common import roofline


def read(run: dict) -> float | None:
    return roofline(run)
