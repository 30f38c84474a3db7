"""The frames' model work in the traced slice at the card's bound, over the time a
device operation ran there (%): the bound is the larger of the FLOPs at the bf16 peak
and the bytes at the memory rate."""

from bench_port.metrics_common import roofline


def read(run: dict) -> float | None:
    return roofline(run)
