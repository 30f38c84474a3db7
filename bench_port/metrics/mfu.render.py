"""The model FLOPs of the frames completed in the traced slice over the slice's seconds
at the bf16 peak (%)."""

from bench_port.metrics_common import mfu


def read(run: dict) -> float | None:
    return mfu(run)
