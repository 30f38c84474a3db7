"""The model FLOPs of the train steps in the traced slice, forward and backward (no
recompute), over the slice's seconds at the bf16 peak (%)."""

from bench_port.metrics_common import mfu


def read(run: dict) -> float | None:
    return mfu(run)
