"""Host milliseconds a train step in the host sampler (``RaySampler.sample`` for the
next chunk; bench_port's spans)."""


def read(run: dict) -> float | None:
    return 1e3 * run["spans"].total("sampler") / run["units"] if run["units"] else None
