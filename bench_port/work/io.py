"""A ray's own inputs and outputs: ``n`` rays of ``passes`` bytes each (the rays or
train rows in, the maps or nothing out)."""


def work(net: dict, n: float, passes: int) -> tuple[float, float]:
    return 0.0, float(n) * passes
