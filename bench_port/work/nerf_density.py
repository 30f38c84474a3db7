"""One density-only NeRF query: the trunk and the density head (the coarse
net in a render, whose rgb no output reads). At 8x256: 491,264
multiply-adds."""

from bench_port.work import nerf_query


def macs(net: dict) -> int:
    return nerf_query.trunk_macs(net)


def params(net: dict) -> int:
    return macs(net) + net["D"] * net["W"] + 1


def work(net: dict, n: float, passes: int) -> tuple[float, float]:
    return 2.0 * macs(net) * n * passes, 2.0 * params(net)
