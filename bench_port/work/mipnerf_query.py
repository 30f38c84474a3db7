"""One full mip-NeRF query: the trunk and density head, the bottleneck,
net_depth_condition layers of net_width_condition over the bottleneck and
the view encoding (3 + 6 deg_view columns), the rgb head. At mip-NeRF's
widths: 610,304 multiply-adds."""

from bench_port.work import mipnerf_density


def macs(net: dict) -> int:
    W, Wc = net["net_width"], net["net_width_condition"]
    views = 3 + 6 * net["deg_view"]
    cond = (W + views) * Wc + (net["net_depth_condition"] - 1) * Wc * Wc
    return mipnerf_density.trunk_macs(net) + W * W + cond + Wc * 3


def params(net: dict) -> int:
    """Weights and biases read by one launch."""
    return macs(net) + (net["net_depth"] + 1) * net["net_width"] + 1 + net["net_depth_condition"] * \
        net["net_width_condition"] + 3


def work(net: dict, n: float, passes: int) -> tuple[float, float]:
    return 2.0 * macs(net) * n * passes, 2.0 * params(net)
