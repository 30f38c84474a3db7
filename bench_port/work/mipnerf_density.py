"""One density-only mip-NeRF query: the trunk and the density head (the
first level of a render, whose rgb no output reads). A trunk of net_depth
layers of net_width over the IPE (6 columns a scale, no identity), the
IPE again after every skip_layer-th layer. At mip-NeRF's widths (8x256,
scales 0..16): 508,160 multiply-adds."""


def trunk_macs(net: dict) -> int:
    W, D, k = net["net_width"], net["net_depth"], net["skip_layer"]
    pts = 6 * (net["max_deg_point"] - net["min_deg_point"])
    macs, width = 0, pts
    for i in range(D):
        macs += width * W
        width = W + pts if (i % k == 0 and i > 0) else W
    return macs + width  # the density head


def macs(net: dict) -> int:
    return trunk_macs(net)


def params(net: dict) -> int:
    """Weights and biases read by one launch."""
    return macs(net) + net["net_depth"] * net["net_width"] + 1


def work(net: dict, n: float, passes: int) -> tuple[float, float]:
    return 2.0 * macs(net) * n * passes, 2.0 * params(net)
