"""One NeRF query: the whole MLP at one point (density and rgb).

Multiply-adds from the configuration's widths (nerf-pytorch's NeRF): a
trunk of D layers of W (the embedded point again at the skip), the feature
and density heads, one layer of W/2 over the feature and the embedded view,
the rgb head. At 8x256 with encodings 10/4: 593,408.
"""


def trunk_macs(net: dict) -> int:
    """The trunk and the density head."""
    W, D = net["W"], net["D"]
    pts = 3 * (1 + 2 * net["multires"])
    macs = pts * W
    for i in range(1, D):
        macs += (W + (pts if i - 1 in net["skips"] else 0)) * W
    return macs + W


def macs(net: dict) -> int:
    W = net["W"]
    views = 3 * (1 + 2 * net["multires_views"])
    return trunk_macs(net) + W * W + (W + views) * (W // 2) + (W // 2) * 3


def params(net: dict) -> int:
    """Weights and biases read by one launch."""
    W = net["W"]
    return macs(net) + (net["D"] + 1) * W + 1 + W // 2 + 3


def work(net: dict, n: float, passes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of n queries: each multiply-add 2 FLOPs per pass; the
    bf16 weights read once."""
    return 2.0 * macs(net) * n * passes, 2.0 * params(net)
