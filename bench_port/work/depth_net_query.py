"""One DepthNet query (the reference sampler's DepthNet).

Three towers of n_layers layers of width w over the embedded origin,
direction (3 channels each) and the two sphere intersections (6 channels),
each layer fed its tower's embedding again (the direction tower's skip
sized by the origin's embedding, as in the reference); a trunk of
n_layers layers over the towers' outputs and the three embeddings; a depth
head. At 10x256 with 10 frequencies: 3,330,304 multiply-adds.
"""


def macs(net: dict) -> int:
    L, w, f = net["n_layers"], net["layer_width"], 1 + 2 * net["multires"]
    eo, ed, ei = 3 * f, 3 * f, 6 * f
    towers = 0
    for emb, skip in ((eo, eo), (ed, eo), (ei, ei)):
        towers += 2 * emb * w + (L - 1) * (w + skip) * w
    trunk = (3 * w + eo + ed + ei) * w + (L - 1) * w * w
    return towers + trunk + w


def params(net: dict) -> int:
    return macs(net) + (4 * net["n_layers"]) * net["layer_width"] + 1


def work(net: dict, n: float, passes: int) -> tuple[float, float]:
    return 2.0 * macs(net) * n * passes, 2.0 * params(net)
