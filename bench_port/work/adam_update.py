"""One Adam update of a float32 model: each parameter's value, gradient and two
moments read and the value and moments written, 28 bytes a parameter; its
elementwise arithmetic is not counted as model work."""

from bench_port.work import depth_net_query, nerf_query


def work(net: dict, n: float, passes: int) -> tuple[float, float]:
    params = depth_net_query.params(net) if "layer_width" in net else nerf_query.params(net)
    return 0.0, 28.0 * params * n
