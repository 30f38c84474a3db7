"""K11's model work in the traced slice at the card's bound over its device time (%): the
intervals it queried at each level (the program's ``nst.mip.coarse_rows`` and
``nst.mip.fine_rows``) times ``work/mipnerf_density.py``'s and ``work/mipnerf_query.py``'s
multiply-adds at the widths of the run's own configuration (``run["mipnerf"]``, which the
``render_mipnerf`` driver passes on), the weights read once a launch and each ray's 48 bytes
in and out; the bound the larger of the FLOPs at the bf16 peak and the bytes at the memory
rate; the time the launches' device ms (``nst.mip.kernel_ms``). None where the program counts
none of them or the run names no mip-NeRF widths."""

from bench_port.harness import BF16_PEAK_FLOPS, HBM_BYTES_PER_S
from bench_port.work import io, mipnerf_density, mipnerf_query
from nerf_sampling_tpu_torch.utils import profiling


def read(run: dict) -> float | None:
    table = profiling.recorded() if hasattr(profiling, "recorded") else {}
    ms, coarse, fine = (table.get(f"nst.mip.{k}", {}) for k in ("kernel_ms", "coarse_rows", "fine_rows"))
    net = run.get("mipnerf")
    if not (net and ms.get("calls") and ms.get("total") and coarse.get("total") and fine.get("total")):
        return None
    launches = ms["calls"]
    f_c, b_c = mipnerf_density.work(net, coarse["total"], 1)
    f_f, b_f = mipnerf_query.work(net, fine["total"], 1)
    _, b_io = io.work(net, coarse["total"] / net["num_samples"], 48)
    bound = max((f_c + f_f) / BF16_PEAK_FLOPS, (launches * (b_c + b_f) + b_io) / HBM_BYTES_PER_S)
    return 100.0 * bound / (ms["total"] / 1e3)
