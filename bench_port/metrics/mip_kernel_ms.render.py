"""Device milliseconds a frame in K11, mip-NeRF's render kernel (one launch a frame): the
program's ``nst.mip.kernel_ms`` count, CUDA events around each launch of the traced slice.
None where the program counts no such launch."""

from nerf_sampling_tpu_torch.utils import profiling


def read(run: dict) -> float | None:
    table = profiling.recorded() if hasattr(profiling, "recorded") else {}
    k = table.get("nst.mip.kernel_ms", {})
    return k["total"] / k["calls"] if k.get("calls") and "total" in k else None
