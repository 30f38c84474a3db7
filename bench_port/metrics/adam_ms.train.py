"""Device milliseconds a train step in the Adam update and what follows it to the step's end (the
NeRF step's PSNR): the program's ``nst.step.adam`` phase, timed by CUDA events inside the
captured step, from the last replay of each chunk of the traced slice. None where the program
times no such phase."""

from nerf_sampling_tpu_torch.utils import profiling


def read(run: dict) -> float | None:
    table = profiling.recorded() if hasattr(profiling, "recorded") else {}
    phase = table.get("nst.step.adam", {})
    return phase["total"] / phase["calls"] if phase.get("calls") and "total" in phase else None
