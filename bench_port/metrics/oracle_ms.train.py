"""Device milliseconds a train step in the depth step's oracle pass (K6), from the step's first
marker on (the batch's preparation before it is in no phase): the program's
``nst.step.oracle`` phase, timed by CUDA events inside the captured step, from the last
replay of each chunk of the traced slice. None where the program times no such phase."""

from nerf_sampling_tpu_torch.utils import profiling


def read(run: dict) -> float | None:
    table = profiling.recorded() if hasattr(profiling, "recorded") else {}
    phase = table.get("nst.step.oracle", {})
    return phase["total"] / phase["calls"] if phase.get("calls") and "total" in phase else None
