"""Host milliseconds a frame inside the render engine's entry (``render_image``), up
to its return, before the benchmark waits for the frame (bench_port's spans)."""


def read(run: dict) -> float | None:
    n = len(run["spans"].seconds.get("engine", ()))
    return 1e3 * run["spans"].total("engine") / n if n else None
