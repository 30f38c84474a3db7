"""The window's milliseconds over the train steps completed in it (a step counts once
its chunk's metrics are on the host; host clock)."""


def read(run: dict) -> float | None:
    return 1e3 * run["window_s"] / run["units"] if run["units"] else None
