"""All rays of all frames completed in the window over the window's seconds (host clock)."""


def read(run: dict) -> float | None:
    return run["rays"] / run["window_s"] if run["units"] else None
