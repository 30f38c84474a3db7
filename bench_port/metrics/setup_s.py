"""Seconds from the process's start to the start of the window (host clock)."""


def read(run: dict) -> float | None:
    return run["setup_s"]
