"""Host milliseconds a train step inside ``StepDispatcher.run`` (the replays' enqueue;
bench_port's spans)."""


def read(run: dict) -> float | None:
    return 1e3 * run["spans"].total("dispatch") / run["units"] if run["units"] else None
