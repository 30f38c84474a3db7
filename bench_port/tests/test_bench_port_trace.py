"""The trace reader on a hand-made trace: overlapping operations count once, gaps are named."""

import pytest

from bench_port.metrics_common import idle_pct, mfu, roofline
from bench_port.trace import read, union


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_read_takes_the_union_and_names_gaps():
    events = [
        ev("bench_port.slice", "user_annotation", 0, 1000),
        ev("bench_port.engine", "user_annotation", 0, 300),
        ev("bench_port.to_host", "user_annotation", 300, 400),
        ev("k2", "kernel", 100, 200),  # 100-300
        ev("k1", "kernel", 150, 100),  # inside k2: counts once
        ev("memcpy", "gpu_memcpy", 600, 50),  # 600-650
        ev("late", "kernel", 990, 100),  # clipped to 990-1000
        ev("outside", "kernel", 2000, 10),
        ev("host_op", "cpu_op", 0, 1000),
    ]
    r = read(events)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx((200 + 50 + 10) * 1e-6)
    assert r["device_ops"][0] == ["k2", pytest.approx(200e-6)]
    assert {n for n, _ in r["device_ops"]} == {"k2", "k1", "memcpy", "late"}
    gaps = dict((round(s * 1e6), n) for n, s in r["idle_gaps"])
    assert gaps == {100: "bench_port.engine", 300: "bench_port.to_host", 340: "bench_port.to_host"}


def test_shares():
    run = {"trace": {"window_s": 1.0, "busy_s": 0.5}, "slice_units": 10, "unit_flops": 989e11 / 10,
           "unit_bytes": 1.0}
    assert roofline(run) == pytest.approx(20.0)
    assert mfu(run) == pytest.approx(10.0)
    assert idle_pct(run) == pytest.approx(50.0)
    assert roofline({**run, "trace": None}) is None
    assert mfu({**run, "slice_units": 0}) is None
