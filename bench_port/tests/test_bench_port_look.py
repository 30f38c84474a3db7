"""The look behind the NeRF step's first gradients runs, and K5's plain version agrees with itself on the CPU."""

import math

from bench_port.look_grads import look


def test_the_look_reads_every_counted_leaf():
    line = look(2**31 + 5, "cpu", {"size": 8, "n_train": 2, "steps_per_dispatch": 2}, {"N_rand": 32})
    per_leaf = line["per_leaf"]
    assert set(per_leaf["program"]) == set(per_leaf["witness"]) == set(line["ref_norm"])
    assert set(per_leaf["k5"]) == {k for k in line["ref_norm"] if k.startswith("fine.")}
    assert all(math.isfinite(v) for table in per_leaf.values() for pair in table.values() for v in pair)
    assert line["k5_vs_plain"]["worst_diff"] == 0.0  # on the CPU the kernel's entry runs its plain version
    assert line["k5"]["worst_diff"] < 1.0 and line["program"]["worst_diff"] < 1.0
