"""Faults planted under the timed path, for the checks that ``correct`` must catch.

Each is a context manager that patches the program where the fault would
arise and restores it on exit:

- ``unchanged``: a train step that leaves its state as it was (the
  optimizer's update skipped);
- ``half``: half of the batch left out, the mean taken over the rest (a
  train step sees the first half of its rows; a frame's second half of rays
  is never rendered and comes back as background);
- ``altered``: an answer altered where it is produced (a train step's loss
  reported 1% high; a sixteenth of each frame's pixels 0.25 brighter).

A run on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def plant(fault: str, kind: str):
    """The patch of ``fault`` for a cell of driver ``kind`` ("render_frames" or "train_chunks")."""
    if kind == "render_frames":
        from nerf_sampling_tpu_torch.render import engine

        real = engine._fused_fast_paths

        def broken(*args, **kwargs):
            out = dict(real(*args, **kwargs))
            rgb, z, acc = (out[k].clone() for k in ("depth_net_rgb_map", "depth_net_z_vals", "depth_net_weights"))
            n = rgb.shape[0]
            if fault == "half":
                rgb[n // 2:], z[n // 2:], acc[n // 2:] = 1.0, 0.0, 0.0
            elif fault == "altered":
                rgb[: max(1, n // 16)] += 0.25
            else:
                raise ValueError(f"a render has no fault {fault!r}")
            out.update(depth_net_rgb_map=rgb, depth_net_z_vals=z, depth_net_weights=acc)
            return out

        return _patched(engine, "_fused_fast_paths", broken)
    from nerf_sampling_tpu_torch.train import dispatch, steps

    if fault == "unchanged":
        return _patched(steps, "apply_update", lambda state: None)
    if fault == "half":
        real_body = dispatch.StepDispatcher._body
        return _patched(dispatch.StepDispatcher, "_body",
                        lambda self, row, seed: real_body(self, row[: row.shape[0] // 2], seed))
    if fault == "altered":
        real_metrics = dispatch.StepDispatcher._metrics

        def metrics(self, m):
            return real_metrics(self, {k: v * 1.01 if k == "loss" else v for k, v in m.items()})

        return _patched(dispatch.StepDispatcher, "_metrics", metrics)
    raise ValueError(f"no fault {fault!r}")

