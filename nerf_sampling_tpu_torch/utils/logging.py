"""Metrics logging (nerf_sampling_tpu/utils/logging.py).

An append-only ``metrics.jsonl`` in the experiment directory, and the
``psnr.txt`` side channel of the reference (Trainer.py:389-391): every
``i_print`` line is printed and appended there in the JAX package's format.
Only ``wandb_mode="disabled"`` is ported; wandb logging is ROADMAP S5.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, logdir: str, wandb_mode: str = "disabled"):
        if wandb_mode != "disabled":
            raise NotImplementedError(
                f"wandb_mode={wandb_mode!r}: wandb logging is not ported (ROADMAP S5); "
                "use wandb_mode='disabled'"
            )
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def log(self, metrics: dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def print_line(self, info: str) -> None:
        """Print an ``Iter: ...`` line and append it to psnr.txt."""
        print(info)
        with open(os.path.join(self.logdir, "psnr.txt"), "a") as f:
            f.write(f"{info}\n")

    def close(self) -> None:
        self._jsonl.close()
