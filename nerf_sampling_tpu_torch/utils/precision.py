"""The fp32 matrix-product precision of the plain path.

The JAX package sets its XLA path's matmul precision per dot
(``--precision``: "highest", "high" or "default"). In PyTorch it is global
state, so the port applies the Pipeline's ``matmul_precision`` in a scope
(``matmul_precision``) around each plain-path train step and render, and
restores what was there before. The names map onto torch's settings:

- "highest": strict fp32 (no TF32), the reference and the kernels' oracle;
- "high": TF32 products (about three decimal digits) on the card;
- "default": torch's "medium", which may also use bf16 products.

The kernels ignore the setting: their precision is their type, and their
plain versions (the oracles) always run in strict fp32 (``strict_fp32``).
"""

import contextlib
from typing import Iterator

import torch

# the --precision names of the JAX CLI -> torch.set_float32_matmul_precision
MATMUL_PRECISIONS = {"highest": "highest", "high": "high", "default": "medium"}

PRECISION_HELP = (
    "fp32 matmul precision of the plain path (the JAX XLA path's): highest = strict fp32, "
    "high = TF32, default = torch's 'medium' (TF32 or bf16 products); the kernels ignore it."
)


def strict_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN: the plain path is the fp32 reference
    and the kernels' oracle, and TF32 keeps only about three decimal digits.

    Set through ``torch.set_float32_matmul_precision``: setting
    ``torch.backends.cuda.matmul.allow_tf32`` after it mixes torch's two
    APIs, and ``torch.get_float32_matmul_precision`` then raises."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False


def check_precision(name: str) -> str:
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {sorted(MATMUL_PRECISIONS)}, got {name!r}")
    return name


@contextlib.contextmanager
def matmul_precision(name: str) -> Iterator[None]:
    """Run the enclosed code at the ``name`` precision, then restore the
    global matmul and cuDNN settings as they were."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(MATMUL_PRECISIONS[check_precision(name)])
    torch.backends.cudnn.allow_tf32 = name != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
