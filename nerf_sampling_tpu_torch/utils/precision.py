"""Full-fp32 matrix products for the plain path."""

import torch


def strict_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN: the plain path is the fp32 reference
    and the kernels' oracle, and TF32 keeps only about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
