"""The JAX package's random initial weights, bit for bit, in numpy.

The JAX Trainer draws its models' initial weights from
``jax.random.PRNGKey(seed)`` (threefry2x32, JAX's default generator, in its
partitionable form): ``split`` the key, then ``uniform`` per tensor
(nerf_sampling_tpu/models/common.py::linear_init). A seed's initial
weights decide much of what a run becomes: at seed 0 the JAX package's
coarse NeRF starts with an alpha-head bias near -1/16, so its density is
negative everywhere and it never trains, and the fine NeRF then learns from
samples spread over the whole ray. The port draws the same numbers here,
so that a seed means the same run in both packages.

- ``threefry2x32``: the Threefry-2x32 hash (Salmon et al., SC 2011) with
  JAX's 20 rounds and key schedule.
- ``prng_key(seed)``: ``jax.random.PRNGKey`` of an integer seed.
- ``split(key, n)``: ``jax.random.split``: key i hashes the counter (0, i).
- ``uniform(key, shape, minval, maxval)``: ``jax.random.uniform`` at fp32:
  the bits of element k (row-major) are the two words of the hash of the
  counter (0, k) xor-ed, their top 23 bits the mantissa of a float in
  [1, 2), less 1, scaled and shifted in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` [2] uint32."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, _U32) + ks[0]
        x1 = np.asarray(x1, _U32) + ks[1]
        for block in range(5):
            for r in _ROTATIONS[block % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + _U32(block + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of a seed in [0, 2^31): its high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)`` as [n, 2] uint32."""
    b0, b1 = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return np.stack([b0, b1], -1)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval, maxval) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    n = int(np.prod(shape, dtype=np.int64))
    b0, b1 = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    bits = (b0 ^ b1) >> _U32(32 - 23) | np.array(1.0, np.float32).view(_U32)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add; the
    # product is exact in fp64, and the fp64 sum rounded to fp32 gives the
    # FMA's result but at a double-rounding tie (none met in the tests)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(shape)


def linear_init(key: np.ndarray, in_features: int, out_features: int) -> tuple[np.ndarray, np.ndarray]:
    """(weight [out, in], bias [out]) of one dense layer as the JAX package's
    ``linear_init`` draws it (its weight stored [in, out], transposed
    here to torch's layout): U(-1/sqrt(in), 1/sqrt(in)) for both."""
    wkey, bkey = split(key)
    bound = np.float32(1.0) / np.sqrt(np.float32(in_features))
    weight = uniform(wkey, (in_features, out_features), -bound, bound)
    return np.ascontiguousarray(weight.T), uniform(bkey, (out_features,), -bound, bound)


def init_linears(layers) -> None:
    """Draw each (nn.Linear, key) pair's weight and bias as ``linear_init``
    does, in place."""
    with torch.no_grad():
        for lin, key in layers:
            w, b = linear_init(key, lin.in_features, lin.out_features)
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(b))
