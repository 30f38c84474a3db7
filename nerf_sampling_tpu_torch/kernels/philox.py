"""The kernels' random draws, reproduced on the host (csrc/philox.cuh).

K3 and K6 draw from Philox4x32-10 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011), keyed by (seed, global ray index), so a
ray's draws depend neither on the block layout nor on the other rays.
Uniforms take the top 24 bits of a word: u = (x >> 8) * 2^-24 in [0, 1).

- ``hier_draws``: K6's [N, Nc + Nf] uniforms; draw k of a ray is word
  k % 4 of the block with counter (k // 4, 0, 0, 0).
- ``gaussian_noise``: K3's [N, S - 1] standard normals; normal s of a ray is
  Box-Muller over words 0 and 1 of the block with counter (s, 1, 0, 0),
  u1 kept off 0 by half a step (nerf_sampling_tpu/kernels/ops.py:493-513).

The wrappers use these on CPU tensors, so a seed gives the same draws on
both devices; numpy's uint64 holds each 32x32-bit product exactly.
"""

from __future__ import annotations

import numpy as np
import torch

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)


def philox4x32_10(ctr: list[np.ndarray], key: list[np.ndarray]) -> list[np.ndarray]:
    """Philox4x32-10 of broadcastable uint64 arrays holding 32-bit words."""
    c = [np.asarray(x, np.uint64) & _MASK for x in ctr]
    k0, k1 = (np.asarray(x, np.uint64) & _MASK for x in key)
    for _ in range(10):
        p0, p1 = _M0 * c[0], _M1 * c[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c


def _uniform24(x: np.ndarray) -> np.ndarray:
    return (x >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)


def _keys(seed: int, n_rays: int, ray0: int) -> list[np.ndarray]:
    rays = np.arange(ray0, ray0 + n_rays, dtype=np.uint64)[:, None]
    return [np.uint64(seed & 0xFFFFFFFF), rays]


def hier_draws(seed: int, n_rays: int, n_draws: int, ray0: int = 0) -> torch.Tensor:
    """K6's uniforms [n_rays, n_draws] fp32 (t_rand, then u)."""
    k = np.arange(n_draws, dtype=np.uint64)[None, :]
    zero = np.uint64(0)
    words = philox4x32_10([k >> np.uint64(2), zero, zero, zero], _keys(seed, n_rays, ray0))
    lane = (k & np.uint64(3)).astype(np.int64)
    x = np.choose(np.broadcast_to(lane, (n_rays, n_draws)), [np.broadcast_to(w, (n_rays, n_draws)) for w in words])
    return torch.from_numpy(_uniform24(x))


def gaussian_noise(seed: int, n_rays: int, n_noise: int, ray0: int = 0) -> torch.Tensor:
    """K3's standard normals [n_rays, n_noise] fp32."""
    s = np.arange(n_noise, dtype=np.uint64)[None, :]
    zero = np.uint64(0)
    words = philox4x32_10([s, np.uint64(1), zero, zero], _keys(seed, n_rays, ray0))
    u1 = _uniform24(words[0]) + np.float32(2.0**-25)
    u2 = _uniform24(words[1])
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    n = r * np.cos(np.float32(2.0 * np.pi) * u2)
    return torch.from_numpy(np.broadcast_to(n, (n_rays, n_noise)).astype(np.float32))
