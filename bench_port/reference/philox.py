"""Philox4x32-10 draws of the hierarchical oracle, frozen here.

The oracle (K6) draws its stratified jitter and inverse-CDF uniforms in the
kernel from Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011), keyed by (seed, global ray index): draw k of a
ray is word k % 4 of the block with counter (k // 4, 0, 0, 0), and a
uniform is the top 24 bits of a word times 2^-24. This copy of that stream
is the reference's, so that it computes the same step from the same seed
without reading anything the program made.
"""

from __future__ import annotations

import numpy as np

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)


def philox4x32_10(ctr: list, key: list) -> list[np.ndarray]:
    """Ten rounds over broadcastable uint64 arrays that hold 32-bit words."""
    c = [np.asarray(x, np.uint64) & _MASK for x in ctr]
    k0, k1 = (np.asarray(x, np.uint64) & _MASK for x in key)
    for _ in range(10):
        p0, p1 = _M0 * c[0], _M1 * c[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c


def hier_draws(seed: int, n_rays: int, n_draws: int, ray0: int = 0) -> np.ndarray:
    """[n_rays, n_draws] float32 uniforms in [0, 1): t_rand, then u."""
    k = np.arange(n_draws, dtype=np.uint64)[None, :]
    rays = np.arange(ray0, ray0 + n_rays, dtype=np.uint64)[:, None]
    zero = np.uint64(0)
    words = philox4x32_10([k >> np.uint64(2), zero, zero, zero], [np.uint64(seed & 0xFFFFFFFF), rays])
    lane = np.broadcast_to((k & np.uint64(3)).astype(np.int64), (n_rays, n_draws))
    x = np.choose(lane, [np.broadcast_to(w, (n_rays, n_draws)) for w in words])
    return (x >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)
