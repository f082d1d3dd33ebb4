"""Census transform and Hamming cost volume.

Census is the standard illumination-robust matching cost for SGM (see
FP-Stereo, arXiv:2006.03250, for the hardware-pipeline formulation this
module re-designs for XLA): each pixel is described by the sign
pattern of its neighborhood, and matching cost is the Hamming distance
between left/right census codes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# 5x5 neighborhood, center excluded -> 24-bit codes.
_OFFS = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
         if (dy, dx) != (0, 0)]


def _shift2d(img, dy, dx):
    """Static shift with edge replication."""
    import numpy as np

    H, W = img.shape[-2], img.shape[-1]
    ys = np.clip(np.arange(H) + dy, 0, H - 1)
    xs = np.clip(np.arange(W) + dx, 0, W - 1)
    return img[..., ys, :][..., :, xs]


@jax.jit
def census5x5(img: jnp.ndarray) -> jnp.ndarray:
    """(H, W) uint8 -> (H, W) uint32 census codes (24 bits used)."""
    I = img.astype(jnp.int32)
    code = jnp.zeros(img.shape, jnp.uint32)
    for bit, (dy, dx) in enumerate(_OFFS):
        code = code | (
            (_shift2d(I, dy, dx) < I).astype(jnp.uint32) << bit
        )
    return code


def popcount32(x: jnp.ndarray) -> jnp.ndarray:
    """Bit population count of uint32 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0x3F


@functools.partial(jax.jit, static_argnames=("max_disparity",))
def census_cost_volume(left, right, *, max_disparity: int) -> jnp.ndarray:
    """(D, H, W) uint8 Hamming cost volume over d in [0, maxD]
    (invalid x < d filled with the max cost 24)."""
    cl = census5x5(left)
    cr = census5x5(right)
    W = left.shape[-1]
    xs = jax.lax.broadcasted_iota(jnp.int32, left.shape[-2:], 1)
    crp = jnp.pad(cr, [(0, 0)] * (cr.ndim - 1) + [(max_disparity, 0)])

    def one(d):
        sh = jax.lax.dynamic_slice_in_dim(crp, max_disparity - d, W, axis=-1)
        c = popcount32(cl ^ sh).astype(jnp.uint8)
        return jnp.where(xs >= d, c, jnp.uint8(24))

    return jax.vmap(one)(jnp.arange(max_disparity + 1))
