"""SAD block-matching disparity in pure XLA (jnp) — cost-volume
formulation, bit-exact with the reference per-pixel algorithm
(``pkg/despair/sad.go:55-94,205-244``; see ``ops/sad_golden.py`` for the
contract and the border-clipping derivation).

This is the portable path (the CPU backend's, fully jittable, batch and
vmap friendly) and the reference for ``ops/sad_pallas.py``, the GPU kernel.

Algorithm (exact reformulation of the reference semantics):
  cost[d, y, x] = zero-padded (2h+1)^2 box sum of |L[y,x] - R[y,x-d]|
  disp[y, x]    = first-occurrence argmin over d in [0, maxD] of cost,
                  with candidates d > x-h masked invalid (for x < h no
                  candidate is valid and the output is 0)
  out[y, x]     = uint8(disp * 255 // maxD)

All arithmetic is int32 (max cost 31*31*255 = 245055 < 2^31); the box sum is
separable (column then row sliding windows) and the disparity sweep runs as a
``lax.scan`` over chunks of the disparity axis with a running argmin, keeping
peak memory at ``d_chunk * H * W`` instead of ``(maxD+1) * H * W``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# numpy (not jnp) scalar: a module-level jnp constant would initialise the
# XLA backend at import time, which breaks jax.distributed.initialize()
# in multi-process runs (tests/mp_worker.py). Promotion semantics inside
# jnp ops are identical.
_BIG = np.int32(2**30)


def _box_sum_2d(ad: jnp.ndarray, half: int) -> jnp.ndarray:
    """Zero-padded (2*half+1)^2 box sum over the last two axes (exact int)."""
    B = 2 * half + 1
    # column (last axis) sliding sum via padded cumsum difference
    pad = jnp.pad(ad, [(0, 0)] * (ad.ndim - 1) + [(half + 1, half)])
    cs = jnp.cumsum(pad, axis=-1)
    col = cs[..., B:] - cs[..., :-B]
    # row sliding sum
    pad = jnp.pad(col, [(0, 0)] * (ad.ndim - 2) + [(half + 1, half), (0, 0)])
    cs = jnp.cumsum(pad, axis=-2)
    return cs[..., B:, :] - cs[..., :-B, :]


@functools.partial(
    jax.jit, static_argnames=("block_size", "max_disparity", "d_chunk")
)
def disparity_raw_xla(
    left: jnp.ndarray,
    right: jnp.ndarray,
    *,
    block_size: int,
    max_disparity: int,
    d_chunk: int = 16,
) -> jnp.ndarray:
    """Raw (un-normalized, int32) winner-take-all disparity sweep."""
    half = block_size // 2
    W = left.shape[-1]
    L = left.astype(jnp.int32)
    R = right.astype(jnp.int32)
    xs = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)

    # Pad R on the left so shift-by-d becomes a static-size dynamic slice.
    n_d = max_disparity + 1
    n_chunks = -(-n_d // d_chunk)
    Rpad = jnp.pad(R, [(0, 0)] * (R.ndim - 1) + [(max_disparity, 0)])

    def shifted_cost(d):
        # R shifted right by d with zero fill: Rs[..., x] = R[..., x-d]
        Rs = jax.lax.dynamic_slice_in_dim(
            Rpad, max_disparity - d, W, axis=-1
        )
        ad = jnp.abs(L - Rs)
        ad = jnp.where(xs >= d, ad, 0)
        cost = _box_sum_2d(ad, half)
        valid = xs >= d + half  # d <= x - half
        return jnp.where(valid, cost, _BIG)

    def step(carry, chunk_idx):
        best_cost, best_d = carry
        d0 = chunk_idx * d_chunk

        def body(i, c):
            bc, bd = c
            d = d0 + i
            # The last chunk may run past max_disparity: clamp the shift
            # (slice stays in bounds) and mask those candidates invalid.
            cost = shifted_cost(jnp.minimum(d, max_disparity))
            cost = jnp.where(d <= max_disparity, cost, _BIG)
            better = cost < bc
            bc = jnp.where(better, cost, bc)
            bd = jnp.where(better, d, bd)
            return bc, bd

        carry = jax.lax.fori_loop(0, d_chunk, body, (best_cost, best_d))
        return carry, None

    # Derive the carry from L (full_like/zeros_like) so it inherits L's
    # varying manual axes under shard_map.
    init = (jnp.full_like(L, _BIG), jnp.zeros_like(L))
    (best_cost, best_d), _ = jax.lax.scan(
        step, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    del best_cost
    return best_d


@functools.partial(
    jax.jit, static_argnames=("block_size", "max_disparity", "d_chunk")
)
def disparity_subpixel_xla(
    left: jnp.ndarray,
    right: jnp.ndarray,
    *,
    block_size: int,
    max_disparity: int,
    d_chunk: int = 16,
) -> jnp.ndarray:
    """Sub-pixel disparity by parabola interpolation around the integer
    argmin. The neighbor costs c(d*-1), c(d*+1) are tracked inside the
    same single sweep: when the winner updates at step d, the previous
    step's cost is its left neighbor; when step d runs with the winner at
    d-1, cost_d is its right neighbor — no second pass over the volume.

    Returns float32 disparities in pixels (un-normalized); integer-argmin
    positions where a neighbor is invalid.
    """
    half = block_size // 2
    W = left.shape[-1]
    L = left.astype(jnp.int32)
    R = right.astype(jnp.int32)
    xs = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
    n_d = max_disparity + 1
    n_chunks = -(-n_d // d_chunk)
    Rpad = jnp.pad(R, [(0, 0)] * (R.ndim - 1) + [(max_disparity, 0)])

    def step(carry, chunk_idx):
        d0 = chunk_idx * d_chunk

        def body(i, c):
            bc, bd, c_left, c_right, prev = c
            d = d0 + i
            dd = jnp.minimum(d, max_disparity)
            Rs = jax.lax.dynamic_slice_in_dim(
                Rpad, max_disparity - dd, W, axis=-1
            )
            ad = jnp.abs(L - Rs)
            ad = jnp.where(xs >= dd, ad, 0)
            cost = _box_sum_2d(ad, half)
            cost = jnp.where(
                (xs >= d + half) & (d <= max_disparity), cost, _BIG
            )
            better = cost < bc
            c_left = jnp.where(better, prev, c_left)
            # a new winner invalidates any previously captured right
            # neighbor; the NEXT step then supplies the fresh one
            c_right = jnp.where(better, _BIG, c_right)
            bc = jnp.where(better, cost, bc)
            bd = jnp.where(better, d, bd)
            c_right = jnp.where(bd == d - 1, cost, c_right)
            return bc, bd, c_left, c_right, cost

        return jax.lax.fori_loop(0, d_chunk, body, carry), None

    init = (
        jnp.full_like(L, _BIG), jnp.zeros_like(L),
        jnp.full_like(L, _BIG), jnp.full_like(L, _BIG),
        jnp.full_like(L, _BIG),
    )
    (bc, bd, c_left, c_right, _), _ = jax.lax.scan(
        step, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return parabola_refine(c_left, bc, c_right, bd)


def parabola_refine(c_left, c_best, c_right, best_d):
    """Equiangular parabola subpixel refinement around an integer argmin;
    falls back to the integer position when a neighbor cost is invalid
    (_BIG). Shared by the XLA and Pallas subpixel paths."""
    c0 = c_left.astype(jnp.float32)
    c1 = c_best.astype(jnp.float32)
    c2 = c_right.astype(jnp.float32)
    denom = c0 - 2 * c1 + c2
    delta = jnp.where(
        jnp.abs(denom) > 1e-6,
        jnp.clip(0.5 * (c0 - c2) / jnp.where(denom == 0, 1.0, denom),
                 -0.5, 0.5),
        0.0,
    )
    usable = (c_left < _BIG) & (c_right < _BIG) & (c_best < _BIG)
    return jnp.where(
        usable, best_d.astype(jnp.float32) + delta,
        best_d.astype(jnp.float32),
    )


@functools.partial(
    jax.jit, static_argnames=("block_size", "max_disparity", "d_chunk")
)
def disparity_subpixel_lr_xla(
    left: jnp.ndarray,
    right: jnp.ndarray,
    *,
    block_size: int,
    max_disparity: int,
    d_chunk: int = 16,
):
    """ONE sweep producing both the subpixel left disparity and the raw
    right-referenced disparity — the XLA counterpart of
    ``sad_pallas.disparity_pallas_subpixel`` for the SLAM front-end
    (which needs dR for the LR gate AND subpixel dL for triangulation;
    running ``disparity_subpixel_xla`` + ``disparity_raw_lr_xla``
    separately costs two passes over the cost volume and two compiles).
    Returns (dL float32 subpixel, dR int32)."""
    half = block_size // 2
    W = left.shape[-1]
    L = left.astype(jnp.int32)
    R = right.astype(jnp.int32)
    xs = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
    n_d = max_disparity + 1
    n_chunks = -(-n_d // d_chunk)
    Rpad = jnp.pad(R, [(0, 0)] * (R.ndim - 1) + [(max_disparity, 0)])

    def step(carry, chunk_idx):
        d0 = chunk_idx * d_chunk

        def body(i, c):
            bcL, bdL, c_left, c_right, prev, bcR, bdR = c
            d = d0 + i
            dd = jnp.minimum(d, max_disparity)
            Rs = jax.lax.dynamic_slice_in_dim(
                Rpad, max_disparity - dd, W, axis=-1
            )
            ad = jnp.abs(L - Rs)
            ad = jnp.where(xs >= dd, ad, 0)
            cost = _box_sum_2d(ad, half)
            ok = d <= max_disparity
            costL = jnp.where((xs >= d + half) & ok, cost, _BIG)
            betterL = costL < bcL
            c_left = jnp.where(betterL, prev, c_left)
            c_right = jnp.where(betterL, _BIG, c_right)
            bcL = jnp.where(betterL, costL, bcL)
            bdL = jnp.where(betterL, d, bdL)
            c_right = jnp.where(bdL == d - 1, costL, c_right)
            # right-referenced diagonal: costR[xr] = cost[xr + d]
            costP = jnp.pad(
                cost,
                [(0, 0)] * (cost.ndim - 1) + [(0, max_disparity)],
                constant_values=_BIG,
            )
            costR = jax.lax.dynamic_slice_in_dim(costP, dd, W, axis=-1)
            costR = jnp.where((xs >= half) & ok, costR, _BIG)
            betterR = costR < bcR
            bcR = jnp.where(betterR, costR, bcR)
            bdR = jnp.where(betterR, d, bdR)
            return bcL, bdL, c_left, c_right, costL, bcR, bdR

        return jax.lax.fori_loop(0, d_chunk, body, carry), None

    init = (
        jnp.full_like(L, _BIG), jnp.zeros_like(L),
        jnp.full_like(L, _BIG), jnp.full_like(L, _BIG),
        jnp.full_like(L, _BIG),
        jnp.full_like(L, _BIG), jnp.zeros_like(L),
    )
    (bcL, bdL, c_left, c_right, _, _, dR), _ = jax.lax.scan(
        step, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return parabola_refine(c_left, bcL, c_right, bdL), dR


@functools.partial(
    jax.jit, static_argnames=("block_size", "max_disparity", "d_chunk")
)
def disparity_raw_lr_xla(
    left: jnp.ndarray,
    right: jnp.ndarray,
    *,
    block_size: int,
    max_disparity: int,
    d_chunk: int = 16,
):
    """One-sweep left- AND right-referenced raw disparities.

    The same cost volume serves both directions: the right-referenced
    cost at right pixel xr and candidate d is the diagonal
    ``C(xr + d, d)``, so each sweep step updates the right accumulator
    with the left cost row shifted by d — half the work of two sweeps.
    Returns (dL, dR) int32 maps (dR indexed by right-image pixel).
    """
    half = block_size // 2
    W = left.shape[-1]
    L = left.astype(jnp.int32)
    R = right.astype(jnp.int32)
    xs = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
    n_d = max_disparity + 1
    n_chunks = -(-n_d // d_chunk)
    Rpad = jnp.pad(R, [(0, 0)] * (R.ndim - 1) + [(max_disparity, 0)])

    def step(carry, chunk_idx):
        d0 = chunk_idx * d_chunk

        def body(i, c):
            bcL, bdL, bcR, bdR = c
            d = d0 + i
            dd = jnp.minimum(d, max_disparity)
            Rs = jax.lax.dynamic_slice_in_dim(
                Rpad, max_disparity - dd, W, axis=-1
            )
            ad = jnp.abs(L - Rs)
            ad = jnp.where(xs >= dd, ad, 0)
            cost = _box_sum_2d(ad, half)
            ok = d <= max_disparity
            costL = jnp.where((xs >= d + half) & ok, cost, _BIG)
            betterL = costL < bcL
            bcL = jnp.where(betterL, costL, bcL)
            bdL = jnp.where(betterL, d, bdL)
            # right-referenced diagonal: costR[xr] = cost[xr + d]
            costP = jnp.pad(
                cost,
                [(0, 0)] * (cost.ndim - 1) + [(0, max_disparity)],
                constant_values=_BIG,
            )
            costR = jax.lax.dynamic_slice_in_dim(costP, dd, W, axis=-1)
            costR = jnp.where((xs >= half) & ok, costR, _BIG)
            betterR = costR < bcR
            bcR = jnp.where(betterR, costR, bcR)
            bdR = jnp.where(betterR, d, bdR)
            return bcL, bdL, bcR, bdR

        return jax.lax.fori_loop(0, d_chunk, body, carry), None

    init = (
        jnp.full_like(L, _BIG), jnp.zeros_like(L),
        jnp.full_like(L, _BIG), jnp.zeros_like(L),
    )
    (_, dL, _, dR), _ = jax.lax.scan(
        step, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return dL, dR


@functools.partial(
    jax.jit, static_argnames=("block_size", "max_disparity", "d_chunk")
)
def disparity_xla(
    left: jnp.ndarray,
    right: jnp.ndarray,
    *,
    block_size: int,
    max_disparity: int,
    d_chunk: int = 16,
) -> jnp.ndarray:
    """Dense disparity map, uint8, bit-exact with the reference.

    Args:
      left, right: uint8 grayscale images, shape (H, W) or batched (..., H, W).
      block_size: SAD window size B (reference envelope 3-31, odd;
        ``cmd/handlers/params.go:37``). Even values follow the same
        ``half = B//2`` semantics as the reference default 16.
      max_disparity: inclusive disparity sweep bound (envelope 16-256 step
        16, ``cmd/handlers/params.go:51``).
      d_chunk: disparities evaluated per scan step (memory/speed knob; does
        not affect results).
    """
    best_d = disparity_raw_xla(
        left,
        right,
        block_size=block_size,
        max_disparity=max_disparity,
        d_chunk=d_chunk,
    )
    # Normalization: uint8(bestD * 255 / maxD), integer division
    # (pkg/despair/sad.go:91-93).
    return ((best_d * 255) // max_disparity).astype(jnp.uint8)
