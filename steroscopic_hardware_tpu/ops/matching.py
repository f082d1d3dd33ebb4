"""Descriptor matching as one matrix product.

Hamming distance between binary descriptor sets via matrix multiply: with
descriptors encoded as +/-1, ``dot(a, b) = n_bits - 2 * hamming``, so one
(Ka, 256) x (256, Kb) matmul yields every pairwise distance —
the accelerator-native replacement for per-pair popcount loops (values are exact:
products are +/-1 and partial sums are integers well inside f32 range).

Provides mutual-nearest-neighbor matching with Lowe ratio test, fully
static shapes (invalid slots masked).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalar: a module-level jnp constant initialises the XLA backend at
# import, breaking jax.distributed.initialize() (tests/mp_worker.py)
_INF = np.float32(1e9)


def hamming_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Pairwise Hamming distances (Ka, Kb) float32.

    desc_*: (K, n_bits) uint8 in {0, 1}.
    """
    n_bits = desc_a.shape[-1]
    a = desc_a.astype(jnp.float32) * 2 - 1
    b = desc_b.astype(jnp.float32) * 2 - 1
    dot = jax.lax.dot_general(
        a, b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    ham = (n_bits - dot) / 2
    if valid_a is not None:
        ham = jnp.where(valid_a[:, None], ham, _INF)
    if valid_b is not None:
        ham = jnp.where(valid_b[None, :], ham, _INF)
    return ham


@functools.partial(jax.jit, static_argnames=("ratio", "max_distance"))
def match(
    desc_a,
    desc_b,
    valid_a=None,
    valid_b=None,
    *,
    ratio: float = 0.8,
    max_distance: float = 64.0,
):
    """Mutual-NN matching with ratio test.

    Returns (idx_b (Ka,) int32 — best match in b for each a,
             good (Ka,) bool — mutual, ratio-passing, under max_distance).
    """
    ham = hamming_matrix(desc_a, desc_b, valid_a, valid_b)

    best_b = jnp.argmin(ham, axis=1)
    d1 = jnp.min(ham, axis=1)
    # second-best for the ratio test
    ham2 = ham.at[jnp.arange(ham.shape[0]), best_b].set(_INF)
    d2 = jnp.min(ham2, axis=1)

    best_a_of_b = jnp.argmin(ham, axis=0)  # (Kb,)
    mutual = best_a_of_b[best_b] == jnp.arange(ham.shape[0])

    good = (
        mutual
        & (d1 <= max_distance)
        & (d1 <= ratio * jnp.maximum(d2, 1e-6))
    )
    if valid_a is not None:
        good = good & valid_a
    return best_b, good


@functools.partial(jax.jit, static_argnames=("ratio", "max_distance"))
def match_batch(
    descs_a,
    desc_b,
    valids_a,
    valid_b,
    *,
    ratio: float = 0.8,
    max_distance: float = 64.0,
):
    """Match B query sets against ONE target set in a single dispatch:
    descs_a (B, Ka, n_bits), valids_a (B, Ka). Returns
    (idx (B, Ka) into b, good (B, Ka)) — bitwise identical to B
    separate ``match(a_i, b)`` calls. Exists for dispatch economy on
    remote transports: a loop-closure check verifies top-k retrieved
    candidate keyframes against the current one, and k serialized
    ~RTT-bound dispatches starve the backend behind heavy serve RPCs
    (observed: the round-5 matrix's slam-sgm row closed zero loops
    in-window while its checks queued behind ~500 ms SGM serve
    windows)."""
    return jax.vmap(
        lambda da, va: match(da, desc_b, va, valid_b, ratio=ratio,
                             max_distance=max_distance)
    )(descs_a, valids_a)


@functools.partial(jax.jit, static_argnames=("ratio", "max_distance"))
def match_one_to_many(
    desc_a,
    descs_b,
    valid_a,
    valids_b,
    *,
    ratio: float = 0.8,
    max_distance: float = 64.0,
):
    """Match ONE query set against B target sets in a single dispatch:
    descs_b (B, Kb, n_bits). Returns (idx (B, Ka) into each b_i,
    good (B, Ka)) — bitwise identical to B separate ``match(a, b_i)``
    calls. Used by the BA window build (anchor matched into every other
    window keyframe: M-1 dispatches become one)."""
    return jax.vmap(
        lambda db, vb: match(desc_a, db, valid_a, vb, ratio=ratio,
                             max_distance=max_distance)
    )(descs_b, valids_b)
