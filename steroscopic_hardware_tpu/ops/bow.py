"""Binary bag-of-words place recognition index (loop-closure retrieval).

The exhaustive loop-closure search matches the newest keyframe against
every past keyframe — O(N) jitted matcher dispatches per keyframe, which
dominates once trajectories get long (ROADMAP item; the reference has no
SLAM at all, this is beyond-parity scope). This module provides the
classic DBoW-style two-stage scheme, built accelerator-first:

* a fixed random binary vocabulary (no training pass needed — random
  256-bit words are near-orthogonal in Hamming space, the same property
  LSH relies on);
* ``bow_vector``: quantize a keyframe's ORB descriptors to their nearest
  vocabulary word and L2-normalize the term-frequency histogram. The
  K x V Hamming table is ONE matmul
  (ham = |d| + |w| - 2 d.w for binary vectors), not K x V scalar loops;
* ``BowIndex``: append-only database of keyframe vectors; a query scores
  the WHOLE history with one (N, V) @ (V,) matvec (cosine similarity of
  unit vectors) — one dispatch regardless of N. The database lives in a
  capacity-doubling padded buffer so jit re-specializes O(log N) times.

Full descriptor matching + PnP verification then runs only on the top-k
retrieved candidates (see ``models/slam.py``).
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=())
def _bow_vector(desc, valid, words):
    """L2-normalized term-frequency vector.

    desc: (K, 256) uint8 in {0,1}; valid: (K,) bool; words: (V, 256)
    float32 in {0,1}. Returns (V,) float32 unit vector (zeros if no valid
    descriptors).
    """
    d = desc.astype(jnp.float32)                       # (K, 256)
    dots = d @ words.T                                 # (K, V), one matmul
    ham = d.sum(1, keepdims=True) + words.sum(1)[None, :] - 2.0 * dots
    w_idx = jnp.argmin(ham, axis=1)                    # (K,)
    onehot = jax.nn.one_hot(w_idx, words.shape[0], dtype=jnp.float32)
    tf = (onehot * valid.astype(jnp.float32)[:, None]).sum(0)
    return tf / jnp.maximum(jnp.linalg.norm(tf), 1e-9)


@functools.partial(jax.jit, static_argnames=())
def _scores(db, q, n):
    """Cosine similarity of q against the first ``n`` rows of the padded
    database: one matvec for the whole history."""
    s = db @ q                                         # (C,)
    live = jnp.arange(db.shape[0]) < n
    return jnp.where(live, s, -jnp.inf)


@jax.jit
def _db_set_row(db, i, vec):
    """Append/overwrite one row of the device-resident database. NOT
    donated on purpose: a concurrent ``query_vector`` may still be
    reading the previous buffer, and the device-side table copy this
    costs is microseconds (vs the megabyte HOST->DEVICE re-upload per
    query that a host-only table costs through a remote transport)."""
    return jax.lax.dynamic_update_slice(db, vec[None, :], (i, 0))


class BowIndex:
    """Append-only place-recognition database over keyframe descriptors."""

    def __init__(self, n_words: int = 256, desc_bits: int = 256,
                 seed: int = 0, capacity: int = 64):
        key = jax.random.PRNGKey(seed)
        self.words = jax.random.bernoulli(
            key, 0.5, (n_words, desc_bits)
        ).astype(jnp.float32)
        self.n_words = n_words
        self.seed = seed  # vocabulary is fully determined by this
        # host mirror (checkpoint/rebuild source of truth) + lazily
        # synced DEVICE-resident copy: queries score against the device
        # table (no per-query megabyte re-upload through the wire), and
        # each append costs one 1 KB vector upload + a device-side row
        # write
        self._db = np.zeros((capacity, n_words), np.float32)
        self._db_dev = None
        self.n = 0
        # guards only the host-side buffer append/snapshot (nanoseconds);
        # device dispatches (quantize matmul, score matvec) happen OUTSIDE
        # any lock — on a remote transport a first-call compile can take
        # tens of seconds, and holding a shared lock through it froze the
        # live SLAM frame loop (round-4 serve_bench finding)
        self._mu = threading.Lock()

    def vector(self, desc, valid) -> np.ndarray:
        return np.asarray(
            _bow_vector(jnp.asarray(desc), jnp.asarray(valid), self.words)
        )

    def add(self, desc, valid) -> int:
        """Quantize and append one keyframe; returns its index."""
        vec = self.vector(desc, valid)     # device dispatch, lock-free
        return self.add_vector(vec)

    def _ensure_dev(self):
        """Device copy of the padded table (caller holds ``_mu``);
        rebuilt from the mirror only after a capacity doubling — one
        full-table upload per O(log N) growth events."""
        if (self._db_dev is None
                or self._db_dev.shape[0] != len(self._db)):
            self._db_dev = jax.device_put(self._db)
        return self._db_dev

    def _append_row(self, vec: np.ndarray) -> int:
        """Append one row to mirror + device table (caller holds _mu)."""
        if self.n == len(self._db):
            grown = np.zeros((2 * len(self._db), self.n_words),
                             np.float32)
            grown[: self.n] = self._db
            self._db = grown
            self._db_dev = None  # re-uploaded (with the new row) below
        self._db[self.n] = vec
        dev = self._ensure_dev()
        self._db_dev = _db_set_row(dev, jnp.int32(self.n),
                                   jnp.asarray(vec, jnp.float32))
        self.n += 1
        return self.n - 1

    def add_vector(self, vec: np.ndarray) -> int:
        """Append a PRE-QUANTIZED place vector (e.g. computed inside the
        fused serve+track dispatch, ``runtime/fused.py``) — a keyframe
        ingest then costs one 1 KB upload here, never a quantize
        dispatch."""
        with self._mu:
            return self._append_row(np.asarray(vec, np.float32))

    def add_zero(self) -> int:
        """Append an inert (zero) row — keeps row/keyframe index
        alignment when restoring a checkpoint whose old keyframes were
        feature-culled (models/slam.py _cull_history)."""
        with self._mu:
            return self._append_row(np.zeros(self.n_words, np.float32))

    def disable(self, idx: int) -> None:
        """Retire a stored keyframe: zero its row so it scores 0 against
        every query (excluded by any positive min_score). Used by
        keyframe feature culling; indices of later rows are unaffected."""
        with self._mu:
            if 0 <= idx < self.n:
                self._db[idx] = 0.0
                if self._db_dev is not None:
                    self._db_dev = _db_set_row(
                        self._db_dev, jnp.int32(idx),
                        jnp.zeros(self.n_words, jnp.float32))

    def warmup(self, n_desc: int) -> int:
        """Compile the quantize matmul and the score matvec for the
        given descriptor count and the CURRENT database capacity — the
        two programs a live session otherwise compiles at its first
        keyframe / first query (VERDICT r4 directive #2). Returns the
        number of programs warmed."""
        desc = jnp.zeros((n_desc, self.words.shape[1]), jnp.uint8)
        valid = jnp.zeros((n_desc,), bool)
        q = _bow_vector(desc, valid, self.words)
        with self._mu:
            db = self._ensure_dev()
        jax.block_until_ready(_scores(db, q, 0))
        jax.block_until_ready(_db_set_row(
            db, jnp.int32(0), jnp.zeros(self.n_words, jnp.float32)))
        return 3

    def query(self, desc, valid, *, top_k: int = 3,
              min_score: float = 0.0, before: int | None = None):
        """Top-k most similar stored keyframes.

        ``before`` restricts candidates to indices < before (loop-gap
        temporal exclusion). Returns a list of (index, score), best first.
        """
        q = _bow_vector(jnp.asarray(desc), jnp.asarray(valid), self.words)
        return self.query_vector(q, top_k=top_k, min_score=min_score,
                                 before=before)

    def query_vector(self, vec, *, top_k: int = 3,
                     min_score: float = 0.0, before: int | None = None):
        """Top-k retrieval for a PRE-QUANTIZED place vector (same
        contract as :meth:`query`; skips the quantize dispatch). Scores
        against the DEVICE-resident table — the query costs one 1 KB
        vector upload and one score fetch, independent of history
        length."""
        with self._mu:
            n = self.n if before is None else min(before, self.n)
            db = self._ensure_dev()  # snapshot ref: replaced, never
            #                          mutated, so lock-free to read
        if n <= 0:
            return []
        s = np.asarray(
            _scores(db, jnp.asarray(vec, jnp.float32), n)
        )[:n]
        order = np.argsort(-s)[:top_k]
        return [(int(i), float(s[i])) for i in order
                if s[i] >= min_score]
