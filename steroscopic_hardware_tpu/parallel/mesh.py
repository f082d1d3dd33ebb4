"""Mesh construction helpers.

The device-mesh replacement for the reference's parallelism tiers (Go worker
pool over image chunks, ``pkg/despair/sad.go:36-53``; two-board serial
topology): a ``jax.sharding.Mesh`` whose axes carry the same roles —
``rows`` = spatial data parallelism over image row bands (the analog of
``output.go:172-187`` row chunks), ``batch`` = independent frames/streams
(the analog of the left/right camera pair and multi-stream ingest).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_rows: int | None = None, n_batch: int = 1,
              devices=None) -> Mesh:
    """Build a (batch, rows) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_rows is None:
        n_rows = len(devices) // n_batch
    if n_rows * n_batch != len(devices):
        devices = devices[: n_rows * n_batch]
    arr = np.array(devices).reshape(n_batch, n_rows)
    return Mesh(arr, axis_names=("batch", "rows"))
