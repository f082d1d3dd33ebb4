"""Multi-device disparity: row-band sharding with halo exchange.

The reference parallelizes spatially by feeding rectangular image chunks to
a goroutine pool (``pkg/despair/sad.go:36-53``, row bands in
``pkg/camera/output.go:172-187``); chunks overlap implicitly because every
worker holds the full frame and windows read across chunk borders. On a
device mesh the frame is *actually* partitioned, so the chunk overlap
becomes an explicit halo exchange: each device owns a contiguous row band
and receives ``h = block_size // 2`` boundary rows from each neighbor via
``jax.lax.ppermute`` over the ``rows`` mesh axis (neighbor traffic only —
no all-to-all). Boundary devices receive zeros from ppermute, which
is exactly the reference's zero-contribution row clamping (SURVEY.md
section 6 item 2), so the sharded result is bit-identical to the
single-device map.

The disparity sweep is horizontal, so no halo is needed along columns and
the cut axis (rows) is collective-free during the sweep itself: one
neighbor exchange per frame, then fully local compute.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from steroscopic_hardware_tpu.ops.sad_pallas import disparity_pallas
from steroscopic_hardware_tpu.ops.sad_xla import disparity_xla
from steroscopic_hardware_tpu.utils.device import sad_backend


def _halo_exchange(x: jnp.ndarray, h: int, axis_name: str) -> jnp.ndarray:
    """Concatenate the last h rows of the previous shard and the first h
    rows of the next shard around this shard (zeros at the ends)."""
    n = jax.lax.axis_size(axis_name)
    if h == 0 or n == 1:
        pad = jnp.zeros((h, x.shape[1]), x.dtype)
        return jnp.concatenate([pad, x, pad], axis=0)
    down = [(i, i + 1) for i in range(n - 1)]  # send to next shard
    up = [(i + 1, i) for i in range(n - 1)]    # send to previous shard
    from_above = jax.lax.ppermute(x[-h:], axis_name, perm=down)
    from_below = jax.lax.ppermute(x[:h], axis_name, perm=up)
    return jnp.concatenate([from_above, x, from_below], axis=0)


@functools.partial(
    jax.jit,
    static_argnames=("block_size", "max_disparity", "mesh", "axis_name",
                     "backend", "interpret"),
)
def disparity_sharded(
    left: jnp.ndarray,
    right: jnp.ndarray,
    *,
    block_size: int,
    max_disparity: int,
    mesh: Mesh,
    axis_name: str = "rows",
    backend: str = "auto",
    interpret: bool = False,
) -> jnp.ndarray:
    """Row-sharded dense disparity over a device mesh, bit-exact with the
    single-device kernels. H must divide evenly by the mesh axis size.

    Each shard runs the same disparity path as a single device
    (``backend="auto"`` asks ``utils.device.sad_backend`` for the mesh's
    platform: the Pallas kernel on GPU meshes, XLA on CPU meshes).
    ``backend="pallas"`` + ``interpret=True`` runs the kernel through the
    Pallas interpreter so tests validate the multi-device kernel path on
    the 8-device virtual CPU mesh.
    """
    h = block_size // 2
    H = left.shape[0]
    n = mesh.shape[axis_name]
    if H % n != 0:
        raise ValueError(f"H={H} not divisible by mesh axis {axis_name}={n}")
    if backend == "auto":
        backend = sad_backend(mesh.devices.flat[0].platform)
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")

    spec = P(axis_name, None)

    def local_fn(l_loc, r_loc):
        l_ext = _halo_exchange(l_loc, h, axis_name)
        r_ext = _halo_exchange(r_loc, h, axis_name)
        if backend == "pallas":
            out = disparity_pallas(
                l_ext, r_ext,
                block_size=block_size, max_disparity=max_disparity,
                interpret=interpret,
            )
        else:
            out = disparity_xla(
                l_ext, r_ext,
                block_size=block_size, max_disparity=max_disparity,
            )
        return out[h : h + l_loc.shape[0]]

    # check_vma=False: pallas_call does not annotate varying-mesh-axes
    # metadata on its outputs; the halo exchange is the only collective and
    # it is explicit above.
    fn = jax.shard_map(
        local_fn, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False,
    )
    left = jax.device_put(left, NamedSharding(mesh, spec))
    right = jax.device_put(right, NamedSharding(mesh, spec))
    return fn(left, right)
