"""Two-process ``jax.distributed`` worker (VERDICT r2 directive #7).

Run twice (process_id 0 and 1) with a shared localhost coordinator; each
process owns 4 virtual CPU devices, so the global mesh has 8 devices
spanning two OS processes and every collective that crosses the middle of
the ``rows`` axis rides the Gloo cross-process transport — the testable
half of BASELINE config #5 ("multi-host"). The driver test
(``tests/test_multiprocess.py``) asserts both workers exit 0 after
proving bit-identity with the single-process results.

What runs on the global mesh:
  * ``disparity_sharded`` over an 8-way ``rows`` axis (halo ppermute at
    the process boundary) — must be bit-exact vs ``disparity_numpy``;
  * ``ba_solve_sharded`` with landmarks sharded 8 ways (Schur psum
    crosses processes) — must converge and match the first-iteration
    error of the local single-device solve;
  * ``global_mesh()`` / ``init_distributed`` from
    ``parallel/multihost.py`` (ref topology analog: two Zedboards,
    ``image_capture``'s two-board serial protocol).

Usage: python tests/mp_worker.py <coordinator_port> <process_id>
"""

import os
import sys

PORT, PID = sys.argv[1], int(sys.argv[2])

# Must precede the jax import.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from steroscopic_hardware_tpu.utils.device import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

from steroscopic_hardware_tpu.parallel.multihost import (  # noqa: E402
    global_mesh,
    init_distributed,
)


def main():
    info = init_distributed(f"127.0.0.1:{PORT}", 2, PID)
    assert info["local_devices"] == 4, info
    assert info["global_devices"] == 8, info

    from jax.experimental import multihost_utils

    from steroscopic_hardware_tpu.models.ba import BAProblem, ba_solve
    from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
    from steroscopic_hardware_tpu.parallel.disparity_shard import (
        disparity_sharded,
    )
    from steroscopic_hardware_tpu.parallel.ba_dist import ba_solve_sharded
    from steroscopic_hardware_tpu.parallel.mesh import make_mesh

    # ---- the (batch, rows) production mesh builds over both processes
    gm = global_mesh()
    assert gm.shape["batch"] * gm.shape["rows"] == 8, gm.shape

    # ---- 8-way rows mesh: shard boundary 4|5 is a process boundary
    mesh8 = make_mesh(n_rows=8)
    assert len({d.process_index for d in mesh8.devices.flat}) == 2

    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    out = disparity_sharded(
        left, right, block_size=7, max_disparity=16, mesh=mesh8
    )
    full = np.asarray(multihost_utils.process_allgather(out, tiled=True))
    ref = disparity_numpy(left, right, 7, 16)
    n_bad = int((full != ref).sum())
    assert n_bad == 0, f"disparity: {n_bad} mismatched pixels"
    print(f"[p{PID}] disparity_sharded 8-way cross-process: bit-exact",
          flush=True)

    # ---- scanline-sharded SGM: the all_to_all reshard (H-bands ->
    # W-bands) crosses the process boundary — the one collective the
    # framework uses that had never left a single process (VERDICT r3
    # weak #4). Must stay bit-identical to the single-device engine.
    from steroscopic_hardware_tpu.ops.sgm import sgm_disparity
    from steroscopic_hardware_tpu.parallel.sgm_shard import (
        sgm_disparity_sharded,
    )

    sg_left = rng.integers(0, 256, (48, 96), dtype=np.uint8)
    sg_right = np.clip(
        np.roll(sg_left, -4, axis=1).astype(int)
        + rng.integers(-2, 3, (48, 96)),
        0, 255,
    ).astype(np.uint8)
    want = np.asarray(
        sgm_disparity(sg_left, sg_right, max_disparity=16)
    )
    got = sgm_disparity_sharded(
        sg_left, sg_right, max_disparity=16, mesh=mesh8
    )
    got = np.asarray(multihost_utils.process_allgather(got, tiled=True))
    n_bad = int((got != want).sum())
    assert n_bad == 0, f"sgm: {n_bad} mismatched pixels"
    print(f"[p{PID}] sgm_disparity_sharded 8-way cross-process "
          f"(all_to_all over Gloo): bit-exact", flush=True)

    # ---- distributed BA: landmark Schur psum crosses the process
    # boundary; reuse the deterministic problem from the in-process test
    from test_ba_dist import INTR, _problem

    xi0, pts0, uv, mask, xi_true = _problem(np.random.default_rng(1234))
    single, errs_s = ba_solve(
        BAProblem(jnp.asarray(xi0), jnp.asarray(pts0), jnp.asarray(uv),
                  jnp.asarray(mask), INTR),
        iters=10,
    )
    xi_d, pts_d, errs_d = ba_solve_sharded(
        jnp.asarray(xi0), jnp.asarray(pts0), jnp.asarray(uv),
        jnp.asarray(mask), intr=INTR, mesh=mesh8, iters=10,
    )
    xi_d, errs_d = (
        np.asarray(multihost_utils.process_allgather(xi_d, tiled=True)),
        np.asarray(multihost_utils.process_allgather(errs_d, tiled=True)),
    )
    errs_s = np.asarray(errs_s)
    assert np.allclose(errs_d[0], errs_s[0], rtol=1e-5), (
        errs_d[0], errs_s[0])
    assert errs_d[-1] < 1e-3 and errs_s[-1] < 1e-3, (errs_d[-1], errs_s[-1])
    assert np.allclose(xi_d, np.asarray(single.xi), atol=5e-3)
    assert np.allclose(xi_d, xi_true, atol=5e-3)
    print(f"[p{PID}] ba_solve_sharded 8-way cross-process: converged, "
          f"matches single-device", flush=True)

    # ---- edge-sharded pose graph: CG matvec psums cross the process
    # boundary every iteration (parallel/pg_dist.py)
    from steroscopic_hardware_tpu.models.slam import pose_graph_optimize
    from steroscopic_hardware_tpu.ops import se3
    from steroscopic_hardware_tpu.parallel.pg_dist import (
        pad_edges,
        pose_graph_optimize_sharded,
    )

    Mg = 12
    xi_true = np.zeros((Mg, 6), np.float32)
    step = np.array([0.4, 0, 0.1, 0, np.pi / 6, 0], np.float32)
    for i in range(1, Mg):
        xi_true[i] = np.asarray(se3.se3_log(*se3.compose(
            *se3.se3_exp(jnp.asarray(step)),
            *se3.se3_exp(jnp.asarray(xi_true[i - 1])),
        )))

    def rel(i, j):
        Ri, ti = se3.se3_exp(jnp.asarray(xi_true[i]))
        Rj, tj = se3.se3_exp(jnp.asarray(xi_true[j]))
        return np.asarray(se3.se3_log(*se3.compose(
            Rj, tj, *se3.inverse(Ri, ti))))

    edges = [(i, i + 1) for i in range(Mg - 1)] + [(Mg - 1, 0)]
    meas = np.stack([rel(i, j) for i, j in edges]).astype(np.float32)
    wts = np.ones(len(edges), np.float32)
    eij = np.array(edges, np.int32)
    prng = np.random.default_rng(11)
    xi_init = xi_true + np.concatenate(
        [np.zeros((1, 6)), prng.normal(0, 0.05, (Mg - 1, 6))], 0
    ).astype(np.float32)
    single, _ = pose_graph_optimize(
        jnp.asarray(xi_init), jnp.asarray(eij), jnp.asarray(meas),
        jnp.asarray(wts), iters=8)
    eij_p, meas_p, w_p = pad_edges(eij, meas, wts, 8)
    xi_d, costs = pose_graph_optimize_sharded(
        jnp.asarray(xi_init), jnp.asarray(eij_p), jnp.asarray(meas_p),
        jnp.asarray(w_p), mesh=mesh8, iters=8)
    xi_d = np.asarray(multihost_utils.process_allgather(xi_d, tiled=True))
    costs = np.asarray(multihost_utils.process_allgather(
        costs, tiled=True))
    assert costs[-1] < costs[0] * 1e-3, (costs[0], costs[-1])
    assert np.allclose(xi_d, np.asarray(single), atol=1e-4)
    assert np.allclose(xi_d, xi_true, atol=1e-3)
    print(f"[p{PID}] pose_graph_optimize_sharded 8-way cross-process: "
          f"converged, matches single-device", flush=True)

    multihost_utils.sync_global_devices("mp_worker_done")
    print(f"MP_WORKER_OK p{PID}", flush=True)


if __name__ == "__main__":
    main()
