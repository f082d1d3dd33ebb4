#!/usr/bin/env python3
"""On-card smoke test of the stereo depth + SLAM server.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py                # phases 1-4, one card
    python3 chip_smoke.py --four-cards   # phase 5 only, four cards

Phases (any failure raises: the script exits non-zero and never prints the
final ``ok`` line; progress and timings go on earlier lines):

1. Device: refuse unless JAX's first device is a GPU; print the card's
   name and power limit as ``nvidia-smi`` reports them.
2. Served path, through ``__main__.build`` (the code ``python -m
   steroscopic_hardware_tpu`` runs), in this process so that only one
   process holds the card:
   SAD at 1920x1080 on the seeded fixture pair, the served depth equal to
   ``sad_golden.disparity_numpy`` bit for bit at b16/d64 (the reference
   defaults), then after ``POST /update-params`` at b7/d64 and b31/d256;
   SGM at 1920x1080 d64 against the same pair on the CPU backend (at most
   1 grey level apart on at most 0.1% of pixels: the subpixel parabola
   divides in float32 on both sides, in different fusions); live SLAM with
   loop closure until ``/slam`` reports ``warm`` and a growing pose count.
   Each server is stopped after ``GET /exit``.
3. Kernels: ``ops/sad_pallas.py`` against the golden model bit for bit at
   640x480 b7 d64, 1920x1080 b16 d64 and 1920x1080 b31 d256, its LR,
   subpixel and batch variants against the XLA versions (integer-exact;
   the subpixel maps share ``parabola_refine``), and host time around
   ``block_until_ready`` of the kernel and of ``ops/sad_xla.py``: median
   of 30 runs after warmup.
4. SLAM: ``StereoSLAM`` with loop closure over a seeded 240-frame VGA loop
   (``utils/synth.py``), ATE under 0.12 m (the bound ``tests/test_slam.py``
   asserts); ``FusedServeTrack`` against classic VO on the same sequence,
   poses within 1e-3 m (matmul precision stays "highest").
5. ``--four-cards``: row-sharded SAD at 1080p over a (batch, rows) mesh of
   4 cards equal to the single-card map; ``StereoSLAM(pg_mesh=)`` against a
   single device; ``ba_solve_sharded`` against ``ba_solve``.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
RUNS = 30


def say(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name):
    say(f"== {name}")
    t0 = time.perf_counter()
    yield
    say(f"== {name}: ok in {time.perf_counter() - t0:.1f} s")


def require_gpu(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {devs[0].platform!r}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs; JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    return devs


def wait_for(pred, timeout, what):
    t0 = time.time()
    while True:
        got = pred()
        if got:
            return got
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{what} not reached in {timeout} s")
        time.sleep(0.25)


class Served:
    """One server built by ``__main__.build`` and its HTTP client."""

    def __init__(self, args):
        from steroscopic_hardware_tpu.__main__ import build

        self.server = build(list(args) + ["--no-open", "--port", "0"])
        self.base = f"http://127.0.0.1:{self.server.port}"

    def get(self, path, timeout=60):
        with urllib.request.urlopen(self.base + path, timeout=timeout) as r:
            return r.read()

    def post(self, path, form):
        data = urllib.parse.urlencode(form).encode()
        with urllib.request.urlopen(self.base + path, data=data,
                                    timeout=60) as r:
            return json.loads(r.read())

    def json(self, path):
        return json.loads(self.get(path))

    def depth(self):
        """The served uint8 depth map (``/stream/out``), or None before
        the first frame."""
        from steroscopic_hardware_tpu.io.png import read_png

        try:
            return read_png(self.get("/stream/out"))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def boot(self, timeout):
        wait_for(lambda: self.get("/checkhealth") == b"OK", 60,
                 "/checkhealth")
        t0 = time.time()
        wait_for(lambda: self.json("/metrics")["pipeline"]["frames"] > 0,
                 timeout, "first served frame")
        say(f"   first frame after {time.time() - t0:.1f} s")

    def close(self):
        say(f"   /exit returned {len(self.get('/exit'))} bytes of log")
        self.server.shutdown()


def served_equals(srv, want, timeout, what):
    """Wait until the served depth is bit-identical to ``want``."""
    seen = {}

    def check():
        got = srv.depth()
        if got is None or got.shape != want.shape:
            return False
        seen["bad"] = int((got != want).sum())
        return seen["bad"] == 0

    try:
        wait_for(check, timeout, what)
    except TimeoutError as e:
        raise AssertionError(
            f"{what}: {seen.get('bad')} pixels differ from the golden "
            "model") from e
    say(f"   {what}: bit-exact vs disparity_numpy")


def served_phase(fx):
    from steroscopic_hardware_tpu.utils.fixtures import write_pair

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    lp, rp = write_pair(tmp, fx["size"], SEED)
    wxh = "{1}x{0}".format(*fx["size"])
    with phase(f"served SAD {wxh} (default b16 d64, then retunes)"):
        srv = Served(["--left", lp, "--right", rp])
        try:
            srv.boot(300)
            served_equals(srv, fx["golden"][(16, 64)].result(), 120,
                          "b16 d64")
            for b, d in ((7, 64), (31, 256)):
                srv.post("/update-params",
                         {"blockSize": b, "maxDisparity": d})
                served_equals(srv, fx["golden"][(b, d)].result(), 300,
                              f"b{b} d{d} after /update-params")
        finally:
            srv.close()
    with phase(f"served SGM {wxh} d64 vs the CPU backend"):
        srv = Served(["--backend", "sgm", "--left", lp, "--right", rp])
        try:
            srv.boot(600)
            got = srv.depth().astype(np.int32)
        finally:
            srv.close()
        want = fx["sgm_cpu"].result().astype(np.int32)
        diff = np.abs(got - want)
        say(f"   max |diff| {diff.max()}, differing pixels "
            f"{(diff > 0).mean():.2e}")
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
            "SGM on the card disagrees with the CPU backend"
    with phase("served SLAM with loop closure (VGA fixture boot)"):
        srv = Served(["--slam", "--loop-closure"])
        try:
            srv.boot(300)
            t0 = time.time()
            snap = wait_for(lambda: (lambda s: s if s.get("warm") else None)(
                srv.json("/slam")), 600, "/slam warm")
            n0 = snap["positions_total"]
            say(f"   warm after {time.time() - t0:.1f} s, "
                f"{n0} poses")
            n1 = wait_for(lambda: (lambda n: n if n > n0 else None)(
                srv.json("/slam")["positions_total"]), 60, "pose growth")
            say(f"   poses {n0} -> {n1}")
        finally:
            srv.close()


def timed(fn, *args):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def kernel_phase(fixtures):
    import functools

    import jax
    import jax.numpy as jnp

    from steroscopic_hardware_tpu.ops import sad_pallas as sp
    from steroscopic_hardware_tpu.ops import sad_xla as sx

    for fx, b, d in ((fixtures["vga"], 7, 64), (fixtures["hd"], 16, 64),
                     (fixtures["hd"], 31, 256)):
        H, W = fx["size"]
        with phase(f"kernel {W}x{H} b{b} d{d}"):
            L, R = jnp.asarray(fx["left"]), jnp.asarray(fx["right"])
            kw = dict(block_size=b, max_disparity=d)
            k = functools.partial(sp.disparity_pallas, **kw)
            x = functools.partial(sx.disparity_xla, **kw)
            got = np.asarray(k(L, R))
            assert np.array_equal(got, fx["golden"][(b, d)].result()), \
                "kernel differs from the golden model"
            for name, a, c in (
                ("lr", sp.disparity_pallas_lr, sx.disparity_raw_lr_xla),
                ("subpixel", sp.disparity_pallas_subpixel,
                 sx.disparity_subpixel_lr_xla),
            ):
                for p, q in zip(a(L, R, **kw), c(L, R, **kw)):
                    assert np.array_equal(np.asarray(p), np.asarray(q)), \
                        f"{name} kernel differs from XLA"
            batch = np.asarray(sp.disparity_pallas_batch(
                jnp.stack([L, R]), jnp.stack([R, L]), **kw))
            assert np.array_equal(batch[0], got), "batch frame 0 differs"
            assert np.array_equal(batch[1], np.asarray(k(R, L))), \
                "batch frame 1 differs"
            t_k, t_x = timed(k, L, R), timed(x, L, R)
            say(json.dumps({"shape": f"{W}x{H}", "block": b,
                            "max_disparity": d, "kernel_ms": t_k,
                            "xla_ms": t_x, "speedup": t_x / t_k}))


VGA_CAM = dict(fx=480.0, fy=480.0, cx=320.0, cy=240.0, baseline=0.4)
SLAM_KW = dict(block_size=7, max_disparity=64, max_keypoints=256,
               fast_threshold=15, window=3, kf_every=2, ba_iters=4,
               loop_closure=True, loop_min_matches=15, loop_gap=6)


def slam_sequence(n):
    from steroscopic_hardware_tpu.models.slam import StereoCamera
    from steroscopic_hardware_tpu.utils.synth import (
        SyntheticScene,
        gt_positions,
        loop_trajectory,
    )

    cam = StereoCamera(**VGA_CAM)
    scene = SyntheticScene(cam, size=(480, 640), n_landmarks=160,
                           seed=SEED)
    xis = loop_trajectory(n)
    return cam, [scene.render_pair(xi) for xi in xis], gt_positions(xis)


def slam_phase():
    import jax

    from steroscopic_hardware_tpu.models.blockmatch import BlockMatcher
    from steroscopic_hardware_tpu.models.slam import StereoSLAM, ate_rmse
    from steroscopic_hardware_tpu.runtime.fused import FusedServeTrack
    from steroscopic_hardware_tpu.utils.params import Parameters

    assert jax.config.jax_default_matmul_precision == "highest"
    cam, frames, gt = slam_sequence(240)
    with phase("StereoSLAM, 240-frame VGA loop, loop closure on"):
        slam = StereoSLAM(cam, async_backend=False, **SLAM_KW)
        t0 = time.perf_counter()
        for left, right in frames:
            slam.process(left, right)
        ate = ate_rmse(slam.vo.positions(), gt)
        say(json.dumps({"frames": len(frames), "ate_m": ate,
                        "loops_closed": slam.loops_closed,
                        "ba_runs": slam.ba_runs,
                        "wall_s": time.perf_counter() - t0}))
        assert ate < 0.12, f"ATE {ate} m"
        assert slam.loops_closed >= 1, "no loop closed"
    with phase("FusedServeTrack vs classic VO (first 40 frames)"):
        kw = dict(SLAM_KW, loop_closure=False)
        fused_slam = StereoSLAM(cam, async_backend=False, **kw)
        classic = StereoSLAM(cam, async_backend=False, **kw)
        matcher = BlockMatcher(params=Parameters(7, 64))
        fused = FusedServeTrack(matcher, fused_slam)
        for left, right in frames[:40]:
            _, track = fused.step([(left, right)], fetch_all=True,
                                  colorize_dev=False)
            fused_slam.process_tracked(track)
            classic.process(left, right)
        err = np.abs(fused_slam.vo.positions() - classic.vo.positions())
        say(f"   max pose difference {err.max():.2e} m, inliers equal "
            f"{fused_slam.vo.n_inliers == classic.vo.n_inliers}")
        assert err.max() < 1e-3, "fused tracking diverged from classic VO"


def four_card_phase():
    import jax
    import jax.numpy as jnp

    from steroscopic_hardware_tpu.models.ba import BAProblem, ba_solve
    from steroscopic_hardware_tpu.models.slam import StereoSLAM, ate_rmse
    from steroscopic_hardware_tpu.ops import se3
    from steroscopic_hardware_tpu.ops.sad_pallas import disparity_pallas
    from steroscopic_hardware_tpu.parallel.ba_dist import ba_solve_sharded
    from steroscopic_hardware_tpu.parallel.disparity_shard import (
        disparity_sharded,
    )
    from steroscopic_hardware_tpu.parallel.mesh import make_mesh
    from steroscopic_hardware_tpu.utils.fixtures import FULL_HD, stereo_pair

    mesh = make_mesh(n_rows=4, devices=jax.devices()[:4])
    say(f"   mesh {dict(mesh.shape)} over "
        f"{[d.id for d in mesh.devices.flat]}")
    with phase("row-sharded SAD 1920x1080 over 4 cards"):
        left, right, _ = stereo_pair(FULL_HD, SEED)
        for b, d in ((16, 64), (31, 256)):
            one = np.asarray(disparity_pallas(
                jnp.asarray(left), jnp.asarray(right), block_size=b,
                max_disparity=d))
            fn = lambda a, c: disparity_sharded(  # noqa: E731
                a, c, block_size=b, max_disparity=d, mesh=mesh)
            four = np.asarray(fn(left, right))
            assert np.array_equal(one, four), f"sharded b{b} d{d} differs"
            say(json.dumps({"block": b, "max_disparity": d,
                            "sharded_ms": timed(fn, left, right),
                            "equal_to_one_card": True}))
    with phase("StereoSLAM(pg_mesh=4 cards) vs one card"):
        cam, frames, gt = slam_sequence(48)
        plain = StereoSLAM(cam, async_backend=False, **SLAM_KW)
        sharded = StereoSLAM(cam, async_backend=False, pg_mesh=mesh,
                             **SLAM_KW)
        for left, right in frames:
            plain.process(left, right)
            sharded.process(left, right)
        ate_p = ate_rmse(plain.vo.positions(), gt)
        ate_s = ate_rmse(sharded.vo.positions(), gt)
        say(json.dumps({"loops_closed": [plain.loops_closed,
                                         sharded.loops_closed],
                        "ate_m": [ate_p, ate_s]}))
        assert sharded.loops_closed == plain.loops_closed >= 1
        assert abs(ate_s - ate_p) < 5e-3
    with phase("ba_solve_sharded vs ba_solve over 4 cards"):
        rng = np.random.default_rng(SEED)
        intr = (320.0, 320.0, 320.0, 240.0)
        M, N = 4, 256
        pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                        rng.uniform(4, 12, N)], -1).astype(np.float32)
        xi_true = np.cumsum(np.concatenate(
            [rng.uniform(-0.1, 0.1, (M, 3)),
             rng.uniform(-0.02, 0.02, (M, 3))], 1), 0).astype(np.float32)
        xi_true[0] = 0
        uv = np.zeros((M, N, 2), np.float32)
        for i in range(M):
            Rm, t = se3.se3_exp(jnp.asarray(xi_true[i]))
            c = pts @ np.asarray(Rm).T + np.asarray(t)
            uv[i] = np.stack([intr[0] * c[:, 0] / c[:, 2] + intr[2],
                              intr[1] * c[:, 1] / c[:, 2] + intr[3]], -1)
        mask = np.ones((M, N), np.float32)
        xi0 = (xi_true + np.concatenate(
            [np.zeros((1, 6)), rng.normal(0, 0.04, (M - 1, 6))], 0)
        ).astype(np.float32)
        pts0 = (pts + rng.normal(0, 0.08, pts.shape)).astype(np.float32)
        single, errs_s = ba_solve(BAProblem(
            jnp.asarray(xi0), jnp.asarray(pts0), jnp.asarray(uv),
            jnp.asarray(mask), intr), iters=10)
        xi_d, _, errs_d = ba_solve_sharded(
            jnp.asarray(xi0), jnp.asarray(pts0), jnp.asarray(uv),
            jnp.asarray(mask), intr=intr, mesh=mesh, iters=10)
        errs_s, errs_d = np.asarray(errs_s), np.asarray(errs_d)
        say(json.dumps({"final_err": [float(errs_s[-1]),
                                      float(errs_d[-1])]}))
        assert np.allclose(errs_d[0], errs_s[0], rtol=1e-5)
        assert errs_d[-1] < 1e-3 and errs_s[-1] < 1e-3
        assert np.allclose(np.asarray(xi_d), np.asarray(single.xi),
                           atol=5e-3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    devs = require_gpu(n_cards)
    sys.path.insert(0, HERE)
    from steroscopic_hardware_tpu.utils.device import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    import steroscopic_hardware_tpu.models  # noqa: F401  (precision)

    t0 = time.perf_counter()
    if args.four_cards:
        four_card_phase()
    else:
        import jax

        from steroscopic_hardware_tpu.models.blockmatch import SGMMatcher
        from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
        from steroscopic_hardware_tpu.utils.fixtures import (
            FULL_HD,
            VGA,
            stereo_pair,
        )

        def sgm_on_cpu(left, right):
            with jax.default_device(jax.devices("cpu")[0]):
                return SGMMatcher().compute(left, right)

        # references are computed on the host while the card works
        pool = ThreadPoolExecutor(max_workers=4)
        fixtures = {}
        for key, size, params in (("vga", VGA, [(7, 64)]),
                                  ("hd", FULL_HD,
                                   [(16, 64), (7, 64), (31, 256)])):
            left, right, _ = stereo_pair(size, SEED)
            fixtures[key] = dict(
                size=size, left=left, right=right,
                golden={(b, d): pool.submit(disparity_numpy, left, right,
                                            b, d) for b, d in params})
        fixtures["hd"]["sgm_cpu"] = pool.submit(
            sgm_on_cpu, fixtures["hd"]["left"], fixtures["hd"]["right"])
        served_phase(fixtures["hd"])
        kernel_phase(fixtures)
        slam_phase()
        pool.shutdown()
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
