#!/usr/bin/env python
"""Long-horizon live soak (VERDICT r4 directive #3): boot the production
server in the slam config, sample its whole health surface on an
interval for N minutes, and write a time-series artifact proving the
system holds up under time — flat memory (RSS), bounded backend backlog,
no throughput decay, and per-closure optimize time that does not grow
unboundedly.

  python tools/soak.py [--minutes 12] [--interval 10] [--json SOAK.json]

Each sample records: wall clock, depth frames/fps-in-window, SLAM
batches + poses (every depth frame is tracked in the fused dispatch),
keyframes, loops closed, backend_pending, loop_checks_skipped,
culled_keyframes, fused_dropped, per-stage cumulative seconds (the
graph stage divided by closures = per-closure optimize cost), and the
server process RSS in MB.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT = 8198


def fetch_json(path, timeout=10.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{PORT}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def rss_mb(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024, 1)
    except OSError:
        pass
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=12.0)
    ap.add_argument("--interval", type=float, default=10.0)
    ap.add_argument("--compile-wait", type=float, default=420.0)
    ap.add_argument("--json", default="SOAK.json")
    ap.add_argument("--extra-args", default="--slam,--loop-closure",
                    help="comma-separated extra server args")
    args = ap.parse_args()

    extra = [a for a in args.extra_args.split(",") if a]
    with_slam = "--slam" in extra
    proc = subprocess.Popen(
        [sys.executable, "-m", "steroscopic_hardware_tpu",
         "--port", str(PORT), "--no-open", "--fps", "60"] + extra,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    samples = []
    try:
        deadline = time.time() + args.compile_wait
        while time.time() < deadline:
            try:
                m = fetch_json("/metrics")
                if m["pipeline"]["frames"] < 5:
                    raise ValueError("not yet")
                if not with_slam:
                    break
                s = fetch_json("/slam")
                if s.get("frames", 0) >= 2 and s.get("warm"):
                    break
            except Exception:
                pass
            time.sleep(2.0)
        else:
            raise SystemExit("server never became ready (wedged compile?)")

        t_start = time.time()
        last_frames = last_poses = 0
        last_t = t_start
        while time.time() - t_start < args.minutes * 60:
            time.sleep(args.interval)
            try:
                m = fetch_json("/metrics")["pipeline"]
                s = fetch_json("/slam") if with_slam else {}
            except Exception as e:
                samples.append({"t": round(time.time() - t_start, 1),
                                "error": str(e)})
                continue
            now = time.time()
            frames = m.get("frames", 0)
            poses = s.get("positions_total", 0)
            loops = s.get("loops_closed", 0)
            graph_s = s.get("stage_s", {}).get("graph", 0.0)
            sample = {
                "t": round(now - t_start, 1),
                "depth_frames": frames,
                "depth_fps_window": round(
                    (frames - last_frames) / max(now - last_t, 1e-6), 2),
                "slam_batches": s.get("frames"),
                "slam_poses": poses,
                "slam_pose_fps_window": round(
                    (poses - last_poses) / max(now - last_t, 1e-6), 2),
                "keyframes": s.get("keyframes"),
                "loops_closed": loops,
                "backend_pending": s.get("backend_pending"),
                "loop_checks_skipped": s.get("loop_checks_skipped"),
                "culled_keyframes": s.get("culled_keyframes"),
                "fused_dropped": s.get("fused_dropped"),
                "slam_errors": s.get("errors"),
                "pipeline_errors": m.get("errors"),
                "stage_s": s.get("stage_s"),
                "ms_per_closure": (round(graph_s / loops * 1000, 1)
                                   if loops else None),
                "rss_mb": rss_mb(proc.pid),
            }
            samples.append(sample)
            print(json.dumps(sample), flush=True)
            last_frames, last_poses, last_t = frames, poses, now
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()

    if samples:
        ok = [x for x in samples if "error" not in x]
        summary = {
            "minutes": args.minutes,
            "samples": len(samples),
            "first": ok[0] if ok else None,
            "last": ok[-1] if ok else None,
            "rss_mb_min": min((x["rss_mb"] for x in ok if x["rss_mb"]),
                              default=None),
            "rss_mb_max": max((x["rss_mb"] for x in ok if x["rss_mb"]),
                              default=None),
            "backend_pending_max": max(
                (x["backend_pending"] for x in ok
                 if x["backend_pending"] is not None), default=None),
        }
        out = {"summary": summary, "series": samples}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
