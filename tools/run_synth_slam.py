#!/usr/bin/env python
"""SLAM quality benchmark on synthetic ground-truth sequences.

Measures trajectory ATE RMSE for pure VO vs. keyframed BA vs. BA + loop
closure on rendered sequences with exact ground truth — the quality
counterpart of bench.py (BASELINE configs #4/#5 stand-in while no KITTI
dataset is mounted).

Round-3 stress content (VERDICT r2 directive #9): opaque occluders,
per-eye photometric gain/offset jitter (auto-exposure model — census/SGM
front-ends shrug, SAD degrades), the non-planar ``helix`` trajectory,
and ``--frontend sgm`` to run the census+SGM engine as the VO front-end.

  python tools/run_synth_slam.py --frames 120 --trajectory loop --noise 2
  python tools/run_synth_slam.py --suite        # multi-sequence table
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from steroscopic_hardware_tpu.utils.device import enable_compile_cache

enable_compile_cache()


def render_sequence(args, seed=None):
    from steroscopic_hardware_tpu.models.slam import StereoCamera
    from steroscopic_hardware_tpu.utils.synth import (
        SyntheticScene, gt_positions, helix_trajectory, loop_trajectory,
        straight_trajectory,
    )

    seed = args.seed if seed is None else seed
    cam = StereoCamera(fx=240.0, fy=240.0, cx=160.0, cy=120.0, baseline=0.4)
    scene = SyntheticScene(cam, n_landmarks=args.landmarks, seed=seed,
                           n_occluders=args.occluders)
    if args.trajectory == "straight":
        xis = straight_trajectory(args.frames)
    else:
        fn = {"loop": loop_trajectory, "helix": helix_trajectory}[
            args.trajectory]
        xis = fn(args.frames, circuits=args.circuits)
    nrng = np.random.default_rng(seed + 7)
    frames = []
    for xi in xis:
        # per-eye auto-exposure: independent gain/offset draws each frame
        g = 1.0 + nrng.normal(0.0, args.gain_jitter, 2)
        o = nrng.normal(0.0, args.offset_jitter, 2)
        frames.append(scene.render_pair(
            xi, noise=args.noise, noise_rng=nrng, gain=tuple(g),
            offset=tuple(o)))
    return cam, frames, gt_positions(xis)


def run_engines(args, cam, frames, gt, engines=None):
    from steroscopic_hardware_tpu.models.slam import (
        StereoSLAM, StereoVO, ate_rmse,
    )

    kwargs = dict(block_size=7, max_disparity=32, max_keypoints=128,
                  fast_threshold=15, frontend=args.frontend)
    use_async = getattr(args, "async_backend", False)
    if engines is None:
        engines = {
            "vo": StereoVO(cam, **kwargs),
            "vo+ba": StereoSLAM(cam, window=3, kf_every=2, ba_iters=5,
                                async_backend=use_async, **kwargs),
            "vo+ba+loop": StereoSLAM(cam, window=3, kf_every=2,
                                     ba_iters=5, loop_closure=True,
                                     loop_min_matches=15, loop_gap=10,
                                     async_backend=use_async, **kwargs),
        }
    out = []
    for name, eng in engines.items():
        t0 = time.time()
        frame_ts = []
        for left, right in frames:
            tf = time.time()
            eng.process(left, right)
            frame_ts.append(time.time() - tf)
        frame_dt = time.time() - t0
        if hasattr(eng, "finish"):
            eng.finish()
        dt = time.time() - t0
        vo = eng.vo if hasattr(eng, "vo") else eng
        ate = ate_rmse(vo.positions(), gt)
        rec = {
            "engine": name,
            "frontend": args.frontend,
            "ate_rmse_m": round(ate, 4),
            "fps": round(len(frames) / dt, 2),
            "frame_loop_fps": round(len(frames) / frame_dt, 2),
            "frame_p95_ms": round(
                1e3 * float(np.percentile(frame_ts, 95)), 1),
            "frame_max_ms": round(1e3 * max(frame_ts), 1),
            "min_inliers": int(min(vo.n_inliers[1:])),
            "tracking_drops": vo.tracking_drops,
            "loops_closed": getattr(eng, "loops_closed", 0),
        }
        if hasattr(eng, "stage_s"):
            s = dict(eng.stage_s)
            s["loop"] -= s["graph"]  # loop = retrieval/verify only
            rec["stage_s"] = {k: round(v, 2) for k, v in s.items()}
            # compiled-variant count for the bucketed pose-graph solver:
            # O(log M) buckets over a whole run, not O(M) recompiles
            from steroscopic_hardware_tpu.models.slam import (
                pose_graph_optimize,
            )
            rec["graph_compiles"] = pose_graph_optimize._cache_size()
        if hasattr(eng, "close"):
            eng.close()
        out.append(rec)
        extra = ""
        if "stage_s" in rec:
            st = rec["stage_s"]
            extra = (f"  stages vo {st['vo']:.1f}s ba {st['ba']:.1f}s "
                     f"loop {st['loop']:.1f}s graph {st['graph']:.1f}s"
                     f" ({rec['graph_compiles']} graph compiles)")
        print(json.dumps(rec) if args.json else
              f"{name:12s} [{args.frontend}] ATE {rec['ate_rmse_m']:.4f} m"
              f"  {rec['fps']:6.1f} fps  min_inliers {rec['min_inliers']}"
              f"  drops {rec['tracking_drops']}"
              f"  loops {rec['loops_closed']}" + extra, flush=True)
    return out


def run_suite(args):
    """Multi-sequence stress table: every condition x {sad, sgm}
    front-end, VO and VO+BA+loop engines."""
    import copy

    conditions = [
        ("clean loop", dict(trajectory="loop", noise=2.0, occluders=0,
                            gain_jitter=0.0, offset_jitter=0.0)),
        ("occluded loop", dict(trajectory="loop", noise=2.0, occluders=6,
                               gain_jitter=0.0, offset_jitter=0.0)),
        ("photometric loop", dict(trajectory="loop", noise=2.0,
                                  occluders=0, gain_jitter=0.12,
                                  offset_jitter=14.0)),
        ("helix (non-planar)", dict(trajectory="helix", noise=2.0,
                                    occluders=0, gain_jitter=0.0,
                                    offset_jitter=0.0)),
        ("full stress helix", dict(trajectory="helix", noise=2.0,
                                   occluders=6, gain_jitter=0.12,
                                   offset_jitter=14.0)),
    ]
    rows = []
    for label, cond in conditions:
        for fe in ("sad", "sgm"):
            a = copy.copy(args)
            for k, v in cond.items():
                setattr(a, k, v)
            a.frontend = fe
            print(f"--- {label} / {fe} ---", flush=True)
            cam, frames, gt = render_sequence(a)
            recs = run_engines(a, cam, frames, gt)
            for r in recs:
                r["condition"] = label
            rows.extend(recs)
    print("\n| condition | frontend | engine | ATE (m) | drops | loops |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['condition']} | {r['frontend']} | {r['engine']} | "
              f"{r['ate_rmse_m']:.4f} | {r['tracking_drops']} | "
              f"{r['loops_closed']} |")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trajectory", default="straight",
                    choices=["straight", "loop", "helix"])
    ap.add_argument("--noise", type=float, default=0.0,
                    help="Gaussian pixel-noise sigma (sensor model)")
    ap.add_argument("--circuits", type=int, default=1,
                    help="loop/helix circuits (multi-loop sequences)")
    ap.add_argument("--occluders", type=int, default=0,
                    help="number of opaque near-field occluder objects")
    ap.add_argument("--gain-jitter", type=float, default=0.0,
                    dest="gain_jitter",
                    help="per-eye per-frame gain sigma (AE model)")
    ap.add_argument("--offset-jitter", type=float, default=0.0,
                    dest="offset_jitter",
                    help="per-eye per-frame offset sigma (gray levels)")
    ap.add_argument("--frontend", default="sad", choices=["sad", "sgm"])
    ap.add_argument("--async-backend", action="store_true",
                    dest="async_backend",
                    help="run BA/loop-closure in the backend worker "
                         "(the live-serving mode); finish() drains it "
                         "before ATE is computed")
    ap.add_argument("--suite", action="store_true",
                    help="run the multi-sequence stress table")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    if args.suite:
        run_suite(args)
        return
    cam, frames, gt = render_sequence(args)
    run_engines(args, cam, frames, gt)


if __name__ == "__main__":
    main()
