#!/usr/bin/env python
"""Full parameter-sweep runner (BASELINE config #2): every block size
3-31 (odd) x max disparity 16-256 (step 16) on seeded fixture pairs
(``utils/fixtures.py``), with optional left-right consistency, reporting
Mpix/s per configuration. Host time around a synchronous ``compute`` (it
returns a host array), mean of ``-n`` runs; the device is named in every
record.

240 configurations = 240 kernel compiles on the first run; the persistent
compilation cache (JAX_COMPILATION_CACHE_DIR) makes reruns cheap. Use
--blocks/--disps to sweep subsets.

  python tools/run_sweep.py --seeds 0 --blocks 7,15 --disps 64,128
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3",
                    help="fixture pair seeds")
    ap.add_argument("--size", default="640x480", help="WIDTHxHEIGHT")
    ap.add_argument("--blocks", default=",".join(str(b) for b in range(3, 32, 2)))
    ap.add_argument("--disps", default=",".join(str(d) for d in range(16, 257, 16)))
    ap.add_argument("--lr-check", action="store_true")
    ap.add_argument("--engine", default="sad", choices=["sad", "sgm"],
                    help="sad = block matching (block x disp grid); "
                         "sgm = semi-global matching (disp grid; block "
                         "sizes are ignored — SGM has none)")
    ap.add_argument("-n", type=int, default=5, help="timed reps per config")
    ap.add_argument("--json", action="store_true", help="JSON-lines output")
    args = ap.parse_args()

    import jax

    from steroscopic_hardware_tpu.ops.lr_check import disparity_lr_checked
    from steroscopic_hardware_tpu.models.blockmatch import (
        BlockMatcher,
        SGMMatcher,
    )
    from steroscopic_hardware_tpu.utils.device import enable_compile_cache
    from steroscopic_hardware_tpu.utils.fixtures import (
        parse_size,
        stereo_pair,
    )
    from steroscopic_hardware_tpu.utils.params import Parameters

    enable_compile_cache()
    dev = jax.devices()[0]
    pairs = {}
    for seed in args.seeds.split(","):
        left, right, _ = stereo_pair(parse_size(args.size), int(seed))
        pairs[seed] = (jax.device_put(left), jax.device_put(right))

    if args.engine == "sgm":
        matcher = SGMMatcher()
        blocks = [0]  # SGM has no block size; one row per disparity
    else:
        matcher = BlockMatcher(backend="auto")
        blocks = [int(b) for b in args.blocks.split(",")]
    disps = [int(d) for d in args.disps.split(",")]
    for b in blocks:
        for d in disps:
            matcher.set_params(Parameters(b or 7, d))
            for name, (L, R) in pairs.items():
                t_c = time.time()
                out = matcher.compute(L, R)  # compile + first run
                compile_s = time.time() - t_c
                t0 = time.time()
                for _ in range(args.n):
                    out = matcher.compute(L, R)
                dt = (time.time() - t0) / args.n
                rec = {
                    "pair": name, "engine": args.engine,
                    "block": b, "disp": d,
                    "ms": round(dt * 1000, 2),
                    "mpix_s": round(out.size / 1e6 / dt, 1),
                    "compile_s": round(compile_s, 1),
                    "device_kind": dev.device_kind,
                }
                if args.lr_check:
                    if args.engine == "sgm":
                        _, valid = matcher.compute_checked(L, R)
                    else:
                        _, valid = disparity_lr_checked(
                            L, R, block_size=b, max_disparity=d
                        )
                    rec["lr_valid_frac"] = round(
                        float(np.asarray(valid).mean()), 3
                    )
                print(json.dumps(rec) if args.json else
                      f"pair {name} {args.engine} b={b:2d} D={d:3d}: "
                      f"{rec['ms']:8.2f} ms {rec['mpix_s']:7.1f} Mpix/s"
                      + (f"  lr_valid={rec.get('lr_valid_frac')}"
                         if args.lr_check else ""))


if __name__ == "__main__":
    main()
