#!/usr/bin/env python
"""Streaming benchmark: repeated disparity over seeded fixture pairs
(``utils/fixtures.py``, 640x480, seeds 0-3).

Parity with ``examples/run.stream.go:27-69`` (10-iteration loop printing
per-frame elapsed time), extended with throughput stats.
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from steroscopic_hardware_tpu.models.blockmatch import BlockMatcher
from steroscopic_hardware_tpu.utils.fixtures import VGA, stereo_pair
from steroscopic_hardware_tpu.utils.params import Parameters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=10)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--disp", type=int, default=64)
    args = ap.parse_args()

    frames = [stereo_pair(VGA, seed)[:2] for seed in range(4)]
    m = BlockMatcher(params=Parameters(args.block, args.disp))
    m.compute(*frames[0])  # compile

    times = []
    for i in range(args.n):
        left, right = frames[i % len(frames)]
        t0 = time.time()
        m.compute(left, right)
        dt = time.time() - t0
        times.append(dt)
        print(f"frame {i}: {dt * 1000:.2f} ms")
    arr = np.array(times)
    mpix = frames[0][0].size / 1e6
    print(f"mean {arr.mean() * 1000:.2f} ms  "
          f"p50 {np.median(arr) * 1000:.2f} ms  "
          f"{1 / arr.mean():.1f} fps  {mpix / arr.mean():.1f} Mpix/s")


if __name__ == "__main__":
    main()
