#!/usr/bin/env python
"""One-shot SAD disparity on a stereo pair.

Parity with ``examples/run.go:18-36`` (block 16, maxDisparity 64 on its
testdata pair). Without LEFT/RIGHT the seeded 640x480 fixture pair
(``utils/fixtures.py``) is used.

Usage: python examples/run_once.py [LEFT RIGHT [OUT]] [--block N] [--disp N]
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from steroscopic_hardware_tpu.io.png import write_png
from steroscopic_hardware_tpu.models.blockmatch import BlockMatcher
from steroscopic_hardware_tpu.ops.gray import load_gray
from steroscopic_hardware_tpu.utils.fixtures import VGA, stereo_pair
from steroscopic_hardware_tpu.utils.params import Parameters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("left", nargs="?", default=None)
    ap.add_argument("right", nargs="?", default=None)
    ap.add_argument("out", nargs="?", default="disparity.png")
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--disp", type=int, default=64)
    args = ap.parse_args()

    if args.left and args.right:
        left, right = load_gray(args.left), load_gray(args.right)
    else:
        left, right, _ = stereo_pair(VGA, seed=0)
    m = BlockMatcher(params=Parameters(args.block, args.disp))
    t0 = time.time()
    out = m.compute(left, right)
    print(f"computed {out.shape[1]}x{out.shape[0]} disparity "
          f"(block={args.block}, maxDisp={args.disp}) "
          f"in {time.time() - t0:.3f}s (includes compile)")
    write_png(args.out, out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
