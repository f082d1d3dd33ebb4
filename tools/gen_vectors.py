#!/usr/bin/env python
"""Golden-vector generator.

The reference generates HDL test vectors by cropping random patches from
a stereo pair and computing integral-image SAD golden disparities
(``hardware/test.py``; consumed by ``hardware/ez_tb.v`` via $readmemh).
This tool keeps that workflow: it emits ``.raw`` patch pairs, ``.mem``
hex golden disparity vectors (one byte per line, the $readmemh format),
and ``.pgm`` visualizations from the bit-exact golden model — usable both
for this framework's regression fixtures and for exercising the original
Verilog testbenches against our implementation.

Usage: python tools/gen_vectors.py OUTDIR [--n 4] [--size 128]
       [--block 15] [--disp 64] [--seed 0] [--left L.png --right R.png]

Without ``--left``/``--right`` the crops come from the seeded 640x480
fixture pair (``utils/fixtures.py``, seed ``--seed``).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from steroscopic_hardware_tpu.io.pgm import write_pgm
from steroscopic_hardware_tpu.ops.gray import load_gray
from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
from steroscopic_hardware_tpu.utils.fixtures import VGA, stereo_pair


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--block", type=int, default=15)
    ap.add_argument("--disp", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--left", default=None)
    ap.add_argument("--right", default=None)
    args = ap.parse_args()

    os.makedirs(args.outdir, exist_ok=True)
    if args.left and args.right:
        left, right = load_gray(args.left), load_gray(args.right)
    else:
        left, right, _ = stereo_pair(VGA, args.seed)
    rng = np.random.default_rng(args.seed)
    H, W = left.shape
    s = args.size

    for i in range(args.n):
        y = int(rng.integers(0, H - s))
        x = int(rng.integers(0, W - s))
        lp, rp = left[y : y + s, x : x + s], right[y : y + s, x : x + s]
        gold = disparity_numpy(lp, rp, args.block, args.disp)

        base = os.path.join(args.outdir, f"case{i}")
        lp.tofile(base + "_L.raw")
        rp.tofile(base + "_R.raw")
        with open(base + "_exp_disp.mem", "w") as f:
            for v in gold.reshape(-1):
                f.write(f"{v:02x}\n")
        write_pgm(base + "_disp.pgm", gold)
        print(f"case{i}: crop ({y},{x}) {s}x{s} "
              f"block={args.block} disp={args.disp}")


if __name__ == "__main__":
    main()
