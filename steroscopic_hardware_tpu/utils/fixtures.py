"""Seeded stereo fixtures: textured rectified pairs with known disparity.

The server's default boot, the tests, ``bench.py``, the examples and the
tools all draw their stereo pairs from here, so nothing depends on an
external image tree. A pair is generated from ``seed`` at any size; the two
the system is specified at are VGA (640x480, BASELINE config #1) and the
reference's VITA-2000 capture (1920x1080, ``BASELINE.md``).

Scene: a band-limited random texture seen at a slanted background plane
plus a few fronto-parallel boxes nearer the rig. The left image samples the
texture at ``x - d(y, x)``, so ``left[y, x] == right[y, x - d]`` wherever
that pixel is in view. Disparities stay below 64, the reference default.

CLI (writes 8-bit gray PNGs)::

    python -m steroscopic_hardware_tpu.utils.fixtures --size 1920x1080 \\
        --seed 0 --out DIR
"""

from __future__ import annotations

import argparse
import os

import numpy as np

VGA = (480, 640)
FULL_HD = (1080, 1920)


def disparity_field(size, seed: int = 0) -> np.ndarray:
    """Integer ground-truth disparity (H, W): a background plane rising
    from W/80 at the top to W/40 at the bottom, and three boxes at up to
    W/32 (VGA: 8-20 px, 1080p: 24-60 px)."""
    H, W = size
    rng = np.random.default_rng([seed, 1])
    lo, hi = max(1, W // 80), max(2, W // 40)
    ys = np.arange(H, dtype=np.float64)[:, None]
    d = np.broadcast_to(np.round(lo + (hi - lo) * ys / max(H - 1, 1)),
                        (H, W)).astype(np.int32).copy()
    for _ in range(3):
        h0, w0 = int(rng.integers(H // 8, H // 3)), int(rng.integers(W // 8,
                                                                      W // 4))
        y0, x0 = int(rng.integers(0, H - h0)), int(rng.integers(0, W - w0))
        d[y0:y0 + h0, x0:x0 + w0] = int(rng.integers(hi, max(hi + 1,
                                                             W // 32)))
    return d


def texture(size, seed: int = 0) -> np.ndarray:
    """Band-limited uint8 texture: white noise box-blurred 3x3 over a low-
    frequency shading ramp (SAD and census both need local structure)."""
    H, W = size
    rng = np.random.default_rng([seed, 0])
    n = rng.integers(0, 256, (H + 2, W + 2)).astype(np.float32)
    blur = sum(n[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3))
    ramp = 40.0 * np.sin(np.linspace(0, 3 * np.pi, W))[None, :]
    img = (blur / 9.0 - 127.5) * 1.6 + 127.5 + ramp
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def stereo_pair(size=VGA, seed: int = 0):
    """(left, right, disparity): uint8 (H, W) images and the int32
    ground-truth disparity of every left pixel."""
    H, W = size
    d = disparity_field(size, seed)
    pad = int(d.max())
    tex = texture((H, W + pad), seed)
    right = tex[:, pad:].copy()
    cols = pad + np.arange(W)[None, :] - d
    left = np.take_along_axis(tex, cols, axis=1)
    return left, right, d


def write_pair(out_dir: str, size=VGA, seed: int = 0):
    """Write ``L.png``/``R.png`` (8-bit gray) for ``stereo_pair`` into
    ``out_dir``; returns the two paths."""
    from steroscopic_hardware_tpu.io.png import write_png

    left, right, _ = stereo_pair(size, seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = (os.path.join(out_dir, "L.png"), os.path.join(out_dir, "R.png"))
    for p, img in zip(paths, (left, right)):
        write_png(p, img)
    return paths


def parse_size(text: str):
    """``"1920x1080"`` (width x height) -> (H, W)."""
    w, _, h = text.lower().partition("x")
    return int(h), int(w)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="640x480", help="WIDTHxHEIGHT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args(argv)
    for p in write_pair(args.out, parse_size(args.size), args.seed):
        print(p)


if __name__ == "__main__":
    main()
