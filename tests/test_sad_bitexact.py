"""Bit-exactness ladder for the SAD disparity engine.

Validation chain (each level checked against the one below):
  1. ``disparity_golden_scalar``  — literal Go-semantics loops (the spec)
  2. ``disparity_golden``         — window-vectorized golden
  3. ``disparity_numpy``          — cost-volume reformulation (numpy)
  4. ``disparity_xla``            — jitted XLA path
Level 1 vs 2 and 2 vs 3 prove the border-clipping derivation; 3 vs 4 proves
the scan/chunking machinery. The Pallas kernel is tested in
``test_sad_pallas.py`` against level 3.
"""

import numpy as np
import pytest

from steroscopic_hardware_tpu.ops.sad_golden import (
    disparity_golden,
    disparity_golden_scalar,
    disparity_numpy,
    sad_window_golden,
    sad_window_golden_scalar,
)
from steroscopic_hardware_tpu.ops.sad_xla import disparity_xla


def _rand_pair(rng, h, w, structured=True):
    if structured:
        # Shifted-texture pair: right = left shifted with noise, so argmins
        # are nontrivial and ties occur.
        left = rng.integers(0, 256, (h, w), dtype=np.uint8)
        shift = rng.integers(1, 8)
        right = np.roll(left, -shift, axis=1)
        noise = rng.integers(-2, 3, (h, w))
        right = np.clip(right.astype(int) + noise, 0, 255).astype(np.uint8)
        return left, right
    return (
        rng.integers(0, 256, (h, w), dtype=np.uint8),
        rng.integers(0, 256, (h, w), dtype=np.uint8),
    )


def test_window_scalar_vs_vectorized(rng):
    """General window clipping incl. arbitrary (rx, ry) positions."""
    left = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    right = rng.integers(0, 256, (11, 19), dtype=np.uint8)
    for block in (1, 3, 4, 7, 16):
        for lx in (-2, 0, 3, 12, 16, 18):
            for ly in (-1, 0, 5, 12):
                for rx in (-3, 0, 4, 18, 25):
                    for ry in (0, 2, 10, 12):
                        a = sad_window_golden_scalar(
                            left, right, lx, ly, rx, ry, block
                        )
                        b = sad_window_golden(
                            left, right, lx, ly, rx, ry, block
                        )
                        assert a == b, (block, lx, ly, rx, ry)


@pytest.mark.parametrize("block,maxd", [(3, 8), (7, 8), (4, 5), (16, 16)])
def test_golden_scalar_vs_golden_tiny(rng, block, maxd):
    left, right = _rand_pair(rng, 14, 18)
    a = disparity_golden_scalar(left, right, block, maxd)
    b = disparity_golden(left, right, block, maxd)
    assert np.array_equal(a, b)


@pytest.mark.parametrize(
    "h,w,block,maxd",
    [
        (20, 26, 3, 8),
        (20, 26, 7, 16),
        (16, 40, 5, 48),  # maxD wider than some x: skip-path coverage
        (24, 24, 9, 30),  # maxD not a divisor of 255, odd sweep end
        (12, 90, 16, 64), # even block size (reference default params.go:14-17)
        (33, 31, 31, 16), # max block vs small image: heavy border clipping
        (8, 8, 7, 256),   # maxD >> W: every pixel left-border limited
    ],
)
def test_golden_vs_numpy(rng, h, w, block, maxd):
    for structured in (True, False):
        left, right = _rand_pair(rng, h, w, structured)
        a = disparity_golden(left, right, block, maxd)
        b = disparity_numpy(left, right, block, maxd)
        assert np.array_equal(a, b), (
            f"mismatch at {np.argwhere(a != b)[:5]}"
        )


@pytest.mark.parametrize(
    "h,w,block,maxd,d_chunk",
    [
        (20, 26, 3, 8, 4),
        (20, 26, 7, 16, 16),
        (16, 40, 5, 48, 13),   # chunk not dividing n_d
        (24, 24, 9, 30, 32),   # single chunk larger than sweep
        (12, 90, 16, 64, 16),
        (33, 31, 31, 16, 5),
    ],
)
def test_numpy_vs_xla(rng, h, w, block, maxd, d_chunk):
    left, right = _rand_pair(rng, h, w)
    a = disparity_numpy(left, right, block, maxd)
    b = np.asarray(
        disparity_xla(
            left, right, block_size=block, max_disparity=maxd, d_chunk=d_chunk
        )
    )
    assert np.array_equal(a, b)


def test_xla_batched(rng):
    lefts = np.stack([_rand_pair(rng, 18, 22)[0] for _ in range(3)])
    rights = np.stack([_rand_pair(rng, 18, 22)[1] for _ in range(3)])
    batched = np.asarray(
        disparity_xla(lefts, rights, block_size=7, max_disparity=16)
    )
    for i in range(3):
        single = np.asarray(
            disparity_xla(
                lefts[i], rights[i], block_size=7, max_disparity=16
            )
        )
        assert np.array_equal(batched[i], single)


def test_real_pair_crop_vs_golden(stereo_pair_small):
    """Config #1 anchor (block=7, maxD=64) on a crop of the seeded VGA
    fixture pair."""
    left, right = stereo_pair_small
    lc = left[200:264, 200:328]
    rc = right[200:264, 200:328]
    a = disparity_golden(lc, rc, 7, 64)
    b = np.asarray(disparity_xla(lc, rc, block_size=7, max_disparity=64))
    assert np.array_equal(a, b)


def test_full_frame_numpy_vs_xla(stereo_pair_small):
    """Full 640x480 frame, default-envelope params."""
    left, right = stereo_pair_small
    a = disparity_numpy(left, right, 7, 64)
    b = np.asarray(disparity_xla(left, right, block_size=7, max_disparity=64))
    assert np.array_equal(a, b)


def test_middlebury_pair_crop(stereo_pair_hd, tmp_path):
    """1080p RGB pair: our gray path converts an RGB PNG correctly where
    the reference's *image.RGBA path yields all-zero gray (gray.go:35-37
    8-bit/16-bit mismatch; SURVEY.md section 6: target the algorithm, not
    the artifact). The seeded 1920x1080 fixture stands in for the
    Middlebury im0/im1 pair, written as RGB PNGs."""
    from steroscopic_hardware_tpu.io.png import write_png
    from steroscopic_hardware_tpu.ops.gray import load_gray

    paths = []
    for name, img in zip(("im0.png", "im1.png"), stereo_pair_hd):
        paths.append(str(tmp_path / name))
        write_png(paths[-1], np.repeat(img[..., None], 3, axis=2))
    left, right = load_gray(paths[0]), load_gray(paths[1])
    assert left.shape == (1080, 1920)
    assert left.std() > 10  # NOT the all-zero artifact
    assert np.array_equal(left, stereo_pair_hd[0])
    lc, rc = left[500:564, 600:728], right[500:564, 600:728]
    a = disparity_numpy(lc, rc, 7, 32)
    b = np.asarray(disparity_xla(lc, rc, block_size=7, max_disparity=32))
    assert np.array_equal(a, b)
