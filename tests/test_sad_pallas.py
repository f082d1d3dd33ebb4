"""SAD kernel (``ops/sad_pallas.py``) bit-exactness, in interpret mode.

The compiled kernel runs on the card (``chip_smoke.py`` phase 3 and the
``gpu``-marked test below); here the Pallas interpreter validates the same
kernel body, its LR/subpixel/batch variants and the wrapper's tiling and
padding against the numpy cost-volume reference, which is itself validated
against the literal Go semantics in ``test_sad_bitexact.py``.
"""

import numpy as np
import pytest

from steroscopic_hardware_tpu.ops.sad_golden import disparity_numpy
from steroscopic_hardware_tpu.ops.sad_pallas import (
    _sweep,
    disparity_pallas,
    tile_shape,
)


def _pair(rng, h, w):
    left = rng.integers(0, 256, (h, w), dtype=np.uint8)
    right = np.clip(
        np.roll(left, -4, axis=1).astype(int) + rng.integers(-2, 3, (h, w)),
        0,
        255,
    ).astype(np.uint8)
    return left, right


@pytest.mark.parametrize("tile", ["default", "wide"])
@pytest.mark.parametrize(
    "h,w,block,maxd",
    [
        (20, 26, 3, 16),    # tiny, single tile
        (40, 60, 7, 16),
        (33, 31, 31, 16),   # max block, heavy borders
        (64, 130, 9, 48),   # several column tiles
        (100, 90, 16, 64),  # even block size, several row tiles
        (48, 64, 5, 256),   # maxD >> W
    ],
)
def test_pallas_vs_numpy(rng, tile, h, w, block, maxd):
    left, right = _pair(rng, h, w)
    want = disparity_numpy(left, right, block, maxd)
    tr, tc = tile_shape(block)
    (got,) = _sweep(left[None], right[None], block_size=block,
                    max_disparity=maxd, interpret=True,
                    tile=None if tile == "default" else (tr, 2 * tc))
    got = np.asarray(got)[0]
    assert np.array_equal(want, got), np.argwhere(want != got)[:5]


def test_pallas_real_crop(stereo_pair_small):
    left, right = stereo_pair_small
    lc, rc = left[100:180, 100:260], right[100:180, 100:260]
    want = disparity_numpy(lc, rc, 7, 64)
    got = np.asarray(
        disparity_pallas(lc, rc, block_size=7, max_disparity=64,
                         interpret=True)
    )
    assert np.array_equal(want, got)


@pytest.mark.parametrize(
    "h,w,block,maxd",
    [
        (40, 60, 7, 16),
        (20, 26, 3, 16),   # winners at d=0 for unshifted texture
        (33, 31, 31, 16),  # max block, heavy borders
        (8, 8, 7, 256),    # maxD >> W: most candidates invalid
        (48, 130, 9, 48),  # several tiles
    ],
)
def test_pallas_subpixel_matches_xla(rng, h, w, block, maxd):
    """The subpixel path (in-kernel neighbour-cost tracking) must agree
    with the XLA one-sweep subpixel+LR implementation exactly, incl.
    winner-at-d=0 / winner-at-maxD / heavy-border edge cases."""
    from steroscopic_hardware_tpu.ops.sad_pallas import (
        disparity_pallas_subpixel,
    )
    from steroscopic_hardware_tpu.ops.sad_xla import (
        disparity_subpixel_lr_xla,
        disparity_subpixel_xla,
    )

    for structured in (True, False):
        if structured:
            left, right = _pair(rng, h, w)
        else:
            left = rng.integers(0, 256, (h, w), dtype=np.uint8)
            right = rng.integers(0, 256, (h, w), dtype=np.uint8)
        sub_p, dR_p = disparity_pallas_subpixel(
            left, right, block_size=block, max_disparity=maxd,
            interpret=True,
        )
        sub_x, dR_x = disparity_subpixel_lr_xla(
            left, right, block_size=block, max_disparity=maxd)
        assert np.array_equal(np.asarray(sub_p), np.asarray(sub_x))
        assert np.array_equal(np.asarray(dR_p), np.asarray(dR_x))
        plain = disparity_subpixel_xla(left, right, block_size=block,
                                       max_disparity=maxd)
        assert np.allclose(np.asarray(sub_p), np.asarray(plain), atol=1e-5)


def test_pallas_lr_matches_xla(rng):
    from steroscopic_hardware_tpu.ops.sad_pallas import disparity_pallas_lr
    from steroscopic_hardware_tpu.ops.sad_xla import disparity_raw_lr_xla

    left, right = _pair(rng, 33, 31)
    a = disparity_raw_lr_xla(left, right, block_size=15, max_disparity=16)
    b = disparity_pallas_lr(left, right, block_size=15, max_disparity=16,
                            interpret=True)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("tile", [(16, 64), (32, 64), (32, 128), (64, 64)])
def test_tile_shape_bit_exact(rng, tile):
    """Any power-of-two tile whose interior is non-empty gives the same
    map: tiles overlap by the 2h halo and store only their interior."""
    left, right = _pair(rng, 37, 53)
    ref = disparity_numpy(left, right, 7, 20)
    (got,) = _sweep(left[None], right[None], block_size=7,
                    max_disparity=20, tile=tile, interpret=True)
    assert np.array_equal(np.asarray(got)[0], ref), tile


def test_batch_matches_single(rng):
    """The batched launch (frame x row tile x column tile grid) must be
    bit-identical per frame to separate single-frame calls."""
    from steroscopic_hardware_tpu.ops.sad_pallas import (
        disparity_pallas_batch,
    )

    F, H, W = 3, 37, 53
    lefts = rng.integers(0, 256, (F, H, W), dtype=np.uint8)
    rights = np.clip(
        np.roll(lefts, -4, axis=2).astype(int)
        + rng.integers(-2, 3, (F, H, W)),
        0, 255,
    ).astype(np.uint8)
    got = np.asarray(disparity_pallas_batch(
        lefts, rights, block_size=7, max_disparity=20, interpret=True,
    ))
    for f in range(F):
        want = disparity_numpy(lefts[f], rights[f], 7, 20)
        assert np.array_equal(got[f], want), f


@pytest.mark.parametrize("block", [3, 5, 7, 9, 11, 13, 15, 16, 17, 19, 21,
                                   23, 25, 27, 29, 31])
def test_tile_shape_keeps_interior(block):
    """Across the whole block envelope the default tiles are powers of
    two and keep at least half their rows and 3/4 of their columns as
    interior outputs, for both the plain and the LR sweeps."""
    h = block // 2
    for lr in (False, True):
        tr, tc = tile_shape(block, lr)
        assert tr & (tr - 1) == 0 and tc & (tc - 1) == 0
        assert (tr - 2 * h) * 2 >= tr, (block, lr, tr)
        assert (tc - 2 * h) * 4 >= 3 * tc, (block, lr, tc)
        assert tr >= 16 and tc >= 16  # tensor-core operand minimum


@pytest.mark.parametrize("h,w", [(1, 40), (7, 5), (2, 2)])
def test_degenerate_frames(rng, h, w):
    """Frames smaller than one tile and than the window are padded, not
    rejected, and still match the golden model."""
    left, right = _pair(rng, h, w)
    want = disparity_numpy(left, right, 5, 16)
    got = np.asarray(disparity_pallas(left, right, block_size=5,
                                      max_disparity=16, interpret=True))
    assert got.shape == (h, w) and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_wrapper_rejects_bad_shapes(rng):
    a = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    with pytest.raises(ValueError):
        disparity_pallas(a, a[:, :4], block_size=3, max_disparity=16,
                         interpret=True)
    with pytest.raises(ValueError):
        disparity_pallas(a[None], a[None], block_size=3, max_disparity=16,
                         interpret=True)
    with pytest.raises(ValueError, match="too small"):
        _sweep(a[None], a[None], block_size=31, max_disparity=16,
               tile=(16, 64), interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_golden(stereo_pair_small):
    """The kernel as compiled for the card (no interpreter), full VGA."""
    left, right = stereo_pair_small
    got = np.asarray(disparity_pallas(left, right, block_size=7,
                                      max_disparity=64))
    assert np.array_equal(got, disparity_numpy(left, right, 7, 64))
