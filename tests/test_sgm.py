"""Census transform and SGM disparity tests.

The XLA engine is checked against an independent NumPy implementation
(census codes, Hamming volume, the four scanline recursions, first-minimum
argmin and the subpixel parabola) over integer and fractional penalties,
the P2 values around every storage boundary earlier engines used, widths
that are not multiples of 128, and disparity ranges up to 256.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from steroscopic_hardware_tpu.ops.census import (
    census5x5,
    census_cost_volume,
    popcount32,
)
from steroscopic_hardware_tpu.ops.sgm import sgm_disparity


def test_popcount(rng):
    x = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    got = np.asarray(popcount32(jnp.asarray(x)))
    want = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(got, want)


def test_census_invariant_to_gain_offset(rng):
    img = rng.integers(10, 200, (32, 40), dtype=np.uint8)
    # census depends only on sign of neighbor differences -> monotone
    # transforms preserve codes (here: +20 offset, no saturation)
    brighter = (img + 20).astype(np.uint8)
    a = np.asarray(census5x5(jnp.asarray(img)))
    b = np.asarray(census5x5(jnp.asarray(brighter)))
    assert np.array_equal(a, b)


def test_cost_volume_zero_on_true_shift(rng):
    left = rng.integers(0, 256, (24, 64), dtype=np.uint8)
    shift = 5
    right = np.roll(left, -shift, axis=1)
    vol = np.asarray(
        census_cost_volume(jnp.asarray(left), jnp.asarray(right),
                           max_disparity=16)
    )
    # away from the wrap column and left border, cost at d=shift is 0
    assert (vol[shift, 4:-4, 24:56] == 0).mean() > 0.95
    # and other disparities are mostly nonzero for random texture
    assert (vol[0, 4:-4, 24:56] > 0).mean() > 0.9


def test_sgm_recovers_shift_including_textureless(rng):
    """SGM's smoothness term propagates disparity through a textureless
    hole where plain block matching is ambiguous."""
    left = rng.integers(0, 256, (48, 96), dtype=np.uint8)
    left[16:32, 30:60] = 120  # textureless block
    shift = 4
    right = np.roll(left, -shift, axis=1)
    disp = np.asarray(
        sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                      max_disparity=16)
    )
    inner = disp[8:-8, 20:80]
    assert np.abs(inner - shift).mean() < 0.5
    # inside the textureless hole specifically
    hole = disp[20:28, 36:54]
    assert np.abs(hole - shift).mean() < 0.75


def test_sgm_subpixel_within_half_pixel(rng):
    left = rng.integers(0, 256, (32, 80), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    d = np.asarray(
        sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                      max_disparity=8, subpixel=True)
    )
    inner = d[4:-4, 16:70]
    assert np.abs(inner - 3).max() <= 0.5 + 1e-6


def test_sgm_on_real_pair_smoke(stereo_pair_small):
    """A crop of the seeded VGA fixture: valid range, real structure."""
    left, right = stereo_pair_small
    lc = left[180:244, 200:360]
    rc = right[180:244, 200:360]
    disp = np.asarray(
        sgm_disparity(jnp.asarray(lc), jnp.asarray(rc), max_disparity=32)
    )
    assert disp.shape == lc.shape
    assert 0 <= disp.min() and disp.max() <= 32
    assert disp.std() > 0.1  # nontrivial structure


def test_sgm_matcher_in_pipeline_protocol(rng):
    from steroscopic_hardware_tpu.models.blockmatch import SGMMatcher
    from steroscopic_hardware_tpu.utils.params import Parameters

    m = SGMMatcher()
    m.set_params(Parameters(7, 16))
    left = rng.integers(0, 256, (32, 64), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    out = m.compute(left, right)
    assert out.dtype == np.uint8 and out.shape == left.shape
    raw = m.compute_raw(left, right)
    assert np.abs(raw[8:-8, 16:48] - 4).mean() < 0.5


def test_sgm_lr_left_matches_plain(rng):
    """sgm_disparity_lr's left map must equal sgm_disparity exactly
    (same volume, same argmin/subpixel math)."""
    from steroscopic_hardware_tpu.ops.sgm import (
        sgm_disparity,
        sgm_disparity_lr,
    )

    left = rng.integers(0, 256, (40, 80), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    a = np.asarray(sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                                 max_disparity=16))
    b, dR = sgm_disparity_lr(jnp.asarray(left), jnp.asarray(right),
                             max_disparity=16)
    assert np.array_equal(a, np.asarray(b))
    # the right map recovers the same shift over the interior
    assert np.abs(np.asarray(dR)[10:-10, 10:-30] - 3).mean() < 0.5


def test_sgm_lr_checked_gates_mismatches(rng):
    """On a half-consistent scene the LR gate must keep consistent pixels
    and reject the uncorrelated half."""
    from steroscopic_hardware_tpu.ops.sgm import sgm_lr_checked

    left = rng.integers(0, 256, (48, 96), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    # destroy correspondence in the right half of the right image
    right[:, 48:] = rng.integers(0, 256, (48, 48), dtype=np.uint8)
    disp, valid = sgm_lr_checked(
        jnp.asarray(left), jnp.asarray(right), max_disparity=16)
    valid = np.asarray(valid)
    assert valid[8:-8, 8:40].mean() > 0.8      # consistent region survives
    assert valid[8:-8, 56:-8].mean() < 0.5     # uncorrelated region gated


def test_sgm_matcher_compute_checked(rng):
    from steroscopic_hardware_tpu.models.blockmatch import SGMMatcher
    from steroscopic_hardware_tpu.utils.params import Parameters

    m = SGMMatcher(params=Parameters(7, 16))
    left = rng.integers(0, 256, (32, 64), dtype=np.uint8)
    right = np.roll(left, -4, axis=1)
    out, valid = m.compute_checked(left, right)
    assert out.dtype == np.uint8 and out.shape == left.shape
    assert valid.dtype == bool and valid[8:-8, 8:40].mean() > 0.7


# -- NumPy reference ------------------------------------------------------


def _census_np(img):
    H, W = img.shape
    I = img.astype(np.int32)
    code = np.zeros((H, W), np.uint32)
    bit = 0
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if (dy, dx) == (0, 0):
                continue
            ys = np.clip(np.arange(H) + dy, 0, H - 1)
            xs = np.clip(np.arange(W) + dx, 0, W - 1)
            code |= (I[ys][:, xs] < I).astype(np.uint32) << np.uint32(bit)
            bit += 1
    return code


def _cost_np(left, right, D):
    cl, cr = _census_np(left), _census_np(right)
    H, W = left.shape
    vol = np.full((D + 1, H, W), 24, np.float32)
    for d in range(min(D, W - 1) + 1):
        vol[d, :, d:] = np.bitwise_count(cl[:, d:] ^ cr[:, :W - d])
    return vol


def _scan_np(cost, P1, P2, axis, reverse):
    """One scanline direction of the SGM recursion, literally."""
    vol = np.moveaxis(cost, axis, 0)
    if reverse:
        vol = vol[::-1]
    out = np.empty_like(vol)
    prev = out[0] = vol[0]
    inf = np.full_like(prev[:1], 1e9)
    for s in range(1, len(vol)):
        m = prev.min(0, keepdims=True)
        up = np.concatenate([prev[1:], inf])
        dn = np.concatenate([inf, prev[:-1]])
        best = np.minimum(np.minimum(prev, np.minimum(up, dn) + P1), m + P2)
        prev = out[s] = vol[s] + best - m
    if reverse:
        out = out[::-1]
    return np.moveaxis(out, 0, axis)


def _aggregate_np(cost, P1, P2, axis):
    return (_scan_np(cost, P1, P2, axis, False)
            + _scan_np(cost, P1, P2, axis, True))


def _sgm_np(left, right, D, P1, P2, subpixel):
    cost = _cost_np(left, right, D)
    agg = _aggregate_np(cost, P1, P2, 2) + _aggregate_np(cost, P1, P2, 1)
    n = agg.shape[0]
    d = np.argmin(agg, axis=0)
    if not subpixel:
        return d.astype(np.float32), agg
    dc = np.clip(d, 1, n - 2)
    c0, c1, c2 = (np.take_along_axis(agg, (dc + k)[None], 0)[0]
                  for k in (-1, 0, 1))
    denom = np.maximum(c0 - 2 * c1 + c2, np.float32(1e-6))
    delta = np.clip(np.float32(0.5) * (c0 - c2) / denom, -0.5, 0.5)
    return np.where((d >= 1) & (d <= n - 2), dc + delta,
                    d).astype(np.float32), agg


def _noisy_pair(rng, h, w, shift):
    left = rng.integers(0, 256, (h, w), dtype=np.uint8)
    right = np.clip(np.roll(left, shift, axis=1).astype(int)
                    + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.uint8)
    return left, right


def test_census_volume_matches_numpy(rng):
    left, right = _noisy_pair(rng, 37, 61, -3)
    got = np.asarray(census_cost_volume(jnp.asarray(left),
                                        jnp.asarray(right),
                                        max_disparity=12))
    assert np.array_equal(got.astype(np.float32), _cost_np(left, right, 12))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("P1,P2", [(1.0, 8.0), (0.7, 5.3)])
def test_aggregate_axis_matches_numpy(rng, axis, P1, P2):
    from steroscopic_hardware_tpu.ops.sgm import _aggregate_axis

    cost = rng.integers(0, 25, (17, 40, 72)).astype(np.float32)
    got = np.asarray(_aggregate_axis(jnp.asarray(cost), P1, P2, axis=axis))
    np.testing.assert_array_equal(got, _aggregate_np(cost, P1, P2, axis))


@pytest.mark.parametrize(
    "h,w,D,P1,P2,subpixel,shift",
    [
        (40, 80, 16, 1.0, 8.0, True, -3),     # defaults
        (40, 80, 16, 1.0, 8.0, False, -3),
        (40, 80, 16, 0.7, 5.3, True, -3),     # fractional penalties
        (40, 80, 16, 1.5, 110.5, True, -3),
        (40, 80, 16, 2.0, 40.0, True, -3),    # P2 storage boundaries
        (40, 80, 16, 2.0, 48.0, True, -3),
        (40, 80, 16, 1.0, 103.0, False, -3),
        (40, 80, 16, 1.0, 104.0, True, -3),
        (40, 80, 16, 1.0, 105.0, True, -3),
        (48, 64, 16, 1.0, 8.0, True, 0),      # winners at d = 0
        (48, 64, 16, 1.0, 8.0, True, -15),    # winners near d = D - 1
        (37, 61, 12, 1.0, 8.0, True, -3),     # odd, non-128 widths
        (48, 130, 32, 1.0, 8.0, True, -5),
        (16, 300, 256, 1.0, 8.0, True, -9),   # D at the envelope edge
        (296, 40, 12, 1.0, 8.0, False, -2),   # long vertical scans
    ],
)
def test_sgm_matches_numpy_reference(rng, h, w, D, P1, P2, subpixel, shift):
    left, right = _noisy_pair(rng, h, w, shift)
    want, _ = _sgm_np(left, right, D, P1, P2, subpixel)
    got = np.asarray(sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                                   max_disparity=D, P1=P1, P2=P2,
                                   subpixel=subpixel))
    assert got.shape == (h, w) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", [16, 64])
def test_sgm_right_map_matches_numpy(rng, D):
    """The right-referenced map is the first-minimum argmin over the
    diagonal agg[d, y, xr + d] of the same summed volume."""
    from steroscopic_hardware_tpu.ops.sgm import sgm_disparity_lr

    left, right = _noisy_pair(rng, 32, 96, -4)
    _, agg = _sgm_np(left, right, D, 1.0, 8.0, False)
    n, H, W = agg.shape
    costR = np.full((n, H, W), np.inf, np.float32)
    for d in range(n):
        costR[d, :, :W - d] = agg[d, :, d:]
    _, dR = sgm_disparity_lr(jnp.asarray(left), jnp.asarray(right),
                             max_disparity=D)
    np.testing.assert_array_equal(np.asarray(dR), np.argmin(costR, axis=0))
