"""Depth-map colorization for the visualization stream.

The reference serves raw grayscale disparity; a perceptual colormap makes
depth structure far more readable in the live view. ``turbo_colormap``
implements the Turbo colormap via its published 4th-order polynomial fit
(Google AI blog, 2019) — no lookup-table asset needed.
"""

from __future__ import annotations

import numpy as np

# Polynomial coefficients fit to the Turbo colormap (degree 5 per channel).
_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
               -152.94239396, 59.28637943])
_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
               4.27729857, 2.82956604])
_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
               -89.90310912, 27.34824973])


def _poly(c, x):
    y = np.zeros_like(x)
    for k in c[::-1]:
        y = y * x + k
    return y


def turbo_colormap(values: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] -> (..., 3) uint8 RGB via Turbo."""
    x = np.clip(np.asarray(values, np.float32), 0.0, 1.0)
    rgb = np.stack([_poly(_R, x), _poly(_G, x), _poly(_B, x)], -1)
    return (np.clip(rgb, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)


def colorize_disparity(disp_u8: np.ndarray,
                       invalid_value: int | None = None) -> np.ndarray:
    """uint8 disparity map -> RGB visualization (near = red, far = blue;
    invalid pixels black)."""
    x = disp_u8.astype(np.float32) / 255.0
    rgb = turbo_colormap(x)
    if invalid_value is not None:
        rgb[disp_u8 == invalid_value] = 0
    return rgb


_LUT = None


def turbo_lut() -> np.ndarray:
    """(256, 3) uint8 Turbo lookup table: the polynomial evaluated once
    per possible uint8 disparity value. Host-side colorization via
    ``lut[disp]`` is a single gather (~1 ms at VGA) and lets the serving
    path fetch 1-byte/pixel disparity instead of 3-byte/pixel RGB — a 3x
    cut of the dominant fetch traffic through a bandwidth-limited
    transport (VERDICT r2 directive #6). Bit-identical to
    :func:`colorize_disparity` by construction (same polynomial, same
    quantization, evaluated at the same 256 inputs)."""
    global _LUT
    if _LUT is None:
        _LUT = turbo_colormap(np.arange(256, dtype=np.float32) / 255.0)
    return _LUT


def colorize_disparity_lut(disp_u8: np.ndarray,
                           invalid_value: int | None = None) -> np.ndarray:
    """Host-side LUT colorization, bit-identical to
    :func:`colorize_disparity`."""
    rgb = turbo_lut()[np.asarray(disp_u8)]
    if invalid_value is not None:
        rgb[disp_u8 == invalid_value] = 0
    return rgb


def downscale_u8_jax(img_u8, k: int):
    """On-device k x k mean-pool of a uint8 (H, W) image (rounded integer
    mean, deterministic). Ragged borders are cropped — previews don't need
    them, and static shapes keep the jit bucket stable."""
    import jax.numpy as jnp

    if k == 1:
        return img_u8
    H, W = img_u8.shape
    Hs, Ws = H // k, W // k
    x = img_u8[: Hs * k, : Ws * k].astype(jnp.int32)
    s = x.reshape(Hs, k, Ws, k).sum((1, 3))
    return ((s + k * k // 2) // (k * k)).astype(jnp.uint8)


def colorize_disparity_jax(disp_u8):
    """On-device counterpart of :func:`colorize_disparity` (jnp, jittable):
    lets the serving path fuse colorization into the disparity dispatch so
    the visualization costs no extra host work and no extra host-link
    roundtrip. Same polynomial, same op order as the numpy version."""
    import jax.numpy as jnp

    x = jnp.clip(disp_u8.astype(jnp.float32) / 255.0, 0.0, 1.0)

    def poly(c):
        y = jnp.zeros_like(x)
        for k in c[::-1]:
            y = y * x + jnp.float32(k)
        return y

    rgb = jnp.stack([poly(_R), poly(_G), poly(_B)], -1)
    return (jnp.clip(rgb, 0.0, 1.0) * 255 + 0.5).astype(jnp.uint8)
