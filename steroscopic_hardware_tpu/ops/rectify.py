"""Stereo rectification and undistortion (JAX, jittable).

The reference assumes pre-rectified synchronized sensors (fixed rig, raw
frames straight to matching); for arbitrary stereo cameras the engine
needs calibration handling. This module implements:

* ``bilinear_sample`` / ``remap``  — vectorized image warping
* ``undistort_points`` / ``distort_points`` — Brown-Conrady radial
  (k1, k2, k3) + tangential (p1, p2) model
* ``stereo_rectify`` — Bouguet-style rectifying rotations from a calibrated
  extrinsic (R, T): both optical axes are rotated to be perpendicular to
  the baseline, rows become epipolar lines
* ``rectify_maps`` — inverse sampling maps (rectified pixel -> source
  pixel) combining rectifying rotation + lens distortion
* ``StereoRectifier`` — precomputed-map warper for the streaming path

All math is original; the rectification construction follows the standard
textbook algorithm (Bouguet / Hartley-Zisserman).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np


def bilinear_sample(img: jnp.ndarray, ys: jnp.ndarray,
                    xs: jnp.ndarray) -> jnp.ndarray:
    """Sample img (H, W) at float coords (ys, xs) with border clamping."""
    H, W = img.shape
    I = img.astype(jnp.float32)
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, H - 1)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, W - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    wy = jnp.clip(ys - y0.astype(jnp.float32), 0.0, 1.0)
    wx = jnp.clip(xs - x0.astype(jnp.float32), 0.0, 1.0)
    v00 = I[y0, x0]
    v01 = I[y0, x1]
    v10 = I[y1, x0]
    v11 = I[y1, x1]
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


@jax.jit
def remap(img: jnp.ndarray, map_y: jnp.ndarray,
          map_x: jnp.ndarray) -> jnp.ndarray:
    """Warp: out[y, x] = img[map_y[y, x], map_x[y, x]] (bilinear); samples
    falling outside the source are zeroed."""
    H, W = img.shape
    out = bilinear_sample(img, map_y, map_x)
    inside = (
        (map_y >= 0) & (map_y <= H - 1) & (map_x >= 0) & (map_x <= W - 1)
    )
    return jnp.where(inside, out, 0.0).astype(img.dtype) \
        if jnp.issubdtype(img.dtype, jnp.integer) \
        else jnp.where(inside, out, 0.0)


def distort_points(xn, yn, dist):
    """Apply Brown-Conrady distortion to normalized coords."""
    k1, k2, p1, p2, k3 = dist
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def undistort_points(xd, yd, dist, iters: int = 8):
    """Invert the distortion by fixed-point iteration."""
    xn, yn = xd, yd
    for _ in range(iters):
        xe, ye = distort_points(xn, yn, dist)
        xn = xn + (xd - xe)
        yn = yn + (yd - ye)
    return xn, yn


def stereo_rectify(R: np.ndarray, T: np.ndarray):
    """Bouguet rectifying rotations.

    Args: R (3,3), T (3,) mapping left-camera coords to right-camera
    coords (x_r = R x_l + T). Returns (R1, R2): rotations applied to
    left/right camera frames so that epipolar lines become rows.
    """
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    # right camera center in the left frame; the new x-axis points along
    # the baseline so disparity becomes purely horizontal
    b = -R.T @ T
    e1 = b / np.linalg.norm(b)
    # new y-axis orthogonal to the baseline and to the old optical axis
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    n = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n < 1e-9 else e2 / n
    e3 = np.cross(e1, e2)
    R_rect = np.stack([e1, e2, e3])
    R1 = R_rect
    R2 = R_rect @ R.T
    return R1, R2


def rectify_maps(K, dist, R_rect, K_new, size):
    """Inverse sampling maps for one camera.

    For each rectified pixel: unproject with K_new, rotate back by
    R_rect^T, apply lens distortion, project with K. Returns
    (map_y, map_x) float32 (H, W).
    """
    H, W = size
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    fxn, fyn, cxn, cyn = (
        K_new[0, 0], K_new[1, 1], K_new[0, 2], K_new[1, 2]
    )
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    xn = (xs - cxn) / fxn
    yn = (ys - cyn) / fyn
    pts = np.stack([xn, yn, np.ones_like(xn)], axis=-1)  # (H, W, 3)
    rays = pts @ R_rect  # == (R_rect^T @ p) per pixel
    xr = rays[..., 0] / rays[..., 2]
    yr = rays[..., 1] / rays[..., 2]
    if dist is not None and np.any(np.asarray(dist) != 0):
        xr, yr = distort_points(xr, yr, tuple(np.asarray(dist)))
    map_x = (fx * xr + cx).astype(np.float32)
    map_y = (fy * yr + cy).astype(np.float32)
    return map_y, map_x


class StereoRectifier:
    """Precomputed rectification for the streaming path.

    Args:
      K1, K2: (3,3) intrinsics; dist1, dist2: (k1,k2,p1,p2,k3) or None;
      R, T: extrinsics (x_right = R @ x_left + T);
      size: output (H, W); K_new: shared rectified intrinsics (defaults
      to K1 with principal point centered).
    """

    def __init__(self, K1, dist1, K2, dist2, R, T, size, K_new=None):
        H, W = size
        if K_new is None:
            K_new = np.array(K1, np.float64).copy()
            K_new[0, 2] = W / 2.0
            K_new[1, 2] = H / 2.0
        R1, R2 = stereo_rectify(R, T)
        self.K_new = K_new
        self.baseline = float(np.linalg.norm(T))
        my1, mx1 = rectify_maps(np.asarray(K1), dist1, R1, K_new, size)
        my2, mx2 = rectify_maps(np.asarray(K2), dist2, R2, K_new, size)
        self._maps = (
            jnp.asarray(my1), jnp.asarray(mx1),
            jnp.asarray(my2), jnp.asarray(mx2),
        )

    def __call__(self, left, right):
        my1, mx1, my2, mx2 = self._maps
        return (
            np.asarray(remap(jnp.asarray(left), my1, mx1)),
            np.asarray(remap(jnp.asarray(right), my2, mx2)),
        )
