"""Stereo visual odometry: triangulation, PnP (Gauss-Newton on SE(3)),
vectorized RANSAC, and the frame-to-frame VO loop.

New scope over the reference per the BASELINE north star ("FAST+ORB
matching + PnP + sliding-window BA"). Accelerator-first design: fixed-K keypoint
sets with validity masks, RANSAC hypotheses evaluated as one vmapped
batch, Gauss-Newton iterations as ``lax.scan`` bodies with autodiff
jacobians — no data-dependent control flow.

Conventions: pose ``(R, t)`` maps world -> camera; camera intrinsics
``(fx, fy, cx, cy)``; stereo baseline ``b`` with rectified horizontal
disparity ``d = fx * b / z``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from steroscopic_hardware_tpu.ops import se3


def triangulate_stereo(xy, disparity, fx, fy, cx, cy, baseline,
                       min_disparity=0.5):
    """Back-project keypoints using rectified stereo disparity.

    Args:
      xy: (K, 2) pixel coords [u, v] (left camera).
      disparity: (K,) raw disparity in pixels.
    Returns (pts (K, 3) camera-frame, valid (K,) bool).
    """
    d = jnp.asarray(disparity, jnp.float32)
    valid = d > min_disparity
    z = fx * baseline / jnp.maximum(d, min_disparity)
    u, v = xy[..., 0].astype(jnp.float32), xy[..., 1].astype(jnp.float32)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    return jnp.stack([x, y, z], -1), valid


def _reproj_residual(xi, pts_w, uv, intr):
    """Residuals (K, 2) of projecting world points with pose exp(xi)."""
    R, t = se3.se3_exp(xi)
    fx, fy, cx, cy = intr
    cam = pts_w @ R.T + t
    return se3.project(cam, fx, fy, cx, cy) - uv


@functools.partial(jax.jit, static_argnames=("iters",))
def pnp_gn(pts_w, uv, weights, intr, xi0=None, *, iters: int = 10,
           damping: float = 1e-4):
    """Weighted Gauss-Newton PnP on SE(3).

    Args:
      pts_w: (K, 3) world points; uv: (K, 2) observations;
      weights: (K,) observation weights (0 disables a point).
      intr: (fx, fy, cx, cy); xi0: initial twist (6,) or None.
    Returns (xi (6,), final mean squared residual over weighted points).
    """
    if xi0 is None:
        xi0 = jnp.zeros(6, jnp.float32)

    fx, fy, cx, cy = intr

    def res_perturbed(delta, xi):
        # left-multiplicative perturbation: T = exp(delta) * exp(xi)
        Rd, td = se3.se3_exp(delta)
        R, t = se3.se3_exp(xi)
        Rc, tc = se3.compose(Rd, td, R, t)
        cam = pts_w @ Rc.T + tc
        return se3.project(cam, fx, fy, cx, cy) - uv

    def step(xi, _):
        r = _reproj_residual(xi, pts_w, uv, intr)       # (K, 2)
        J = jax.jacfwd(res_perturbed)(
            jnp.zeros(6, jnp.float32), xi
        )                                                # (K, 2, 6)
        w = weights[:, None]
        H = jnp.einsum("kri,kr,krj->ij", J, jnp.broadcast_to(w, r.shape), J)
        g = jnp.einsum("kri,kr->i", J, r * w)
        delta = jnp.linalg.solve(
            H + damping * jnp.eye(6), -g
        )
        xi_new = se3.se3_log(
            *se3.compose(*se3.se3_exp(delta), *se3.se3_exp(xi))
        )
        return xi_new, None

    xi, _ = jax.lax.scan(step, xi0, None, length=iters)
    r = _reproj_residual(xi, pts_w, uv, intr)
    wsum = jnp.maximum(weights.sum(), 1e-6)
    mse = (weights * (r**2).sum(-1)).sum() / wsum
    return xi, mse


@functools.partial(
    jax.jit, static_argnames=("n_hypotheses", "min_set", "gn_iters",
                              "refine_iters")
)
def pnp_ransac(
    pts_w, uv, valid, intr, key, *,
    n_hypotheses: int = 64,
    min_set: int = 4,
    inlier_px: float = 3.0,
    gn_iters: int = 5,
    refine_iters: int = 10,
):
    """Vectorized RANSAC + GN refinement.

    All hypotheses are solved in one vmapped batch (no sequential loop),
    then the best by inlier count is refined on its inliers.
    Returns (xi (6,), inlier_mask (K,), n_inliers).
    """
    K = pts_w.shape[0]
    validf = valid.astype(jnp.float32)

    # sample minimal subsets, biased to valid points via Gumbel-top-k
    keys = jax.random.split(key, n_hypotheses)

    def one_hyp(k):
        gumbel = jax.random.gumbel(k, (K,))
        scores = jnp.where(valid, gumbel, -jnp.inf)
        _, idx = jax.lax.top_k(scores, min_set)
        w = jnp.zeros(K).at[idx].set(1.0) * validf
        xi, _ = pnp_gn(pts_w, uv, w, intr, iters=gn_iters)
        r = _reproj_residual(xi, pts_w, uv, intr)
        err = jnp.sqrt((r**2).sum(-1))
        inl = (err < inlier_px) & valid
        return xi, inl.sum(), inl

    xis, counts, inls = jax.vmap(one_hyp)(keys)
    best = jnp.argmax(counts)
    xi_best = xis[best]
    inlier0 = inls[best]

    # refinement on inliers with Huber-style reweighting
    def refine(xi, _):
        r = _reproj_residual(xi, pts_w, uv, intr)
        err = jnp.sqrt((r**2).sum(-1))
        w_huber = jnp.where(err < inlier_px, 1.0, inlier_px /
                            jnp.maximum(err, 1e-6))
        w = w_huber * inlier0.astype(jnp.float32)
        xi_new, _ = pnp_gn(pts_w, uv, w, intr, xi0=xi, iters=1)
        return xi_new, None

    xi_ref, _ = jax.lax.scan(refine, xi_best, None, length=refine_iters)
    r = _reproj_residual(xi_ref, pts_w, uv, intr)
    err = jnp.sqrt((r**2).sum(-1))
    inlier = (err < inlier_px) & valid
    return xi_ref, inlier, inlier.sum()
