"""BlockMatcher — the stereo block-matching disparity engine.

The model-level API over the SAD kernels: owns the live-retunable parameter
store (equivalent of the reference's atomic globals,
``pkg/despair/params.go:8-30``), selects the compute backend
(``utils.device.sad_backend``: the Pallas kernel on a GPU, the XLA path on
the CPU), and manages jit compile buckets — one
compiled executable per (block_size, max_disparity, image shape), mirroring
how the reference revalidates and hot-swaps parameters per chunk
(``pkg/despair/sad.go:51-53``) without restarting the pipeline.

``RunSad`` parity: :meth:`BlockMatcher.compute` is the equivalent of
``despair.RunSad`` (``pkg/despair/sad.go:119-169``) — one call, full frame —
with the worker-pool/chunk machinery replaced by the kernel's tile grid.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from steroscopic_hardware_tpu.ops.lr_check import disparity_lr_checked
from steroscopic_hardware_tpu.ops.sad_pallas import disparity_pallas
from steroscopic_hardware_tpu.ops.sad_xla import disparity_xla
from steroscopic_hardware_tpu.utils.device import sad_backend
from steroscopic_hardware_tpu.utils.params import (
    VALID_BLOCK_SIZES,
    VALID_MAX_DISPARITIES,
    Parameters,
    ParamStore,
)


def _disparity_one(left, right, *, block_size, max_disparity, backend,
                   lr, threshold):
    if lr:
        from steroscopic_hardware_tpu.ops.lr_check import check_from_raw

        if backend == "pallas":
            from steroscopic_hardware_tpu.ops.sad_pallas import (
                disparity_pallas_lr,
            )

            dL, dR = disparity_pallas_lr(
                left, right, block_size=block_size,
                max_disparity=max_disparity,
            )
        else:
            from steroscopic_hardware_tpu.ops.sad_xla import (
                disparity_raw_lr_xla,
            )

            dL, dR = disparity_raw_lr_xla(
                left, right, block_size=block_size,
                max_disparity=max_disparity,
            )
        depth, _valid = check_from_raw(
            dL, dR, left.shape[-1], max_disparity, threshold=threshold
        )
        return depth
    fn = disparity_pallas if backend == "pallas" else disparity_xla
    return fn(left, right, block_size=block_size,
              max_disparity=max_disparity)


@functools.partial(
    jax.jit,
    static_argnames=("block_size", "max_disparity", "backend", "lr",
                     "threshold", "preview_scale", "fetch_all",
                     "colorize_dev"),
)
def _disparity_serve(stacked, *, block_size, max_disparity, backend,
                     lr=False, threshold=1, preview_scale=1,
                     fetch_all=True, colorize_dev=True):
    """One-dispatch serving step over a frame micro-batch: stacked
    (B, 2, H, W) uint8 -> (depths (B, H, W) uint8, turbo RGB of the
    NEWEST frame, colorized — and optionally downscaled — on device).

    Every synchronous host<->device transfer has a fixed cost, so this
    shape pays ONE upload + ONE fetch for B frames; B is chosen by
    the pipeline from how many frames arrived while the previous batch
    was in flight (self-regulating), and only the newest frame's RGB is
    shipped since the latest-frame bus can only display that one.

    Result packing (always ONE buffer, so one fetch RPC):
      * default (``fetch_all`` and ``preview_scale == 1``): a
        (B+3, H, W) uint8 stack — rows [:B] the depths, rows [B:] the
        newest frame's RGB planes.
      * otherwise ("light" mode, for bandwidth-starved links): a 1D
        uint8 concat of the raveled depth(s) (only the newest when not
        ``fetch_all`` — older frames are instantly overwritten in the
        latest-frame bus anyway) plus the raveled (H//k, W//k, 3) RGB
        preview, colorized from the k x k mean-pooled depth on device.
        At B=8, k=2 this cuts fetch traffic ~14x (3.3 MB -> 0.23 MB)."""
    from steroscopic_hardware_tpu.ops.colorize import (
        colorize_disparity_jax,
        downscale_u8_jax,
    )

    depths = [
        _disparity_one(
            stacked[b, 0], stacked[b, 1],
            block_size=block_size, max_disparity=max_disparity,
            backend=backend, lr=lr, threshold=threshold,
        )
        for b in range(stacked.shape[0])
    ]
    return _pack_serve(depths, preview_scale, fetch_all, colorize_dev)


def _pack_serve(depths, preview_scale, fetch_all, colorize_dev=True):
    """Pack a micro-batch of uint8 depth maps + the newest frame's RGB
    into ONE buffer (one fetch RPC): (B+3, H, W) in full mode, the 1D
    light layout otherwise (see ``_disparity_serve``).

    ``colorize_dev=False`` ships NO RGB at all — the host colorizes the
    fetched uint8 depth through the 256-entry Turbo LUT
    (``ops.colorize.turbo_lut``), cutting the visualization fetch 3x
    (VERDICT r2 directive #6): full mode returns the (B, H, W) depth
    stack, light mode the newest frame's raveled depth only."""
    from steroscopic_hardware_tpu.ops.colorize import (
        colorize_disparity_jax,
        downscale_u8_jax,
    )

    if not colorize_dev:
        kept = depths if fetch_all else depths[-1:]
        return jnp.stack(kept)
    if fetch_all and preview_scale == 1:
        rgb_planes = jnp.transpose(colorize_disparity_jax(depths[-1]),
                                   (2, 0, 1))
        return jnp.concatenate([jnp.stack(depths), rgb_planes], axis=0)
    rgb = colorize_disparity_jax(
        downscale_u8_jax(depths[-1], preview_scale)
    )
    kept = depths if fetch_all else depths[-1:]
    return jnp.concatenate([d.ravel() for d in kept] + [rgb.ravel()])


@functools.partial(
    jax.jit,
    static_argnames=("max_disparity", "p1", "p2", "subpixel", "lr",
                     "threshold", "preview_scale", "fetch_all",
                     "colorize_dev"),
)
def _sgm_serve(stacked, *, max_disparity, p1, p2, subpixel, lr=False,
               threshold=1.0, preview_scale=1, fetch_all=True,
               colorize_dev=True):
    """SGM counterpart of ``_disparity_serve``: one dispatch for a
    (B, 2, H, W) micro-batch, same packed layouts — serving parity
    between the engines (the pipeline batches whichever matcher exposes
    ``compute_serve_async``)."""
    depths = [
        _sgm_one(stacked[b, 0], stacked[b, 1],
                 max_disparity=max_disparity, p1=p1, p2=p2,
                 subpixel=subpixel, lr=lr, threshold=threshold)
        for b in range(stacked.shape[0])
    ]
    return _pack_serve(depths, preview_scale, fetch_all, colorize_dev)


def _sgm_one(left, right, *, max_disparity, p1, p2, subpixel, lr,
             threshold):
    """One frame of the SGM serving step: uint8 disparity (LR-masked to
    255 when ``lr``), shared by ``_sgm_serve`` and the fused serve+track
    dispatch (``runtime/fused.py``)."""
    from steroscopic_hardware_tpu.ops.sgm import sgm_disparity, sgm_lr_checked

    if lr:
        disp, valid = sgm_lr_checked(
            left, right, max_disparity=max_disparity, P1=p1, P2=p2,
            threshold=threshold,
        )
    else:
        disp = sgm_disparity(
            left, right, max_disparity=max_disparity, P1=p1, P2=p2,
            subpixel=subpixel,
        )
    u8 = jnp.clip(
        disp * (255.0 / max_disparity) + 0.5, 0, 255
    ).astype(jnp.uint8)
    if lr:
        u8 = jnp.where(valid, u8, jnp.uint8(255))
    return u8


@dataclasses.dataclass
class BlockMatcher:
    """Stereo SAD block matcher with live-retunable parameters.

    Args:
      params: initial :class:`Parameters` (defaults match the reference:
        block 16, maxDisparity 64, ``pkg/despair/params.go:14-17``).
      backend: "pallas" (GPU kernel), "xla" (portable), or "auto"
        (``utils.device.sad_backend``).
      lr_threshold: disparity tolerance used by :meth:`compute_checked`
        (defaults to 1 when left unset). :meth:`compute` never applies
        the LR check; call :meth:`compute_checked` for the filtered map.
    """

    params: Parameters = dataclasses.field(default_factory=Parameters)
    backend: str = "auto"
    lr_threshold: int | None = None

    def __post_init__(self):
        self.store = ParamStore(self.params)
        if self.backend == "auto":
            self.backend = sad_backend()
        if self.backend not in ("pallas", "xla"):
            raise ValueError(f"unknown backend {self.backend!r}")

    # -- live retuning (POST /update-params equivalent) ---------------------
    def set_params(self, params: Parameters) -> None:
        self.store.set(params)

    def get_params(self) -> Parameters:
        return self.store.get()

    # -- compute ------------------------------------------------------------
    def _fn(self) -> Callable:
        return disparity_pallas if self.backend == "pallas" else disparity_xla

    def compute(self, left, right) -> np.ndarray:
        """Full-frame uint8 disparity with the current parameters."""
        p = self.store.get()
        out = self._fn()(
            jax.numpy.asarray(left),
            jax.numpy.asarray(right),
            block_size=p.block_size,
            max_disparity=p.max_disparity,
        )
        return np.asarray(out)

    def compute_checked(self, left, right):
        """Disparity plus left-right consistency mask (one fused LR sweep
        on either backend)."""
        p = self.store.get()
        thr = 1 if self.lr_threshold is None else self.lr_threshold
        left = jax.numpy.asarray(left)
        right = jax.numpy.asarray(right)
        if self.backend == "pallas":
            from steroscopic_hardware_tpu.ops.sad_pallas import (
                disparity_pallas_lr,
            )
            from steroscopic_hardware_tpu.ops.lr_check import check_from_raw

            dL, dR = disparity_pallas_lr(
                left, right,
                block_size=p.block_size, max_disparity=p.max_disparity,
            )
            disp, valid = check_from_raw(
                dL, dR, left.shape[-1], p.max_disparity, threshold=thr
            )
        else:
            disp, valid = disparity_lr_checked(
                left, right,
                block_size=p.block_size, max_disparity=p.max_disparity,
                threshold=thr,
            )
        return np.asarray(disp), np.asarray(valid)

    def compute_serve_async(self, pairs, lr: bool = False,
                            preview_scale: int = 1,
                            fetch_all: bool = True,
                            colorize_dev: bool = True):
        """Dispatch the fused serving step for a micro-batch of frame
        pairs WITHOUT syncing: ONE stacked host->device transfer, one
        executable, one packed result future (layout per
        ``_disparity_serve``; the default is the (B+3, H, W) stack;
        ``colorize_dev=False`` ships depths only for host-LUT
        colorization).

        ``pairs``: list of (left, right) uint8 arrays of one shape.
        """
        p = self.store.get()
        stacked = np.stack([np.stack((np.asarray(l), np.asarray(r)))
                            for l, r in pairs])
        thr = 1 if self.lr_threshold is None else self.lr_threshold
        return _disparity_serve(
            jax.device_put(stacked),
            block_size=p.block_size, max_disparity=p.max_disparity,
            backend=self.backend, lr=lr, threshold=thr,
            preview_scale=preview_scale, fetch_all=fetch_all,
            colorize_dev=colorize_dev,
        )

    # -- compile-bucket management ------------------------------------------
    def warmup(self, shape, params_list=None, lr: bool = False) -> int:
        """Pre-compile executables for the given image shape.

        Without ``params_list`` warms the full HTTP-API envelope
        (15 block sizes x 16 disparities, ``cmd/handlers/params.go:37,51``).
        With ``lr`` also compiles the fused LR path used by
        :meth:`compute_checked`. Returns the number of buckets compiled.
        """
        if params_list is None:
            params_list = [
                Parameters(b, d)
                for b in VALID_BLOCK_SIZES
                for d in VALID_MAX_DISPARITIES
            ]
        dummy = jax.numpy.zeros(shape, jax.numpy.uint8)
        n = 0
        for p in params_list:
            self._fn()(
                dummy, dummy,
                block_size=p.block_size, max_disparity=p.max_disparity,
            )
            if lr:
                saved = self.store.get()
                self.store.set(p)
                try:
                    self.compute_checked(dummy, dummy)
                finally:
                    self.store.set(saved)
            n += 1
        return n


@dataclasses.dataclass
class SGMMatcher:
    """Semi-global matching engine (drop-in for BlockMatcher in the
    pipeline): census costs + 4-path aggregation + subpixel — the quality
    upgrade beyond the reference's plain SAD WTA."""

    params: Parameters = dataclasses.field(default_factory=Parameters)
    p1: float = 1.0
    p2: float = 8.0
    subpixel: bool = True

    def __post_init__(self):
        self.store = ParamStore(self.params)

    def set_params(self, params: Parameters) -> None:
        self.store.set(params)

    def get_params(self) -> Parameters:
        return self.store.get()

    def compute(self, left, right) -> np.ndarray:
        from steroscopic_hardware_tpu.ops.sgm import sgm_disparity

        p = self.store.get()
        disp = sgm_disparity(
            jax.numpy.asarray(left), jax.numpy.asarray(right),
            max_disparity=p.max_disparity, P1=self.p1, P2=self.p2,
            subpixel=self.subpixel,
        )
        out = jax.numpy.clip(
            disp * (255.0 / p.max_disparity) + 0.5, 0, 255
        ).astype(jax.numpy.uint8)
        return np.asarray(out)

    def compute_raw(self, left, right) -> np.ndarray:
        """Float (possibly subpixel) disparity in pixels."""
        from steroscopic_hardware_tpu.ops.sgm import sgm_disparity

        p = self.store.get()
        return np.asarray(sgm_disparity(
            jax.numpy.asarray(left), jax.numpy.asarray(right),
            max_disparity=p.max_disparity, P1=self.p1, P2=self.p2,
            subpixel=self.subpixel,
        ))

    def compute_checked(self, left, right):
        """SGM disparity + left-right consistency mask (diagonal right
        argmin over the same aggregated volume) — drop-in for the
        pipeline's ``lr_check`` mode, like BlockMatcher's."""
        from steroscopic_hardware_tpu.ops.sgm import sgm_lr_checked

        p = self.store.get()
        disp, valid = sgm_lr_checked(
            jax.numpy.asarray(left), jax.numpy.asarray(right),
            max_disparity=p.max_disparity, P1=self.p1, P2=self.p2,
        )
        out = jax.numpy.clip(
            disp * (255.0 / p.max_disparity) + 0.5, 0, 255
        ).astype(jax.numpy.uint8)
        out = jax.numpy.where(valid, out, jax.numpy.uint8(255))
        return np.asarray(out), np.asarray(valid)

    def compute_serve_async(self, pairs, lr: bool = False,
                            preview_scale: int = 1,
                            fetch_all: bool = True,
                            colorize_dev: bool = True):
        """Fused one-dispatch serving step (same packed layouts as
        :meth:`BlockMatcher.compute_serve_async`) so the pipeline
        micro-batches the SGM engine too."""
        p = self.store.get()
        stacked = np.stack([np.stack((np.asarray(l), np.asarray(r)))
                            for l, r in pairs])
        return _sgm_serve(
            jax.device_put(stacked),
            max_disparity=p.max_disparity, p1=self.p1, p2=self.p2,
            subpixel=self.subpixel, lr=lr,
            preview_scale=preview_scale, fetch_all=fetch_all,
            colorize_dev=colorize_dev,
        )


def sweep(
    left,
    right,
    block_sizes=VALID_BLOCK_SIZES,
    max_disparities=VALID_MAX_DISPARITIES,
    backend: str = "auto",
):
    """Parameter-sweep runner (BASELINE config #2): yields
    ``(Parameters, disparity_map)`` over the full envelope grid."""
    m = BlockMatcher(backend=backend)
    for b in block_sizes:
        for d in max_disparities:
            m.set_params(Parameters(b, d))
            yield m.get_params(), m.compute(left, right)
