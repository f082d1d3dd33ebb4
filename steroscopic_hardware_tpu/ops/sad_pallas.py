"""SAD cost sweep + winner-take-all as one Pallas kernel for Hopper GPUs.

The GPU counterpart of the reference's compute tier (the Go worker pool,
``pkg/despair/sad.go:29-113``, and the Verilog ``compute_SAD.v`` datapath),
lowered through Pallas' Triton route. Bit-exact with ``ops/sad_golden.py``
and ``ops/sad_xla.py`` (``tests/test_sad_pallas.py`` runs it in interpret
mode; ``chip_smoke.py`` compares it on the card).

Design. ``sad_xla`` writes an int32 H x W cost plane and two cumsum passes
to device memory for every disparity. Here each program owns one output
tile and keeps the whole sweep on chip:

* The grid is (frame, row tile, column tile). A program loads a
  power-of-two (TR, TC) block of the left image once; its interior
  (TR - 2h) x (TC - 2h) outputs are the pixels whose B x B window lies
  inside the block. Neighbouring tiles overlap by the 2h halo, so block
  shapes stay powers of two without wasting a whole second tile.
* The disparity loop runs inside the kernel. For each d the right image is
  loaded at column offset -d (through L1/L2), so no data is shifted in
  registers.
* The separable box sum is two matrix products with 0/1 band matrices, on
  the tensor cores: ``colsum = |L - R_d| @ Bh`` then ``cost = Bv @ colsum``.
  Both are exact: |L - R| <= 255 and the band entries are integers that
  float16 holds exactly (to 2^11), products accumulate in float32, and every
  sum stays below 2^24 (at most 31 * 31 * 255). Column sums above 2^11
  (B * 255 > 2048) are split into a high and a low float16 part, each
  exact, and recombined in float32.
* The running argmin and, for the LR and subpixel variants, the
  right-referenced accumulator and the argmin's neighbour costs live in
  registers; only the final maps reach device memory.

The right-referenced cost of the LR variant, ``C(xr + d, d)``, is the box
sum of ``|L[x + d] - R[x]|`` around ``xr``: the same kernel loads the left
image at offset +d for it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BIG = 2**30
_F16_EXACT = 2048  # float16 represents every integer up to 2^11


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def tile_shape(block_size: int, lr: bool = False) -> tuple[int, int]:
    """Loaded block (TR, TC) for a window size: power-of-two blocks whose
    interior keeps at least half the rows and 3/4 of the columns. The LR
    variants carry four to seven live accumulators and take half the rows
    of the plain sweep."""
    h = block_size // 2
    tr = _pow2(max(16, 4 * h))
    tc = _pow2(max(64, 8 * h))
    return (tr if lr else 2 * tr), tc


def _make_kernel(*, W, h, D, TR, TC, lr, with_costs):
    SH, SW = TR - 2 * h, TC - 2 * h
    split = (2 * h + 1) * 255 > _F16_EXACT

    def box(ad, bh, bv):
        """Exact zero-padded B x B box sum of an int32 (TR, TC) block with
        values in [0, 255], centred, on the tensor cores."""
        col = jax.lax.dot(ad.astype(jnp.float16), bh,
                          preferred_element_type=jnp.float32)
        if not split:
            s = jax.lax.dot(bv, col.astype(jnp.float16),
                            preferred_element_type=jnp.float32)
            return s.astype(jnp.int32)
        ci = col.astype(jnp.int32)
        hi = jax.lax.dot(bv, jax.lax.shift_right_logical(ci, 11)
                         .astype(jnp.float16),
                         preferred_element_type=jnp.float32)
        lo = jax.lax.dot(bv, (ci & (_F16_EXACT - 1)).astype(jnp.float16),
                         preferred_element_type=jnp.float32)
        return (hi * _F16_EXACT + lo).astype(jnp.int32)

    def band(n):
        i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
        return jnp.where(jnp.abs(i - j) <= h, 1.0, 0.0).astype(jnp.float16)

    def kernel(l_ref, r_ref, *outs):
        f = pl.program_id(0)
        r0 = pl.program_id(1) * SH           # block top, padded rows
        tx = pl.program_id(2)
        c0 = tx * SW + D                     # block left, padded columns
        rows = pl.ds(r0, TR)
        yy = jax.lax.broadcasted_iota(jnp.int32, (TR, TC), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (TR, TC), 1)
        x_img = tx * SW - h + xx             # image column of each element
        bh, bv = band(TC), band(TR)
        full = jnp.full((TR, TC), _BIG, jnp.int32)
        zero = jnp.zeros((TR, TC), jnp.int32)

        lt = l_ref[f, rows, pl.ds(c0, TC)].astype(jnp.int32)
        in_w = x_img < W

        def cost_left(d):
            rs = r_ref[f, rows, pl.ds(c0 - d, TC)].astype(jnp.int32)
            ad = jnp.where(in_w, jnp.abs(lt - rs), 0)
            return box(ad, bh, bv)

        if not lr:
            def body(d, key):
                c = cost_left(d)
                return jnp.minimum(
                    key, jnp.where(x_img >= d + h, c * 512 + d, _BIG))

            key = jax.lax.fori_loop(0, D + 1, body, full)
            best = (key & 511) * 255 // D
            out_refs = [(outs[0], best)]
        else:
            rt = r_ref[f, rows, pl.ds(c0, TC)].astype(jnp.int32)

            def body(d, carry):
                costL = jnp.where(x_img >= d + h, cost_left(d), _BIG)
                ls = l_ref[f, rows, pl.ds(c0 + d, TC)].astype(jnp.int32)
                right_ok = x_img + d < W
                ad = jnp.where(right_ok, jnp.abs(ls - rt), 0)
                costR = jnp.where(right_ok & (x_img >= h),
                                  box(ad, bh, bv), _BIG)
                if with_costs:
                    bcL, bdL, bcR, bdR, cl, cr, prev = carry
                else:
                    bcL, bdL, bcR, bdR = carry
                betterL = costL < bcL
                if with_costs:
                    # a win captures the previous cost as the left
                    # neighbour and invalidates the right one; the step
                    # after a win supplies it (as sad_xla does)
                    cl = jnp.where(betterL, prev, cl)
                    cr = jnp.where(betterL, _BIG, cr)
                bcL = jnp.where(betterL, costL, bcL)
                bdL = jnp.where(betterL, d, bdL)
                betterR = costR < bcR
                bcR = jnp.where(betterR, costR, bcR)
                bdR = jnp.where(betterR, d, bdR)
                if with_costs:
                    cr = jnp.where(bdL == d - 1, costL, cr)
                    return bcL, bdL, bcR, bdR, cl, cr, costL
                return bcL, bdL, bcR, bdR

            init = (full, zero, full, zero)
            if with_costs:
                init += (full, full, full)
            carry = jax.lax.fori_loop(0, D + 1, body, init)
            out_refs = [(outs[0], carry[1]), (outs[1], carry[3])]
            if with_costs:
                out_refs += [(outs[2], carry[4]), (outs[3], carry[0]),
                             (outs[4], carry[5])]

        interior = ((yy >= h) & (yy < h + SH) & (xx >= h) & (xx < h + SW))
        for o_ref, val in out_refs:
            plgpu.store(o_ref.at[f, rows, pl.ds(tx * SW, TC)],
                        val.astype(o_ref.dtype), mask=interior)

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("block_size", "max_disparity", "lr", "with_costs",
                     "tile", "interpret"),
)
def _sweep(lefts, rights, *, block_size, max_disparity, lr=False,
           with_costs=False, tile=None, interpret=False):
    """Run the kernel over (F, H, W) uint8 stacks. Returns the uint8
    normalized map (plain), or int32 (dL, dR[, c_left, c_best, c_right]).
    ``tile`` overrides :func:`tile_shape` (tests)."""
    if lefts.ndim != 3 or lefts.shape != rights.shape:
        raise ValueError("expected identical (F, H, W) uint8 stacks")
    F, H, W = lefts.shape
    h, D = block_size // 2, max_disparity
    TR, TC = tile or tile_shape(block_size, lr)
    SH, SW = TR - 2 * h, TC - 2 * h
    if SH <= 0 or SW <= 0:
        raise ValueError(f"tile {TR}x{TC} too small for block {block_size}")
    n_ty, n_tx = -(-H // SH), -(-W // SW)
    # measured on an H100: 4 warps up to 64x128 blocks, 8 beyond
    num_warps = 8 if TR * TC >= 128 * 128 else 4
    # image at (h, D + h): every block read at offsets -d .. +d stays in
    # bounds, and zero padding gives the reference's window truncation
    Hp = (n_ty - 1) * SH + TR
    Wp = (n_tx - 1) * SW + TC + 2 * D
    pad = ((0, 0), (h, Hp - H - h), (D + h, Wp - W - D - h))
    Lp, Rp = jnp.pad(lefts, pad), jnp.pad(rights, pad)
    # outputs land at (h, h): row/col of the padded output = image + h
    oshape = (F, (n_ty - 1) * SH + TR, (n_tx - 1) * SW + TC)
    if lr:
        dts = [jnp.int32] * (5 if with_costs else 2)
    else:
        dts = [jnp.uint8]
    outs = pl.pallas_call(
        _make_kernel(W=W, h=h, D=D, TR=TR, TC=TC, lr=lr,
                     with_costs=with_costs),
        grid=(F, n_ty, n_tx),
        out_shape=[jax.ShapeDtypeStruct(oshape, dt) for dt in dts],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="sad_sweep",
    )(Lp, Rp)
    return [o[:, h:h + H, h:h + W] for o in outs]


_STATIC = ("block_size", "max_disparity", "interpret")


@functools.partial(jax.jit, static_argnames=_STATIC)
def disparity_pallas(left, right, *, block_size: int, max_disparity: int,
                     interpret: bool = False):
    """Dense uint8 disparity map, bit-exact with the reference; same
    contract as :func:`steroscopic_hardware_tpu.ops.sad_xla.disparity_xla`
    for (H, W) uint8 images."""
    if left.shape != right.shape or left.ndim != 2:
        raise ValueError("left/right must be identical-shape (H, W) images")
    (out,) = _sweep(left[None], right[None], block_size=block_size,
                    max_disparity=max_disparity, interpret=interpret)
    return out[0]


@functools.partial(jax.jit, static_argnames=_STATIC)
def disparity_pallas_batch(lefts, rights, *, block_size: int,
                           max_disparity: int, interpret: bool = False):
    """(F, H, W) uint8 pairs in one launch (frames are a grid axis),
    bit-identical per frame to :func:`disparity_pallas`."""
    (out,) = _sweep(lefts, rights, block_size=block_size,
                    max_disparity=max_disparity, interpret=interpret)
    return out


@functools.partial(jax.jit, static_argnames=_STATIC + ("with_costs",))
def disparity_pallas_lr(left, right, *, block_size: int, max_disparity: int,
                        with_costs: bool = False, interpret: bool = False):
    """Left- and right-referenced raw disparities in one sweep (the kernel
    counterpart of ``sad_xla.disparity_raw_lr_xla``): (dL, dR) int32 (H, W);
    with ``with_costs`` also the left map's (c_left, c_best, c_right)
    argmin-neighbourhood costs for subpixel interpolation."""
    if left.shape != right.shape or left.ndim != 2:
        raise ValueError("left/right must be identical-shape (H, W) images")
    outs = _sweep(left[None], right[None], block_size=block_size,
                  max_disparity=max_disparity, lr=True,
                  with_costs=with_costs, interpret=interpret)
    return tuple(o[0] for o in outs)


@functools.partial(jax.jit, static_argnames=_STATIC)
def disparity_pallas_subpixel(left, right, *, block_size: int,
                              max_disparity: int, interpret: bool = False):
    """Subpixel left disparity (float32) + raw right disparity (int32): the
    LR sweep tracks the argmin's neighbour costs and ``parabola_refine``
    (shared with ``sad_xla.disparity_subpixel_lr_xla``) refines it."""
    from steroscopic_hardware_tpu.ops.sad_xla import parabola_refine

    dL, dR, c0, c1, c2 = disparity_pallas_lr(
        left, right, block_size=block_size, max_disparity=max_disparity,
        with_costs=True, interpret=interpret,
    )
    return parabola_refine(c0, c1, c2, dL), dR
