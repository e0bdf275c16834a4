"""Integer Taylor twiddle synthesis — O(512) tables for O(N) twiddle
streams.

The reference never materializes a full-size twiddle table: every stage
holds at most one 512-deep quarter-wave ROM, and stages >= 11 rotate its
entries by an exact first-order integer Taylor step in a DSP48 MACC
(``rom_twiddle_int.vhd:40-58,215-246``, ``row_twiddle_tay.vhd:28-42``).

This module is the device image of that generator: a traced function
that synthesizes any block of the full-circle table W_N^(+-k1*j2) from
one packed 512-entry coarse quarter table (2 KB), bit-identical to
``golden.twiddle.circle_twiddles_int`` by construction.  The four-step
plans run it once at plan build (``device_circle_table``): the host
builds and uploads O(512) data, and the [n1, n2] epilogue table exists
only as the generator's device output.

* index math: m = k1*j2 (< n, exact in int32), half-circle fold by the
  top bit, quadrant fold (x -j) by the next (``rom_twiddle_int.vhd:
  174-189``),
* coarse lookup: the 512-entry table packed (re | im << 16) into one
  int32 per entry, fetched by one gather,
* Taylor correction: the exact ``row_twiddle_tay`` MACC.  The products
  fit int32 directly — mpi < 2^16 by the USE_MLT bound (pi * 2^14,
  proven in ``golden.twiddle.taylor_mpi``), so mpx < 2^15 and
  |b * mpx| < 2^31 for twiddle widths <= 17 — and the 48-bit
  accumulate (a << XSHIFT) + b*mpx reduces exactly via
  floor((a*2^XS + p) / 2^(XS-1)) = 2a + floor(p / 2^(XS-1))
  (a*2^XS is divisible by 2^(XS-1)), i.e. two shifts and an add, no
  limb planes.
"""

from __future__ import annotations


import numpy as np

import jax
import jax.numpy as jnp

from ..config import FFTConfig, TAYLOR_COARSE_BITS, TAYLOR_STAGE
from ..golden.twiddle import quarter_table, taylor_mathpi


def can_synth(cfg: FFTConfig) -> bool:
    """Synthesis covers the Taylor regime with int32-direct MACC
    products: stage order L-1 >= TAYLOR_STAGE and twiddle width <= 16
    (the packed coarse entries carry signed 16-bit fields; width 17 would
    need a third plane, width >= 18 limb products)."""
    return (cfg.twiddle_gen != "rom"
            and cfg.twiddle_width <= 16
            and cfg.n.bit_length() - 2 >= TAYLOR_STAGE)


def packed_coarse(cfg: FFTConfig) -> np.ndarray:
    """The 512-entry coarse quarter table, (re & 0xFFFF) | (im << 16)
    packed into one int32 per entry (one gather fetches both
    components).  Values are magnitude-bounded (< 2^15 at width <= 16,
    < 2^16 at 17), so the 16-bit fields are exact."""
    qre, qim = quarter_table(TAYLOR_COARSE_BITS, cfg.twiddle_width)
    return ((qre.astype(np.int64) & 0xFFFF)
            | ((qim.astype(np.int64) & 0xFFFF) << 16)).astype(np.int32)


def device_circle_table(cfg: FFTConfig, n: int, n1: int, n2: int,
                        inverse: bool):
    """Generate the full [n1, n2] epilogue table on the device from the
    2 KB packed coarse table — the host builds O(512) work and uploads
    2 KB; the O(N) array exists only as the device output of the
    (bit-verified) generator, like the reference's table is only ever
    the output of its ROM + interpolator."""
    tbl = jnp.asarray(packed_coarse(cfg))

    def gen(t):
        return synth_circle_block(t, n1, n2, 0, n, cfg, inverse)

    return jax.jit(gen)(tbl)


def synth_circle_block(tbl, rows: int, cols: int, j0, n: int,
                       cfg: FFTConfig, inverse: bool):
    """Synthesize the epilogue block er/ei[k1, j2] = W_n^(+-k1*(j0+j2))
    for k1 = 0..rows-1, j2 = 0..cols-1 — bit-identical to
    ``circle_twiddles_int(n)[m]`` with m = (+-k1*j2) mod n.

    ``tbl``: the ``packed_coarse`` array.  ``j0`` may be a traced
    scalar (a column offset).  Returns int32 (er, ei).
    """
    L = n.bit_length() - 1
    p = L - 1                            # half-circle stage order
    assert p >= TAYLOR_STAGE
    cb = TAYLOR_COARSE_BITS
    sh_cnt = p - 1 - cb
    k1 = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 0)
    j2 = j0 + jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1)
    m = k1 * j2                          # < n1*n2 = n: exact, no wrap
    if inverse:
        m = (n - m) & (n - 1)            # (-m) mod n, m = 0 fixed point
    neg = m >> (L - 1)                   # half-circle fold sign
    mm = m & ((1 << (L - 1)) - 1)
    div = mm >> (L - 2)                  # quadrant fold (x -j)
    addr = mm & ((1 << (L - 2)) - 1)
    addrx = addr >> sh_cnt
    count = addr & ((1 << sh_cnt) - 1)

    packed = jnp.take(tbl, addrx)
    re = (packed << 16) >> 16            # signed low half
    im = packed >> 16                    # signed high half
    # quadrant fold: (re, im) -> (im, -re) (plain negate; rom_twiddle_int
    # fold, golden.twiddle._fold_neg_j)
    fre = jnp.where(div == 1, im, re)
    fim = jnp.where(div == 1, -re, im)

    # Taylor rotation by count * pi / 2^p (row_twiddle_tay MACC)
    ser = "new" if cfg.twiddle_gen == "taylor_new" else "old"
    xshift = 23 if ser == "old" else 21
    mathpi = taylor_mathpi(p - TAYLOR_STAGE, ser)
    mpi = mathpi * count                 # < 2^16 (USE_MLT bound)
    mpx = mpi >> 1                       # == (mpi & 0x3FFFF) >> 1 here
    sh = xshift - 1

    def macc(a, b, sub: bool):
        # rnd((a << xshift) +- b*mpx) >> (xshift-1), exactly:
        # a*2^XS divisible by 2^(XS-1) -> t = 2a + floor(+-p / 2^(XS-1))
        q = b * mpx                      # |q| < 2^31 for width <= 17
        t = (a << 1) + ((-q if sub else q) >> sh)
        return (t >> 1) + (t & 1)        # round-half-up on the LSB

    tre = macc(fre, fim, sub=False)
    tim = macc(fim, fre, sub=True)

    er = jnp.where(neg == 1, -tre, tre)
    ei = jnp.where(neg == 1, -tim, tim)
    return er, ei
