"""Wide (33..52-bit) integer arithmetic on int32 limb planes.

The kernels compute in int32, but the reference supports configurations
whose data paths outgrow 32 bits: unscaled mode grows one bit per stage
(``/root/reference/src/vhdl/fft/int_fftNk.vhd:97-100``), and the FFT->IFFT
pair widens the inverse input to DATA_WIDTH + NFFT
(``int_fft_ifft_pair.vhd:261``).  The reference meets those widths by
escalating to its double/triple-DSP multiplier tiers
(``int_cmult_dbl18_dsp48.vhd``, ``int_cmult_trpl18_dsp48.vhd``: 42..61-bit
operands over 17-bit DSP chunks); this module is the device image of that
escalation: a value is carried as TWO int32 *planes*,

    v  =  hi * 2^24 + lo,      lo in [0, 2^24)  (unsigned),  hi signed,

giving 55 bits of signed capacity — enough for the widest config the
surface admits (data_width <= 52, FFTConfig) plus carry headroom.  All ops
below are exact over that range and emit pure int32 instructions (whether
native int64 is faster on the GPU is an open item, ROADMAP).

The wide complex multiply mirrors the reference's chunked wide multipliers
(``mlt59x18_dsp48e1.vhd``: three 17-bit unsigned chunks of A + signed
head): data is split on a fixed 12-bit limb grid (products of a 12-bit
chunk against an 18-bit twiddle piece plus the re/im pair-sum stay inside
int32), twiddles >18 bits split into two pieces exactly like
``int_cmult_dsp48``'s wide-B tiers, and the renormalizing floor shift is
applied during plane recombination without ever materializing a >32-bit
scalar.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .intmath import Limb, plan_limbs, split_limbs

LO_BITS = 24
LO_MASK = (1 << LO_BITS) - 1

#: Data limb width for wide complex products: 12 + 18 (twiddle piece) + 1
#: (re/im pair sum) + 1 (grid-collision pair) <= 32, and 12 divides 24 so
#: limbs never straddle the plane boundary.
DATA_LIMB_BITS = 12


# ------------------------------------------------------------------ planes

def wide_normalize(lo, hi):
    """Restore the canonical split after plane-wise arithmetic: carry
    floor(lo / 2^24) into hi (exact for any int32 lo)."""
    c = lo >> LO_BITS
    return lo - (c << LO_BITS), hi + c


def wide_from_i32(x):
    """Widen a native int32 value to planes."""
    return x & LO_MASK, x >> LO_BITS


def wide_to_i32(w):
    """Narrow planes to int32 (caller asserts the value fits 32 bits)."""
    lo, hi = w
    return lo | (hi << LO_BITS)


def wide_from_i64_np(x: np.ndarray):
    """Host-side: split int64 into int32 planes."""
    x = np.asarray(x, dtype=np.int64)
    return ((x & LO_MASK).astype(np.int32), (x >> LO_BITS).astype(np.int32))


def wide_to_i64_np(w) -> np.ndarray:
    """Host-side: reassemble planes into int64."""
    lo, hi = (np.asarray(p, dtype=np.int64) for p in w)
    return (hi << LO_BITS) + lo


def wide_add(a, b):
    return wide_normalize(a[0] + b[0], a[1] + b[1])


def wide_sub(a, b):
    return wide_normalize(a[0] - b[0], a[1] - b[1])


def wide_neg_guarded(a):
    """Two's-complement negate with the most-negative guard
    (``int_dif2_fly.vhd:281-304``): -v for v >= 0, ~v = -v-1 for v < 0.
    Bitwise NOT in planes is (LO_MASK ^ lo, ~hi); the +1 applies only to
    non-negative values (sign lives in hi)."""
    lo, hi = a
    return wide_normalize((LO_MASK ^ lo) + (hi >= 0), ~hi)


def wide_shr1(a):
    """Arithmetic >> 1 (floor): hi's LSB drops into lo's MSB."""
    lo, hi = a
    return (lo >> 1) | ((hi & 1) << (LO_BITS - 1)), hi >> 1


def wide_round_half_up(a):
    """(v >> 1) + (v & 1), the reference's round-half-up divide by two
    (``int_dif2_fly.vhd:193-218``)."""
    lo, hi = a
    b0 = lo & 1
    slo, shi = wide_shr1(a)
    return wide_normalize(slo + b0, shi)


def wide_where(cond, a, b):
    """Elementwise select between wide values (planes selected together)."""
    return (jnp.where(cond, a[0], b[0]), jnp.where(cond, a[1], b[1]))


def wide_wrap_width(w, width: int):
    """Wrap to signed ``width``-bit register semantics (the hardware output
    slice, ``intmath.wrap_width`` on planes).  The complex multiplier's
    true product magnitude can exceed the register width by the |W| ~ sqrt2
    factor, so this wrap is NOT elidable there (unlike the butterfly sums).
    Wide values always have width > LO_BITS, so the wrap only clips hi."""
    if width >= 54:
        return w
    lo, hi = w
    if width <= LO_BITS:
        # value mod 2^width lives entirely in lo; sign-extend and re-split
        sh = 32 - width
        return wide_from_i32((lo << sh) >> sh)
    sh = 32 - (width - LO_BITS)
    return lo, (hi << sh) >> sh


# ------------------------------------------------------------ limb extract

def _extract_unsigned(w, shift: int, bits: int):
    """(v >> shift) mod 2^bits for a limb fully inside one plane (the
    12-bit grid never straddles the 24-bit boundary)."""
    lo, hi = w
    mask = (1 << bits) - 1
    if shift + bits <= LO_BITS:
        return (lo >> shift) & mask
    assert shift >= LO_BITS, "limb straddles the plane boundary"
    return (hi >> (shift - LO_BITS)) & mask


def _extract_head(w, shift: int, width: int):
    """Arithmetic v >> shift for the signed head limb.  For shift < 24 the
    head spans both planes; hi is small there (total width - 24 <= 13
    bits), so hi << (24 - shift) stays comfortably in int32."""
    lo, hi = w
    if shift >= LO_BITS:
        return hi >> (shift - LO_BITS)
    return (hi << (LO_BITS - shift)) + (lo >> shift)


def split_wide_limbs(w, limbs):
    out = []
    total = limbs[-1].shift + limbs[-1].bits
    for lb in limbs:
        if lb.signed:
            out.append(_extract_head(w, lb.shift, total))
        else:
            out.append(_extract_unsigned(w, lb.shift, lb.bits))
    return out


# ------------------------------------------------------------------- cmult

@dataclasses.dataclass(frozen=True)
class WideCmultPlan:
    """Static plan of one exact wide complex multiply (B * W) >> shift.

    The wide analog of ``intmath.CmultPlan``: data on the 12-bit limb
    grid, twiddles split as in the reference's wide-B tiers, floor-shift
    renormalization applied on the *summed* product (the DSP48 PCIN
    cascade plus output slice)."""

    data_width: int
    twiddle_width: int
    shift: int
    #: Output register width (the hardware product slice wraps to it;
    #: defaults to data_width, the butterfly's multiplier contract).
    out_width: int = 0

    @property
    def data_limbs(self) -> tuple[Limb, ...]:
        return plan_limbs(self.data_width, DATA_LIMB_BITS)

    @property
    def twiddle_limbs(self) -> tuple[Limb, ...]:
        t = self.twiddle_width
        if t <= 18:
            return (Limb(0, t, True),)
        lo = max((t + 1) // 2, t - 18)
        return plan_limbs(t, lo)


def _combine_groups_wide(groups: dict, shift: int):
    """Exact floor((sum_d groups[d] * 2^d) / 2^shift) as planes.

    Low groups (d < shift) fold through the ascending floor-identity chain
    of ``intmath._combine_groups``; each high group splits exactly into an
    unsigned low-plane chunk plus an arithmetic-shift high-plane part.
    Magnitude audit (worst case width 52, twiddle 27): per-term hi
    contribution <= 2^30, lo accumulator <= 2^27 — no int32 overflow.
    """
    ds = sorted(groups)
    low = [d for d in ds if d < shift]
    high = [d for d in ds if d >= shift]

    acc = None
    cur = 0
    for d in low:
        acc = groups[d] if acc is None else groups[d] + (acc >> (d - cur))
        cur = d
    # accumulate with explicit first-assignment (None sentinels): a
    # `0 + x` literal would trace as a real add per element
    lo_acc = None if acc is None else (acc >> (shift - cur))
    hi_acc = None

    def _acc(a, term):
        return term if a is None else a + term

    for d in high:
        g = groups[d]
        e = d - shift
        if e >= LO_BITS:
            hi_acc = _acc(hi_acc, g << (e - LO_BITS))
        else:
            chunk = g & ((1 << (LO_BITS - e)) - 1)
            lo_acc = _acc(lo_acc, chunk if e == 0 else chunk << e)
            hi_acc = _acc(hi_acc, g >> (LO_BITS - e))
    if lo_acc is None:
        lo_acc = 0
    if hi_acc is None:
        hi_acc = 0
    return wide_normalize(lo_acc, hi_acc)


def wide_cmult(plan: WideCmultPlan, b_re, b_im, w_re, w_im,
               conj: bool = False):
    """(b_re + j*b_im) * (w_re + j*w_im) >> shift on wide operands.

    ``b_re``/``b_im`` are wide planes; ``w_re``/``w_im`` int32 twiddles.
    Returns wide planes.  ``conj`` negates the twiddle imaginary part (the
    DIT/IFFT path, ``int_dit2_fly.vhd:304-322``).
    """
    if conj:
        w_im = -w_im
    dl, tl = plan.data_limbs, plan.twiddle_limbs
    br_l = split_wide_limbs(b_re, dl)
    bi_l = split_wide_limbs(b_im, dl)
    c_l = split_limbs(w_re, tl)
    d_l = split_limbs(w_im, tl)

    groups_re: dict = {}
    groups_im: dict = {}
    for i, lbd in enumerate(dl):
        for j, lbt in enumerate(tl):
            d = lbd.shift + lbt.shift
            pre = br_l[i] * c_l[j] - bi_l[i] * d_l[j]
            pim = bi_l[i] * c_l[j] + br_l[i] * d_l[j]
            # explicit first-assignment: `0 + pre` would trace as a real add
            groups_re[d] = pre if d not in groups_re else groups_re[d] + pre
            groups_im[d] = pim if d not in groups_im else groups_im[d] + pim

    out_w = plan.out_width or plan.data_width
    return (wide_wrap_width(_combine_groups_wide(groups_re, plan.shift),
                            out_w),
            wide_wrap_width(_combine_groups_wide(groups_im, plan.shift),
                            out_w))
