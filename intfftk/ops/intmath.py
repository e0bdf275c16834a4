"""Exact integer arithmetic primitives for the device compute path.

Every butterfly here is built from int32 ops only, yet must match the
int64/bigint golden model bit-for-bit.
The wide complex multiply is decomposed into *limbs*, directly mirroring the
reference's DSP48 width-dispatch
(``/root/reference/src/vhdl/math/cmult/int_cmult_dsp48.vhd:115-171``):

=====================  ==========================================
reference tier         here
=====================  ==========================================
single (2 DSP, :184)   1 data limb  x 1 twiddle limb  -> 1 product
double (5 DSP, :228)   2 data limbs x 1 twiddle limb  -> 2 products
triple (7-8 DSP)       3 data limbs (and/or split twiddle)
wide-B (35x25, 52x25)  2 twiddle limbs
=====================  ==========================================

Low limbs are unsigned, the top limb signed — the same chunking the
reference's wide multipliers use (17-bit unsigned A-chunks + signed head,
``mlt42x18_dsp48e1.vhd:82-89``).

Exact floor-shift recombination uses the identity
``floor((X*2^L + Y)/2^S) = floor((X + floor(Y/2^L))/2^(S-L))`` for 0<=L<=S,
so the renormalizing shift of the complex product (>> TWD-1, floor — the
DSP48 output slice) is applied without ever materializing a >32-bit value.

All limb plans are static (resolved at trace time from the FFTConfig, the
device analog of VHDL elaboration); the emitted ops are pure int32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

I32 = jnp.int32


def neg_guarded(x):
    """Two's-complement negate with the most-negative guard
    (``int_dif2_fly.vhd:281-304``): -x for x >= 0, ~x = -x-1 for x < 0.

    2-op closed form: (x >> 31) - x  (arithmetic shift gives 0 for
    x >= 0, -1 for x < 0) — replaces the 4-op cmp/neg/sub/select chain;
    identical results for every int32 including INT32_MIN."""
    return (x >> 31) - x


def round_half_up(v):
    """(v >> 1) + (v & 1): divide by 2 rounding half toward +inf
    (``int_dif2_fly.vhd:193-218``)."""
    return (v >> 1) + (v & 1)


def add_round_half_up(a, b):
    """round_half_up(a + b) without materializing the (w+1)-bit sum:
    (a>>1) + (b>>1) + ((a|b)&1) — exact for any int32 a, b (the full-width
    add of the reference DSP is 48-bit; int32 needs this carry-free form
    at data_width 32)."""
    return (a >> 1) + (b >> 1) + ((a | b) & 1)


def sub_round_half_up(a, b):
    """round_half_up(a - b) carry-free: (a>>1) - (b>>1) + ((a & ~b) & 1)."""
    return (a >> 1) - (b >> 1) + ((a & ~b) & 1)


def wrap_width(v, w: int):
    """Wrap to signed w-bit register semantics; w == 32 is native int32."""
    if w >= 32:
        return v
    sh = 32 - w
    return (v << sh) >> sh


# --------------------------------------------------------------------- limbs

@dataclasses.dataclass(frozen=True)
class Limb:
    shift: int   # power-of-two position of this limb
    bits: int    # payload width (excl. sign for unsigned limbs)
    signed: bool


def plan_limbs(width: int, limb_bits: int) -> tuple[Limb, ...]:
    """Split a signed ``width``-bit value into unsigned low limbs of
    ``limb_bits`` plus a signed head limb."""
    if width <= limb_bits + 1:
        return (Limb(0, width, True),)
    limbs = []
    pos = 0
    while width - pos > limb_bits + 1:
        limbs.append(Limb(pos, limb_bits, False))
        pos += limb_bits
    limbs.append(Limb(pos, width - pos, True))
    return tuple(limbs)


def split_limbs(x, limbs: Sequence[Limb]):
    """Extract limb values from an int32 (or int64 on host) array.

    Shift-by-zero is elided: traced ops reach the kernel verbatim, so
    ``x >> 0`` would count as a real op per element in the audit
    (``utils.roofline.audit_kernel_ops``).
    """
    out = []
    for lb in limbs:
        v = x if lb.shift == 0 else x >> lb.shift
        if not lb.signed:
            v = v & ((1 << lb.bits) - 1)
        out.append(v)
    return out


@dataclasses.dataclass(frozen=True)
class CmultPlan:
    """Static plan of one exact integer complex multiply.

    data_width:    bits of the complex data entering the multiplier
    twiddle_width: bits of the twiddle factors
    shift:         renormalizing floor-shift (config.twiddle_shift)
    out_width:     wrap width of the result slice
    """

    data_width: int
    twiddle_width: int
    shift: int
    out_width: int

    @property
    def direct(self) -> bool:
        """Single-product tier: |br*c - bi*d| <= |B|*|W| < 2^(e+t-1.5)
        (twiddle modulus <= magnitude keeps the pair sum in int32 at
        e + t = 32) — the analog of the single 2-DSP tier."""
        return self.data_width + self.twiddle_width <= 32

    @property
    def data_limbs(self) -> tuple[Limb, ...]:
        if self.direct:
            return (Limb(0, self.data_width, True),)
        t = self.twiddle_width
        # twiddle pieces are at most `piece` bits; data limb width chosen
        # so product + pairwise accumulation headroom fits int32:
        #   (L) + (piece) + 1 (re/im pair sum) <= 32
        piece = t if t <= 18 else max((t + 1) // 2, t - 18)
        lb = 31 - piece - 1
        return plan_limbs(self.data_width, lb)

    @property
    def twiddle_limbs(self) -> tuple[Limb, ...]:
        t = self.twiddle_width
        if self.direct or t <= 18:
            return (Limb(0, t, True),)
        lo = max((t + 1) // 2, t - 18)
        return plan_limbs(t, lo)

    @property
    def n_products(self) -> int:
        return len(self.data_limbs) * len(self.twiddle_limbs)


def _combine_groups(groups: dict, shift: int):
    """Exact floor((sum_d groups[d] * 2^d) / 2^shift) in int32 ops.

    Ascending-shift chain of the floor identity; a head shift d >= shift
    splits off exactly as ``head * 2^(d-shift)``.
    """
    ds = sorted(groups)
    # low part: all groups with d < shift, folded by the identity chain
    low = [d for d in ds if d < shift]
    high = [d for d in ds if d >= shift]
    acc = None
    cur = 0
    for d in low:
        if acc is None:
            acc, cur = groups[d], d
        else:
            acc = groups[d] + (acc >> (d - cur))
            cur = d
    if acc is not None:
        acc = acc >> (shift - cur)
    result = acc
    for d in high:
        term = groups[d] * (1 << (d - shift)) if d > shift else groups[d]
        result = term if result is None else result + term
    return result


def shift_wrap(v, s: int, w: int):
    """``wrap_width(v >> s, w)`` in the fewest ops.

    For 0 < s and s + w <= 32 the three shifts fuse to two:
    ``(v << (32-s-w)) >> (32-w)`` reads exactly bits [s, s+w) of v with
    the sign at bit s+w-1 — identical to shift-then-wrap for every int32
    (the DSP48 output slice, ``int_cmult_dsp48.vhd:189-190``, is this
    same bit-field extract in silicon)."""
    if s == 0:
        return wrap_width(v, w)
    if w >= 32:
        return v >> s
    if s + w <= 32:
        return (v << (32 - s - w)) >> (32 - w)
    return wrap_width(v >> s, w)


def cmult_exact(plan: CmultPlan, br, bi, w_re, w_im, conj: bool = False):
    """(br + j*bi) * (w_re + j*w_im), renormalized by floor >> plan.shift.

    re = (br*c - bi*d) >> s,  im = (bi*c + br*d) >> s — the shift applies to
    the *summed* full-precision product, exactly like the DSP48 PCIN cascade
    plus output slice (``int_cmult18x25_dsp48.vhd:106-225``).
    ``conj`` negates the twiddle imaginary part (the DIT/IFFT path — bit
    identical to the hardware's re/im swap trick, ``int_dit2_fly.vhd:304-322``).

    Python-int twiddle components (the tail-plane stages embed them as
    vector immediates) fold at trace time: a zero component (twiddle on an
    axis, e.g. W = -j) drops its two multiplies entirely — the software
    image of the reference's multiplier-free stage specializations.
    """
    if conj:
        w_im = -w_im
    if plan.direct:
        # single-product tier: no limb split, products + pair-sum fit i32
        z_re = isinstance(w_re, int) and w_re == 0
        z_im = isinstance(w_im, int) and w_im == 0
        if z_im:
            pre, pim = br * w_re, bi * w_re
        elif z_re:
            pre, pim = -(bi * w_im), br * w_im
        else:
            pre = br * w_re - bi * w_im
            pim = bi * w_re + br * w_im
        return (shift_wrap(pre, plan.shift, plan.out_width),
                shift_wrap(pim, plan.shift, plan.out_width))
    dl, tl = plan.data_limbs, plan.twiddle_limbs
    br_l, bi_l = split_limbs(br, dl), split_limbs(bi, dl)
    c_l, d_l = split_limbs(w_re, tl), split_limbs(w_im, tl)

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

    out_re = _combine_groups(groups_re, plan.shift)
    out_im = _combine_groups(groups_im, plan.shift)
    return wrap_width(out_re, plan.out_width), wrap_width(out_im, plan.out_width)
