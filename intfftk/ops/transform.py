"""Staged integer radix-2 transform on the device — the XLA reference path.

This is the framework's portable compute path: pure jnp int32 ops (no
gathers inside stages), bit-identical to the golden model.  The Pallas
kernels (``pallas_fft.py``) implement the same plan fused in one kernel;
this path is the plain version XLA compiles, the oracle for kernel tests
on the device, and the engine of the wide (> 32-bit) data paths.

Structure per stage (forward DIF, ``int_fftNk.vhd:184-279``):
  view [..., blocks, 2, h] -> butterfly lane 0 vs lane 1 -> write back.
The reshape is a leading-axis view only — XLA keeps it free of data
movement; the inter-stage "cross-commutation" of the reference hardware
(``int_delay_line.vhd``) is realized implicitly by the in-place indexing
(equivalence proven by tests/test_golden.py::test_lane_vs_inplace_bitexact).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FFTConfig
from ..golden.float_model import bitrev_indices
from ..golden.twiddle import stage_twiddles_int
from .intmath import (CmultPlan, add_round_half_up, cmult_exact,
                      neg_guarded, sub_round_half_up, wrap_width)
from .wideint import (WideCmultPlan, wide_add, wide_cmult, wide_from_i64_np,
                      wide_neg_guarded, wide_round_half_up, wide_shr1,
                      wide_sub, wide_to_i64_np, wide_where)


def _check_device_widths(cfg: FFTConfig):
    if cfg.output_width > 32:
        raise NotImplementedError(
            f"device path supports configs with output width <= 32 bits "
            f"(got {cfg.output_width}); run the golden host path, or use "
            f"scaled mode / a narrower input"
        )


class FFTPlan:
    """Precomputed transform plan (tables + permutations) for one config.

    The device analog of RTL elaboration: twiddle ROMs per stage
    (quantized exactly as ``rom_twiddle_int``/``row_twiddle_tay``),
    bit-reversal index vector, limb plans per stage.  Plans are cheap to
    build and cache; apply with ``plan(x_re, x_im)`` (jit-compatible).
    """

    def __init__(self, cfg: FFTConfig, inverse: bool = False):
        _check_device_widths(cfg)
        self.cfg = cfg
        self.inverse = inverse
        n, nl = cfg.n, cfg.stages
        self.bitrev = jnp.asarray(bitrev_indices(n), dtype=jnp.int32)
        self.tables = {}
        self.cmult_plans = {}
        for s in range(nl):
            p = cfg.stage_twiddle_order(s, inverse)
            if p >= 2:
                w_re, w_im = stage_twiddles_int(p, cfg.twiddle_width,
                                                cfg.twiddle_gen)
                self.tables[s] = (jnp.asarray(w_re, dtype=jnp.int32),
                                  jnp.asarray(w_im, dtype=jnp.int32))
                in_w = cfg.stage_input_width(s)
                # forward multiplies the butterfly output (width in_w+1-scale);
                # inverse multiplies the raw stage input (width in_w)
                dw = in_w if inverse else in_w + 1 - cfg.scale
                self.cmult_plans[s] = CmultPlan(
                    data_width=dw, twiddle_width=cfg.twiddle_width,
                    shift=cfg.twiddle_shift, out_width=dw)
        #: Device-array pytree threaded through jit as an ARGUMENT, never
        #: closure-captured (closure arrays become constants baked into
        #: every compiled program).
        self.consts = {"tables": self.tables, "bitrev": self.bitrev}
        self._jitted = None

    def apply(self, consts, x_re, x_im):
        """Traceable core: thread ``consts`` (= ``self.consts``) through the
        enclosing jit's parameters.  Use this form when composing the plan
        inside a larger jitted/shard_mapped program."""
        return fft_stages(x_re, x_im, self.cfg, self.inverse,
                          consts["tables"], self.cmult_plans,
                          consts["bitrev"])

    def __call__(self, x_re, x_im):
        if self._jitted is None:
            self._jitted = jax.jit(self.apply)
        return self._jitted(self.consts, jnp.asarray(x_re, jnp.int32),
                            jnp.asarray(x_im, jnp.int32))


def dif_stage(ar, ai, br, bi, cfg: FFTConfig, in_w: int, p: int,
              table, cplan):
    """One forward stage on lane views; mirrors golden dif_butterfly_int."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    out_w = in_w + 1 - scale
    if scale and not rnd:
        ar, ai, br, bi = ar >> 1, ai >> 1, br >> 1, bi >> 1
        sr, si = ar + br, ai + bi
        dr, di = ar - br, ai - bi
    elif scale and rnd:
        # carry-free forms: exact even when the (w+1)-bit sum would overflow
        sr, si = add_round_half_up(ar, br), add_round_half_up(ai, bi)
        dr, di = sub_round_half_up(ar, br), sub_round_half_up(ai, bi)
    else:
        sr, si = ar + br, ai + bi
        dr, di = ar - br, ai - bi
    sr, si = wrap_width(sr, out_w), wrap_width(si, out_w)
    dr, di = wrap_width(dr, out_w), wrap_width(di, out_w)

    if p == 0:
        yr, yi = dr, di
    elif p == 1:
        # W in {1, -j}: odd index -> (re,im) = (im, neg_guarded(re))
        odd = (jnp.arange(2, dtype=jnp.int32) & 1).astype(bool)
        yr = jnp.where(odd, di, dr)
        yi = jnp.where(odd, neg_guarded(dr), di)
    else:
        w_re, w_im = table
        yr, yi = cmult_exact(cplan, dr, di, w_re, w_im)
    return sr, si, yr, yi


def dit_stage(ar, ai, br, bi, cfg: FFTConfig, in_w: int, p: int,
              table, cplan):
    """One inverse stage; multiply-by-conj first, then add/scale."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    out_w = in_w + 1 - scale
    if p == 0:
        bwr, bwi = br, bi
    elif p == 1:
        odd = (jnp.arange(2, dtype=jnp.int32) & 1).astype(bool)
        bwr = jnp.where(odd, neg_guarded(bi), br)
        bwi = jnp.where(odd, br, bi)
    else:
        w_re, w_im = table
        bwr, bwi = cmult_exact(cplan, br, bi, w_re, w_im, conj=True)
    if scale and not rnd:
        oar = (ar >> 1) + (bwr >> 1)
        oai = (ai >> 1) + (bwi >> 1)
        obr = (ar >> 1) - (bwr >> 1)
        obi = (ai >> 1) - (bwi >> 1)
    elif scale and rnd:
        oar, oai = add_round_half_up(ar, bwr), add_round_half_up(ai, bwi)
        obr, obi = sub_round_half_up(ar, bwr), sub_round_half_up(ai, bwi)
    else:
        oar, oai = ar + bwr, ai + bwi
        obr, obi = ar - bwr, ai - bwi
    return (wrap_width(oar, out_w), wrap_width(oai, out_w),
            wrap_width(obr, out_w), wrap_width(obi, out_w))


def fft_stages(x_re, x_im, cfg: FFTConfig, inverse, tables, cplans, bitrev):
    """Full staged transform on [..., n] int32 arrays."""
    n, nl = cfg.n, cfg.stages
    xr = jnp.asarray(x_re, dtype=jnp.int32)
    xi = jnp.asarray(x_im, dtype=jnp.int32)
    if inverse:
        xr = jnp.take(xr, bitrev, axis=-1)
        xi = jnp.take(xi, bitrev, axis=-1)

    if cfg.bypass_fly:
        if not inverse:
            xr = jnp.take(xr, bitrev, axis=-1)
            xi = jnp.take(xi, bitrev, axis=-1)
        return xr, xi

    shp = xr.shape[:-1]
    for s in range(nl):
        p = cfg.stage_twiddle_order(s, inverse)
        h = 1 << p
        in_w = cfg.stage_input_width(s)
        vr = xr.reshape(shp + (-1, 2, h))
        vi = xi.reshape(shp + (-1, 2, h))
        ar, ai = vr[..., 0, :], vi[..., 0, :]
        br, bi = vr[..., 1, :], vi[..., 1, :]
        table = tables.get(s)
        cplan = cplans.get(s)
        if not inverse:
            sr, si, yr, yi = dif_stage(ar, ai, br, bi, cfg, in_w, p,
                                       table, cplan)
            xr = jnp.stack([sr, yr], axis=-2).reshape(shp + (n,))
            xi = jnp.stack([si, yi], axis=-2).reshape(shp + (n,))
        else:
            oar, oai, obr, obi = dit_stage(ar, ai, br, bi, cfg, in_w, p,
                                          table, cplan)
            xr = jnp.stack([oar, obr], axis=-2).reshape(shp + (n,))
            xi = jnp.stack([oai, obi], axis=-2).reshape(shp + (n,))

    if not inverse:
        xr = jnp.take(xr, bitrev, axis=-1)
        xi = jnp.take(xi, bitrev, axis=-1)
    return xr, xi


# ------------------------------------------------------------- wide (>32b)

def dif_stage_wide(ar, ai, br, bi, cfg: FFTConfig, p: int, table, wplan):
    """Forward stage on wide (int32 limb-plane) lane views.

    Same dataflow as ``dif_stage``; arithmetic from ``ops.wideint`` (the
    double/triple-DSP-tier analog).  Capacity (55 bits signed) exceeds the
    widest admissible stage output (53 bits), so plain add + round never
    overflows the planes; the hardware register wrap is the identity for
    sums, but the round-mode DIFFERENCE reaches +2^(w-1) at (max, min)
    and must wrap (``pallas_fft._bfly_fwd`` audit; scaled mode keeps
    w = cfg.data_width at every stage)."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    a_re, a_im = (ar, ai)
    b_re, b_im = (br, bi)
    if scale and not rnd:
        a_re, a_im = wide_shr1(a_re), wide_shr1(a_im)
        b_re, b_im = wide_shr1(b_re), wide_shr1(b_im)
        s_re, s_im = wide_add(a_re, b_re), wide_add(a_im, b_im)
        d_re, d_im = wide_sub(a_re, b_re), wide_sub(a_im, b_im)
    elif scale and rnd:
        from .wideint import wide_wrap_width
        s_re = wide_round_half_up(wide_add(a_re, b_re))
        s_im = wide_round_half_up(wide_add(a_im, b_im))
        d_re = wide_wrap_width(wide_round_half_up(wide_sub(a_re, b_re)),
                               cfg.data_width)
        d_im = wide_wrap_width(wide_round_half_up(wide_sub(a_im, b_im)),
                               cfg.data_width)
    else:
        s_re, s_im = wide_add(a_re, b_re), wide_add(a_im, b_im)
        d_re, d_im = wide_sub(a_re, b_re), wide_sub(a_im, b_im)

    if p == 0:
        y_re, y_im = d_re, d_im
    elif p == 1:
        odd = (jnp.arange(2, dtype=jnp.int32) & 1).astype(bool)
        y_re = wide_where(odd, d_im, d_re)
        y_im = wide_where(odd, wide_neg_guarded(d_re), d_im)
    else:
        w_re, w_im = table
        y_re, y_im = wide_cmult(wplan, d_re, d_im, w_re, w_im)
    return s_re, s_im, y_re, y_im


def dit_stage_wide(ar, ai, br, bi, cfg: FFTConfig, p: int, table, wplan):
    """Inverse stage on wide lane views (conjugate multiply first)."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    if p == 0:
        bw_re, bw_im = br, bi
    elif p == 1:
        odd = (jnp.arange(2, dtype=jnp.int32) & 1).astype(bool)
        bw_re = wide_where(odd, wide_neg_guarded(bi), br)
        bw_im = wide_where(odd, br, bi)
    else:
        w_re, w_im = table
        bw_re, bw_im = wide_cmult(wplan, br, bi, w_re, w_im, conj=True)
    if scale and not rnd:
        ar, ai = wide_shr1(ar), wide_shr1(ai)
        bw_re, bw_im = wide_shr1(bw_re), wide_shr1(bw_im)
        return (wide_add(ar, bw_re), wide_add(ai, bw_im),
                wide_sub(ar, bw_re), wide_sub(ai, bw_im))
    if scale and rnd:
        from .wideint import wide_wrap_width
        return (wide_round_half_up(wide_add(ar, bw_re)),
                wide_round_half_up(wide_add(ai, bw_im)),
                wide_wrap_width(wide_round_half_up(wide_sub(ar, bw_re)),
                                cfg.data_width),
                wide_wrap_width(wide_round_half_up(wide_sub(ai, bw_im)),
                                cfg.data_width))
    return (wide_add(ar, bw_re), wide_add(ai, bw_im),
            wide_sub(ar, bw_re), wide_sub(ai, bw_im))


def _wide_view(w, shp, h):
    lo, hi = w
    return lo.reshape(shp + (-1, 2, h)), hi.reshape(shp + (-1, 2, h))


def _wide_lane(v, idx):
    lo, hi = v
    return lo[..., idx, :], hi[..., idx, :]


def fft_stages_wide(x_re, x_im, cfg: FFTConfig, inverse, tables, wplans,
                    bitrev):
    """Full staged transform on wide planes; x_re/x_im are (lo, hi) plane
    pairs of shape [..., n]."""
    n, nl = cfg.n, cfg.stages

    def take(w, idx):
        return (jnp.take(w[0], idx, axis=-1), jnp.take(w[1], idx, axis=-1))

    xr, xi = x_re, x_im
    if inverse:
        xr, xi = take(xr, bitrev), take(xi, bitrev)
    if cfg.bypass_fly:
        if not inverse:
            xr, xi = take(xr, bitrev), take(xi, bitrev)
        return xr, xi

    shp = xr[0].shape[:-1]
    for s in range(nl):
        p = cfg.stage_twiddle_order(s, inverse)
        h = 1 << p
        vr = _wide_view(xr, shp, h)
        vi = _wide_view(xi, shp, h)
        ar, ai = _wide_lane(vr, 0), _wide_lane(vi, 0)
        br, bi = _wide_lane(vr, 1), _wide_lane(vi, 1)
        table = tables.get(s)
        wplan = wplans.get(s)
        if not inverse:
            o = dif_stage_wide(ar, ai, br, bi, cfg, p, table, wplan)
            pair = ((o[0], o[2]), (o[1], o[3]))   # (s, y) re / im
        else:
            o = dit_stage_wide(ar, ai, br, bi, cfg, p, table, wplan)
            pair = ((o[0], o[2]), (o[1], o[3]))
        (pr, pi) = pair
        xr = tuple(jnp.stack([pr[0][k], pr[1][k]], axis=-2).reshape(
            shp + (n,)) for k in range(2))
        xi = tuple(jnp.stack([pi[0][k], pi[1][k]], axis=-2).reshape(
            shp + (n,)) for k in range(2))

    if not inverse:
        xr, xi = take(xr, bitrev), take(xi, bitrev)
    return xr, xi


class WideFFTPlan:
    """Transform plan for configurations whose data path exceeds 32 bits
    (output width 33..52) — unscaled large-N growth and the widened
    FFT->IFFT pair input (``int_fft_ifft_pair.vhd:261``).

    Data is carried as int32 limb planes (``ops.wideint``).  ``__call__``
    accepts/returns host int64 arrays; ``apply`` composes on planes inside
    larger jitted programs.
    """

    def __init__(self, cfg: FFTConfig, inverse: bool = False):
        self.cfg = cfg
        self.inverse = inverse
        self.bitrev = jnp.asarray(bitrev_indices(cfg.n), dtype=jnp.int32)
        self.tables = {}
        self.wide_plans = {}
        for s in range(cfg.stages):
            p = cfg.stage_twiddle_order(s, inverse)
            if p >= 2:
                w_re, w_im = stage_twiddles_int(p, cfg.twiddle_width,
                                                cfg.twiddle_gen)
                self.tables[s] = (jnp.asarray(w_re, dtype=jnp.int32),
                                  jnp.asarray(w_im, dtype=jnp.int32))
                in_w = cfg.stage_input_width(s)
                dw = in_w if inverse else in_w + 1 - cfg.scale
                self.wide_plans[s] = WideCmultPlan(
                    data_width=dw, twiddle_width=cfg.twiddle_width,
                    shift=cfg.twiddle_shift)
        self.consts = {"tables": self.tables, "bitrev": self.bitrev}
        self._jitted = None

    def apply(self, consts, x_re, x_im):
        """x_re/x_im: wide plane pairs [..., n] -> wide plane pairs."""
        return fft_stages_wide(x_re, x_im, self.cfg, self.inverse,
                               consts["tables"], self.wide_plans,
                               consts["bitrev"])

    def __call__(self, x_re, x_im):
        """x_re/x_im: host integer arrays [..., n] (any width <= 52 bits).
        Returns np.int64 arrays."""
        if self._jitted is None:
            self._jitted = jax.jit(self.apply)
        xr = wide_from_i64_np(np.asarray(x_re))
        xi = wide_from_i64_np(np.asarray(x_im))
        yr, yi = self._jitted(self.consts, xr, xi)
        return wide_to_i64_np(yr), wide_to_i64_np(yi)


# ----------------------------------------------------------- functional API

def make_plan(cfg: FFTConfig, inverse: bool = False):
    """Plan factory: the narrow int32 plan when the data path fits 32 bits,
    the wide limb-plane plan (``WideFFTPlan``) above — the analog of
    ``int_cmult_dsp48``'s automatic single/double/triple tier dispatch."""
    if cfg.output_width > 32:
        return WideFFTPlan(cfg, inverse=inverse)
    return FFTPlan(cfg, inverse=inverse)


def fft(x_re, x_im, cfg: FFTConfig):
    """Forward integer FFT on device, natural in / natural out."""
    return make_plan(cfg, inverse=False)(x_re, x_im)


def ifft(x_re, x_im, cfg: FFTConfig):
    """Inverse integer FFT on device (unnormalized, like the reference)."""
    return make_plan(cfg, inverse=True)(x_re, x_im)


def fft_ifft_pair(x_re, x_im, cfg: FFTConfig, fly_fwd: bool = True,
                  fly_inv: bool = True):
    """FFT -> IFFT roundtrip, mirroring ``int_fft_ifft_pair``: the IFFT
    input width is automatically widened to DATA_WIDTH + FORMAT*NFFT
    (``int_fft_ifft_pair.vhd:261``), and no bit-reversal is materialized
    between the cores in the hardware; here both cores are natural-order so
    the reorder cancels inside XLA.  Either side escalates to the wide
    limb-plane plan when its data path exceeds 32 bits.  (The reference
    wrapper's Q*_IM output slice bug — SURVEY §2.6 — is of course not
    replicated.)

    ``fly_fwd``/``fly_inv`` are the reference's per-core butterfly knockout
    switches FLY_FWD/FLY_INV (``int_fft_ifft_pair.vhd:92-93``): False turns
    that core's arithmetic off, leaving only its permutation network — the
    dataflow-debug fixture of SURVEY §4.  Note the knocked-out core keeps
    its configured width contract (no bit growth happens with arithmetic
    off, the narrow values simply ride the wider container)."""
    fwd_cfg = cfg if fly_fwd else dataclasses.replace(cfg, bypass_fly=True)
    fwd = make_plan(fwd_cfg, inverse=False)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width,
                               bypass_fly=not fly_inv or cfg.bypass_fly)
    inv = make_plan(icfg, inverse=True)
    yr, yi = fwd(x_re, x_im)
    if isinstance(inv, WideFFTPlan):
        yr, yi = np.asarray(yr), np.asarray(yi)
    return inv(yr, yi)
