"""Fused Pallas kernels for the staged integer FFT, compiled through Triton.

The performance path of the framework — the GPU analog of the reference's
DSP48-mapped butterfly pipeline (``int_dif2_fly.vhd``/``int_dit2_fly.vhd``
with the ``int_delay_line`` commutation network).  Design:

* **One pass over device memory per factor.**  The staged XLA path
  (``transform.py``) makes one HBM round trip per stage, because every
  output of a stage depends on two inputs of the previous one and XLA
  cannot fuse the chain.  A kernel block here loads an [n, bt] tile
  (n <= ``MAX_ROWS`` rows, bt independent transforms), runs every stage
  in registers and shared memory, applies the optional four-step
  epilogue twiddle and corner turn, and stores once.
* **Stockham stage order.**  Each stage views the tile as [A, 2, B],
  splits the pair axis and interleaves the results at a new position, so
  the natural-order spectrum emerges without any bit-reversal pass (the
  reference's ``int_bitrev_order`` buffer costs nothing).  The butterflies
  and twiddle indices are exactly those of the in-place radix-2 schedule,
  so the bits are identical; ``spectrum_rows="bitrev"`` keeps the
  in-place order (the raw ``int_fftNk`` core contract).
* **Triton-lowerable primitives only.**  Pairs come apart with
  ``lax.split`` and go back together with a stack on a new minor axis and
  a transpose — no slices, which the Triton lowering does not have.
  Block shapes are powers of two, chosen from n alone (``block_cols``).
* **Large n by the four-step.**  ``LargeFFTPlan`` runs two passes of the
  same engine: pass 1 transforms the n1 axis, multiplies by W_N^(k1*j2)
  and corner-turns in the kernel; pass 2 transforms the n2 axis.  Data
  paths wider than 32 bits run the plain XLA limb-plane path instead.

All arithmetic is the exact int32 limb algebra of ``intmath.py`` — kernel
outputs are bit-identical to the golden model (tests/test_pallas.py).
Interpret mode runs the same kernels on the CPU for the test suite; on a
GPU they always compile.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import FFTConfig
from ..golden.twiddle import circle_twiddles_int, stage_twiddles_int
from .intmath import (CmultPlan, add_round_half_up, cmult_exact, neg_guarded,
                      sub_round_half_up, wrap_width)
from .transform import FFTPlan, WideFFTPlan, make_plan
from .wideint import (WideCmultPlan, wide_cmult, wide_from_i32,
                      wide_from_i64_np, wide_to_i64_np)

#: Longest transform one kernel block holds (rows of the tile).  A
#: 4096-point int32 complex transform is 32 KB: it fits one block's
#: registers and shared memory with the stage temporaries.
MAX_ROWS = 4096
#: Elements (rows x columns) of one kernel block.  The column count of a
#: block follows from n alone (``block_cols``).
BLOCK_ELEMS = 4096
#: Warps per block: 256 threads share the block's BLOCK_ELEMS elements.
NUM_WARPS = 8


def block_cols(n: int) -> int:
    """Independent transforms (columns) per kernel block for n rows — a
    power of two, so every block shape is one."""
    return max(1, BLOCK_ELEMS // n)


def _platform(devices=None) -> str:
    """Platform of ``devices`` (a sequence), else of the configured
    default device."""
    if devices is not None:
        return devices[0].platform
    dev = jax.config.jax_default_device
    if isinstance(dev, str):
        return dev.split(":", 1)[0].lower()
    if dev is not None:
        return dev.platform
    return jax.devices()[0].platform


def resolve_interpret(interpret: bool | None = None, devices=None) -> bool:
    """Engine mode for the kernels of a plan that runs on ``devices``
    (default: the default device): the Pallas interpreter on the CPU,
    compiled Triton on a GPU.  Any other platform raises, and so does an
    explicit ``interpret`` that contradicts the platform — the GPU never
    runs interpreted, and the CPU has no compiled kernel."""
    platform = _platform(devices)
    if platform == "cpu":
        want = True
    elif platform == "gpu":
        want = False
    else:
        raise RuntimeError(f"no FFT kernel for platform {platform!r}; "
                           f"supported: cpu (interpreter), gpu (Triton)")
    if interpret is not None and bool(interpret) != want:
        raise ValueError(f"interpret={interpret} is not available on "
                         f"{platform}")
    return want


def _pack_tables(cfg: FFTConfig):
    """Pack the per-stage twiddle tables into one [n] vector.

    The stage of twiddle order p >= 2 occupies [2^p, 2^(p+1)) — the same
    offset-by-order packing for every config, so the kernel loads each
    stage's slice statically.  (Orders 0/1 are the multiplier-free
    specializations.)"""
    n = cfg.n
    w_re = np.zeros(n, dtype=np.int32)
    w_im = np.zeros(n, dtype=np.int32)
    for p in range(2, cfg.stages):
        re, im = stage_twiddles_int(p, cfg.twiddle_width, cfg.twiddle_gen)
        w_re[1 << p: 2 << p] = re
        w_im[1 << p: 2 << p] = im
    return w_re, w_im


def _cmult_plans(cfg: FFTConfig, inverse: bool):
    plans = {}
    for s in range(cfg.stages):
        p = cfg.stage_twiddle_order(s, inverse)
        if p >= 2:
            in_w = cfg.stage_input_width(s)
            dw = in_w if inverse else in_w + 1 - cfg.scale
            plans[s] = CmultPlan(data_width=dw,
                                 twiddle_width=cfg.twiddle_width,
                                 shift=cfg.twiddle_shift, out_width=dw)
    return plans


# ------------------------------------------------------ butterfly numerics

def _bfly_fwd(ar, ai, br, bi, cfg, in_w):
    """DIF A+-B with the mode's exact scale/round semantics
    (``int_dif2_fly.vhd:144-241``).  Returns (sum_re, sum_im, diff_re,
    diff_im).

    Register-wrap audit (golden wraps every output to out_w; here the
    wrap is applied only where it is not the identity): for w-bit wrapped
    operands, the unscaled sums fit the (w+1)-bit container, the
    truncate-mode halved forms fit w bits, and the ROUND-mode SUM
    (a+b+1)>>1 lies in [-2^(w-1), 2^(w-1)-1] — identity everywhere.  The
    round-mode DIFFERENCE (a-b+1)>>1 reaches +2^(w-1) at exactly
    (a, b) = (max, min) and must wrap to -2^(w-1) like the hardware's
    DTW-bit result register (``int_dif2_fly.vhd:167-219``), applied here
    as a fused 2-shift bit-field extract."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    if scale and not rnd:
        ar, ai, br, bi = ar >> 1, ai >> 1, br >> 1, bi >> 1
        return ar + br, ai + bi, ar - br, ai - bi
    if scale and rnd:
        if in_w <= 30:
            # round_half_up(v) == (v+1)>>1 for any v, and the +1 rides
            # the A operand ONCE for both the sum and the difference
            # (exact while the (w+1)-bit sum plus 1 fits int32).
            # Diffs: wrap_w(v >> 1) fused to 2 shifts (intmath.shift_wrap)
            arp, aip = ar + 1, ai + 1
            sh1, sh2 = 31 - in_w, 32 - in_w
            return ((arp + br) >> 1, (aip + bi) >> 1,
                    ((arp - br) << sh1) >> sh2,
                    ((aip - bi) << sh1) >> sh2)
        dr = sub_round_half_up(ar, br)
        di = sub_round_half_up(ai, bi)
        return (add_round_half_up(ar, br), add_round_half_up(ai, bi),
                wrap_width(dr, in_w), wrap_width(di, in_w))
    return ar + br, ai + bi, ar - br, ai - bi


def _bfly_inv(ar, ai, bwr, bwi, cfg, in_w):
    """DIT A +- B*W combine with exact scale/round semantics
    (``int_dit2_fly.vhd:142-217``); round-mode DIFFERENCE wrap as in
    ``_bfly_fwd``."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    if scale and not rnd:
        ar, ai = ar >> 1, ai >> 1
        bwr, bwi = bwr >> 1, bwi >> 1
        return ar + bwr, ai + bwi, ar - bwr, ai - bwi
    if scale and rnd:
        if in_w <= 30:
            arp, aip = ar + 1, ai + 1
            sh1, sh2 = 31 - in_w, 32 - in_w
            return ((arp + bwr) >> 1, (aip + bwi) >> 1,
                    ((arp - bwr) << sh1) >> sh2,
                    ((aip - bwi) << sh1) >> sh2)
        dr = sub_round_half_up(ar, bwr)
        di = sub_round_half_up(ai, bwi)
        return (add_round_half_up(ar, bwr), add_round_half_up(ai, bwi),
                wrap_width(dr, in_w), wrap_width(di, in_w))
    return ar + bwr, ai + bwi, ar - bwr, ai - bwi


# ------------------------------------------------------------ stage moves

def _pair(x, a: int, b: int):
    """View an [n, C] tile as [a, 2, b, C] and split the pair axis into
    its two [a, b, C] halves (``lax.split``: Triton has no slices)."""
    c = x.shape[-1]
    lo, hi = jax.lax.split(x.reshape(a, 2, b, c), (1, 1), axis=1)
    return lo.reshape(a, b, c), hi.reshape(a, b, c)


def _unpair(lo, hi, axis: int):
    """Interleave two [a, b, C] halves back into an [n, C] tile with the
    pair index at ``axis`` of [a, b]: 0 -> [2, a, b], 1 -> [a, 2, b]."""
    v = jnp.stack([lo, hi], axis=-1)                  # [a, b, C, 2]
    v = v.transpose((3, 0, 1, 2) if axis == 0 else (0, 3, 1, 2))
    return v.reshape(-1, lo.shape[-1])


def _stage_layout(n: int, h: int, inverse: bool, natural: bool):
    """(a, b, k_axis, out_axis) of one stage with twiddle span h.

    In-place radix-2 pairs (q*2h + k, q*2h + h + k) in a [n/2h, 2, h]
    view and writes back in place.  The Stockham orders move each
    butterfly's pair so that the spectrum side is natural: the forward
    (DIF) reads [2, h, n/2h] and writes [h, 2, n/2h]; the inverse (DIT)
    reads [h, 2, n/2h] and writes [2, h, n/2h].  Same butterflies, same
    twiddle index k (on ``k_axis`` of the [a, b] halves)."""
    q = n // (2 * h)
    if not natural:
        return q, h, 1, 1
    if inverse:
        return h, q, 0, 0
    return 1, n // 2, 0, 1


def fft_tile(xr, xi, cfg: FFTConfig, inverse: bool, twiddle, plans,
             spectrum_rows: str = "natural"):
    """Staged transform along axis 0 of [n, C] int32 tiles — the kernel
    body, also traceable outside a kernel.

    The time side is natural order.  ``spectrum_rows``: "natural" (the
    Stockham schedule) or "bitrev" (the raw in-place core contract: DIF
    emits bit-reversed rows, DIT consumes them).  ``twiddle(p)`` returns
    the (re, im) [2^p] table of twiddle order p — a static ref load in
    the kernel."""
    n = xr.shape[0]
    natural = spectrum_rows == "natural"
    if cfg.bypass_fly:
        # permutation network only (USE_FLY, int_fftNk.vhd:259-277): the
        # order map still applies — in natural order the data emerges as
        # the bit-reversal of the input, i.e. the Stockham moves alone
        if natural:
            for s in range(cfg.stages):
                shape = (n >> (s + 1), 1 << s, xr.shape[-1])
                moved = []
                for v in (xr, xi):
                    lo, hi = _pair(v, 1, n // 2)
                    moved.append(_unpair(lo.reshape(shape),
                                         hi.reshape(shape), 1))
                xr, xi = moved
        return xr, xi
    for s in range(cfg.stages):
        p = cfg.stage_twiddle_order(s, inverse)
        h = 1 << p
        a, b, kax, oax = _stage_layout(n, h, inverse, natural)
        ar, br = _pair(xr, a, b)
        ai, bi = _pair(xi, a, b)
        if natural and not inverse:
            shape = (h, n // (2 * h), xr.shape[-1])
            ar, br, ai, bi = (v.reshape(shape) for v in (ar, br, ai, bi))
        tshape = [1, 1, 1]
        tshape[kax] = h
        in_w = cfg.stage_input_width(s)
        if p == 1:
            odd = jax.lax.broadcasted_iota(jnp.int32, tuple(tshape), kax) == 1
        elif p >= 2:
            tr, ti = twiddle(p)
            tr, ti = tr.reshape(tshape), ti.reshape(tshape)
        if inverse:
            if p == 0:
                bwr, bwi = br, bi
            elif p == 1:
                # W in {1, -j}: k = 1 -> (re, im) = (neg_guarded(im), re)
                bwr = jnp.where(odd, neg_guarded(bi), br)
                bwi = jnp.where(odd, br, bi)
            else:
                bwr, bwi = cmult_exact(plans[s], br, bi, tr, ti, conj=True)
            o0r, o0i, o1r, o1i = _bfly_inv(ar, ai, bwr, bwi, cfg, in_w)
        else:
            o0r, o0i, dr, di = _bfly_fwd(ar, ai, br, bi, cfg, in_w)
            if p == 0:
                o1r, o1i = dr, di
            elif p == 1:
                # W in {1, -j}: k = 1 -> (re, im) = (im, neg_guarded(re))
                o1r = jnp.where(odd, di, dr)
                o1i = jnp.where(odd, neg_guarded(dr), di)
            else:
                o1r, o1i = cmult_exact(plans[s], dr, di, tr, ti)
        xr = _unpair(o0r, o1r, oax)
        xi = _unpair(o0i, o1i, oax)
    return xr, xi


# ----------------------------------------------------------- the engine

class _FusedPass:
    """One fused pass: every stage of one factor + optional epilogue
    twiddle (the four-step inter-factor multiply) + optional corner turn,
    in a single Pallas kernel that reads the batched [B, R, C] operand
    through 3-D BlockSpecs (no standalone XLA transposes).

    R == cfg.n is the transform axis; C carries independent transforms.
    ``transpose_in``: the operand is [B, C, R] and each block is turned
    on load; ``transpose_out``: the result is [B, C, R].  ``in_dtype``/
    ``out_dtype``: storage dtype in device memory (int16 halves every
    crossing when the data contract fits 16 bits; compute is always
    int32, so results are bit-identical)."""

    def __init__(self, cfg: FFTConfig, inverse: bool, *, has_epi: bool,
                 transpose_in: bool = False, transpose_out: bool = False,
                 interpret: bool | None = None, in_dtype=None,
                 out_dtype=None, spectrum_rows: str = "natural"):
        if cfg.n > MAX_ROWS:
            raise NotImplementedError(
                f"fused kernel supports n <= {MAX_ROWS}; use "
                f"LargeFFTPlan / FourStepPlan for n = {cfg.n}")
        if cfg.output_width > 32 or cfg.data_width > 32:
            raise NotImplementedError(
                "data path wider than 32 bits: use transform.WideFFTPlan")
        if spectrum_rows not in ("natural", "bitrev"):
            raise ValueError(f"bad spectrum order {spectrum_rows!r}")
        self.cfg, self.inverse = cfg, inverse
        self.has_epi = has_epi
        self.transpose_in, self.transpose_out = transpose_in, transpose_out
        self.spectrum_rows = spectrum_rows
        self.interpret = resolve_interpret(interpret)
        self.in_dtype = in_dtype or jnp.int32
        self.out_dtype = out_dtype or jnp.int32
        self.block_cols = block_cols(cfg.n)
        w_re, w_im = _pack_tables(cfg)
        # device arrays threaded through jit as arguments (``consts``),
        # never closure constants baked into the program
        self.consts = {"w_re": jnp.asarray(w_re), "w_im": jnp.asarray(w_im)}
        self._plans = _cmult_plans(cfg, inverse)
        ow = cfg.output_width
        self.eplan = CmultPlan(data_width=ow, twiddle_width=cfg.twiddle_width,
                               shift=cfg.twiddle_shift, out_width=ow)

    def _kernel(self, wr_ref, wi_ref, *refs):
        if self.has_epi:
            er_ref, ei_ref, *refs = refs
        xr_ref, xi_ref, or_ref, oi_ref = refs

        def ld(r):
            v = r[...]
            if v.dtype != jnp.int32:
                v = v.astype(jnp.int32)
            return v.T if self.transpose_in else v

        def twiddle(p):
            return wr_ref[pl.ds(1 << p, 1 << p)], wi_ref[pl.ds(1 << p, 1 << p)]

        xr, xi = fft_tile(ld(xr_ref), ld(xi_ref), self.cfg, self.inverse,
                          twiddle, self._plans,
                          spectrum_rows=self.spectrum_rows)
        if self.has_epi:
            xr, xi = cmult_exact(self.eplan, xr, xi, er_ref[...],
                                 ei_ref[...])

        def st(o_ref, v):
            if self.transpose_out:
                v = v.T          # the corner turn, inside the kernel
            o_ref[...] = v.astype(self.out_dtype)

        st(or_ref, xr)
        st(oi_ref, xi)

    def apply(self, consts, xr, xi, epi=None):
        """xr/xi: [B, R, C] int arrays ([B, C, R] when ``transpose_in``).
        Returns [B, C, R] when ``transpose_out`` else [B, R, C].
        ``epi``: the (er, ei) [R, C] int32 tables when ``has_epi``."""
        nb = xr.shape[0]
        cax = 1 if self.transpose_in else 2
        r, c = self.cfg.n, xr.shape[cax]
        bt = self.block_cols
        pad = -c % bt
        if pad:
            # whole blocks only: zero columns ride along and are cut off
            widths = [(0, 0)] * 3
            widths[cax] = (0, pad)
            xr, xi = jnp.pad(xr, widths), jnp.pad(xi, widths)
            if self.has_epi:
                epi = tuple(jnp.pad(e, ((0, 0), (0, pad))) for e in epi)
        cp = c + pad
        nat_spec = pl.BlockSpec((None, r, bt), lambda j, b: (b, 0, j))
        turn_spec = pl.BlockSpec((None, bt, r), lambda j, b: (b, j, 0))
        tab_spec = pl.BlockSpec((r,), lambda j, b: (0,))
        in_spec = turn_spec if self.transpose_in else nat_spec
        if self.transpose_out:
            out_spec, oshape = turn_spec, (nb, cp, r)
        else:
            out_spec, oshape = nat_spec, (nb, r, cp)
        in_specs = [tab_spec, tab_spec]
        args = [consts["w_re"], consts["w_im"]]
        if self.has_epi:
            in_specs += [pl.BlockSpec((r, bt), lambda j, b: (0, j))] * 2
            args += list(epi)
        cast = lambda v: v if v.dtype == self.in_dtype else v.astype(
            self.in_dtype)
        out = pl.pallas_call(
            self._kernel,
            grid=(cp // bt, nb),
            in_specs=in_specs + [in_spec, in_spec],
            out_specs=(out_spec, out_spec),
            out_shape=(jax.ShapeDtypeStruct(oshape, self.out_dtype),) * 2,
            backend="triton",
            compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                    num_stages=1),
            interpret=self.interpret,
            name=f"intfft{r}_{'inv' if self.inverse else 'fwd'}",
        )
        yr, yi = out(*args, cast(xr), cast(xi))
        if pad:
            keep = lambda v: jax.lax.slice_in_dim(v, 0, c, axis=(
                1 if self.transpose_out else 2))
            yr, yi = keep(yr), keep(yi)
        return yr, yi


class PallasFFTPlan:
    """Fused single-pass FFT for n <= MAX_ROWS.

    Layout ``nb``: input/output [n, B] (transform down the rows, batch
    across); layout ``bn``: [B, n] (transform along the rows, each block
    corner-turned inside the kernel).  Any batch size; the wrapper pads to
    whole blocks.

    ``order`` — spectrum ordering on the external side (the time side is
    always natural): "natural", or "bitrev" — the raw core contract that
    the FFT->IFFT pair uses (DIF output order == DIT input order,
    ``int_fft_ifft_pair``).
    """

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 layout: str = "nb", order: str = "natural",
                 interpret: bool | None = None):
        if layout not in ("nb", "bn"):
            raise ValueError(f"bad layout {layout!r}")
        if order not in ("natural", "bitrev"):
            raise ValueError(f"bad order {order!r}")
        self.cfg, self.inverse = cfg, inverse
        self.layout, self.order = layout, order
        turn = layout == "bn"
        self._pass = _FusedPass(cfg, inverse, has_epi=False,
                                transpose_in=turn, transpose_out=turn,
                                interpret=interpret, spectrum_rows=order)
        self.interpret = self._pass.interpret
        self.consts = self._pass.consts
        self._jitted = None

    def apply(self, consts, xr, xi):
        """Traceable core over a tile in the plan's layout; ``consts`` =
        ``self.consts`` threaded through the enclosing jit."""
        yr, yi = self._pass.apply(consts, xr[None], xi[None])
        return yr[0], yi[0]

    def __call__(self, x_re, x_im):
        xr = jnp.asarray(x_re, jnp.int32)
        xi = jnp.asarray(x_im, jnp.int32)
        shp = (xr.shape[1], xr.shape[0]) if self.layout == "bn" else xr.shape
        if xr.ndim != 2 or shp[0] != self.cfg.n:
            raise ValueError(f"expected [n={self.cfg.n}, B] tile, got "
                             f"{shp}")
        if self._jitted is None:
            self._jitted = jax.jit(self.apply)
        return self._jitted(self.consts, xr, xi)


class FusedAxisFFT:
    """Fused-kernel transform along the LAST axis of [..., n] int32 arrays.

    A drop-in for ``transform.FFTPlan``'s apply contract (natural in /
    natural out over the trailing axis, identical bits) running ONE Pallas
    kernel instead of log2(n) staged XLA sweeps: the kernel corner-turns
    each [bt, n] block on load, runs every stage, and turns back on store
    (``order="bitrev"`` keeps the raw core order).  This is the local
    transform engine of the distributed layer (FourStepPlan / Channelizer
    shards / the convolution blocks).
    """

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 order: str = "natural", interpret: bool | None = None):
        if order not in ("natural", "bitrev"):
            raise ValueError(f"bad order {order!r}")
        self.cfg, self.inverse, self.order = cfg, inverse, order
        self._pass = _FusedPass(cfg, inverse, has_epi=False,
                                transpose_in=True, transpose_out=True,
                                interpret=interpret, spectrum_rows=order)
        self.consts = dict(self._pass.consts)
        self._jitted = None

    def apply(self, consts, x_re, x_im):
        """[..., n] int32 -> [..., n] int32 (jit/shard_map composable)."""
        n = self.cfg.n
        shp = x_re.shape[:-1]
        xr = jnp.asarray(x_re, jnp.int32).reshape(1, -1, n)
        xi = jnp.asarray(x_im, jnp.int32).reshape(1, -1, n)
        yr, yi = self._pass.apply(consts, xr, xi)
        return yr.reshape(shp + (n,)), yi.reshape(shp + (n,))

    def __call__(self, x_re, x_im):
        if self._jitted is None:
            self._jitted = jax.jit(self.apply)
        return self._jitted(self.consts, jnp.asarray(x_re, jnp.int32),
                            jnp.asarray(x_im, jnp.int32))


def _tmap(f, *vs):
    """Map over plane tuples (1 plane narrow, 2 planes wide)."""
    return tuple(f(*ps) for ps in zip(*vs))


class LargeFFTPlan:
    """Single-device large-n FFT — the four-step, two device passes.

    Numerics identical to ``golden.four_step.four_step_int``; natural-order
    input [n] or [B, n], natural-order output.  Forward pipeline on the
    kernel engine:

    1. pass 1: log2(n1) stages + inter-factor twiddle W_N^(k1*j2) epilogue
       + corner turn, reading the batched natural input [B, n1, n2]
       directly -> [B, n2, k1],
    2. pass 2: all log2(n2) stages -> [B, k2, k1], whose flat view is the
       natural spectrum.

    The inverse mirrors it.  ``kernel``: "pallas" (the fused engine),
    "xla" (the same four-step in plain jnp: the staged factor cores,
    epilogue and transposes compiled by XLA), or "auto" — pallas unless a
    data path is wider than 32 bits, which only the XLA limb-plane path
    (``transform.WideFFTPlan``) carries.  Inputs wider than 32 bits (the
    unscaled-pair IFFT side, ``int_fft_ifft_pair.vhd:261``) are accepted as
    host int64.
    """

    def __init__(self, cfg: FFTConfig, n1: int | None = None,
                 n2: int | None = None, inverse: bool = False,
                 interpret: bool | None = None, order: str = "natural",
                 schedule: str = "fourstep", kernel: str = "auto"):
        """``order="raw"``: the spectrum layout a raw forward emits and a
        swapped-factor raw inverse consumes (``raw_spectrum_order()``).
        Both passes already produce natural order at no cost, so the raw
        layout IS the natural one here; the name keeps the chaining
        contract of the convolution and roundtrip callers.

        ``schedule``: "fourstep" (default) composes two factor cores
        with an inter-factor twiddle — the reference's own guidance for
        large N (``int_fftNk.vhd:13``), whose rounding schedule differs
        from a monolithic core's.  "monolithic" is bit-identical to the
        single ``int_fftNk``/``int_ifftNk`` core of size n and runs the
        staged XLA core (``transform.FFTPlan``/``WideFFTPlan``)."""
        n = cfg.n
        if n1 is None or n2 is None:
            l2 = cfg.stages // 2
            n2, n1 = 1 << l2, n >> l2
        if n1 * n2 != n or n1 > MAX_ROWS or n2 > MAX_ROWS:
            raise ValueError(f"bad factors {n1}x{n2} for n={n}")
        if order not in ("natural", "raw"):
            raise ValueError(f"bad order {order!r}")
        if schedule not in ("fourstep", "monolithic"):
            raise ValueError(f"bad schedule {schedule!r}")
        self.cfg, self.n1, self.n2, self.inverse = cfg, n1, n2, inverse
        self.order, self.schedule = order, schedule

        cfg1 = dataclasses.replace(cfg, n=n1)
        w1 = cfg1.output_width
        cfg2 = dataclasses.replace(cfg, n=n2, data_width=w1)
        self.out_width = cfg2.output_width
        self.wide_in = cfg.data_width > 32
        self.wide1 = w1 > 32
        self.wide2 = cfg2.output_width > 32
        wide = self.wide_in or self.wide1 or self.wide2
        #: every data contract fits 16 bits (scaled mode, dw <= 16): store
        #: int16 in device memory end to end — halves every crossing;
        #: compute stays int32, bits identical
        self.io16 = max(cfg.data_width, w1, self.out_width) <= 16
        self._io = jnp.int16 if self.io16 else jnp.int32

        if kernel == "auto":
            kernel = "xla" if wide or schedule == "monolithic" else "pallas"
        if kernel not in ("pallas", "xla"):
            raise ValueError(f"bad kernel {kernel!r}")
        if kernel == "pallas" and (wide or schedule == "monolithic"):
            raise NotImplementedError(
                "the fused engine runs the <=32-bit four-step schedule; "
                "use kernel='xla'")
        self.kernel = kernel
        self.consts = {}
        self.interpret = None
        self._run = None
        if schedule == "monolithic":
            self._mono = make_plan(cfg, inverse)
            self.consts["mono"] = self._mono.consts
            return

        if kernel == "pallas":
            self._pass1 = _FusedPass(cfg1, inverse, has_epi=True,
                                     transpose_out=True,
                                     interpret=interpret,
                                     in_dtype=self._io, out_dtype=self._io)
            self._pass2 = _FusedPass(cfg2, inverse, has_epi=False,
                                     interpret=interpret,
                                     in_dtype=self._io, out_dtype=self._io)
            self.interpret = self._pass1.interpret
            self.consts["p1"] = self._pass1.consts
            self.consts["p2"] = self._pass2.consts
        else:
            self._f1 = (WideFFTPlan if self.wide1 else FFTPlan)(cfg1, inverse)
            self._f2 = (WideFFTPlan if self.wide2 else FFTPlan)(cfg2, inverse)
            mk = WideCmultPlan if self.wide1 else CmultPlan
            self._eplan = mk(data_width=w1, twiddle_width=cfg.twiddle_width,
                             shift=cfg.twiddle_shift, out_width=w1)
            self.consts["f1"] = self._f1.consts
            self.consts["f2"] = self._f2.consts

        # the inter-factor twiddle W_N^(+-k1*j2), [n1, n2]: generated on
        # device from the 2 KB coarse table in the Taylor regime
        # (rom_twiddle_int.vhd:40-58), else gathered from the host circle
        # table
        from .twiddle_synth import can_synth, device_circle_table
        if can_synth(cfg) and not self.wide1:
            self.epi_mode = "device"
            er, ei = device_circle_table(cfg, n, n1, n2, inverse)
        else:
            self.epi_mode = "host"
            wc_re, wc_im = circle_twiddles_int(n, cfg.twiddle_width,
                                               cfg.twiddle_gen)
            m = (np.arange(n1)[:, None] * np.arange(n2)[None, :]) % n
            if inverse:
                m = (-m) % n
            er = jnp.asarray(wc_re[m], jnp.int32)
            ei = jnp.asarray(wc_im[m], jnp.int32)
        self.consts["er"], self.consts["ei"] = er, ei

    def raw_spectrum_order(self) -> np.ndarray:
        """Index table of the raw spectrum layout: a raw forward's output
        (== a swapped-factor raw inverse's input) holds, at flat position
        j, the natural-order bin ``raw_spectrum_order()[j]`` — the
        identity on this engine.  Permute frequency-domain tables (taps
        spectra etc.) by it before pointwise use against raw-chained
        transforms."""
        return np.arange(self.cfg.n)

    @property
    def block_in_shape(self):
        """[R, C] shape of one input block of ``apply_blocks``: a flat
        natural-order [n] buffer reshapes to it."""
        return (self.n1, self.n2)

    @property
    def block_out_shape(self):
        """[R, C] shape of one output block of ``apply_blocks``; its flat
        view is the natural-order spectrum."""
        return (self.n2, self.n1)

    def _blocks_xla(self, consts, xr, xi):
        """The four-step in plain jnp on plane tuples [B, n1, n2]."""
        turn = lambda p: jnp.swapaxes(p, -1, -2)
        xr, xi = _tmap(turn, xr), _tmap(turn, xi)          # [B, n2, n1]
        if self.wide1:
            if not self.wide_in:
                xr, xi = wide_from_i32(xr[0]), wide_from_i32(xi[0])
            br, bi = self._f1.apply(consts["f1"], xr, xi)   # [B, n2, k1]
            er, ei = consts["er"].T, consts["ei"].T
            cr, ci = wide_cmult(self._eplan, br, bi, er, ei)
        else:
            br, bi = self._f1.apply(consts["f1"], xr[0], xi[0])
            cr, ci = cmult_exact(self._eplan, br, bi, consts["er"].T,
                                 consts["ei"].T)
            if self.wide2:
                cr, ci = wide_from_i32(cr), wide_from_i32(ci)
            else:
                cr, ci = (cr,), (ci,)
        cr, ci = _tmap(turn, cr), _tmap(turn, ci)          # [B, k1, n2]
        if self.wide2:
            dr, di = self._f2.apply(consts["f2"], cr, ci)
        else:
            dr, di = self._f2.apply(consts["f2"], cr[0], ci[0])
            dr, di = (dr.astype(self._io),), (di.astype(self._io),)
        return _tmap(turn, dr), _tmap(turn, di)            # [B, k2, k1]

    def apply_blocks(self, consts, xr, xi):
        """Plane tuples [B, *block_in_shape] -> plane tuples
        [B, *block_out_shape] (1 plane narrow, (lo, hi) wide)."""
        if self.schedule == "monolithic":
            nb, n = xr[0].shape[0], self.cfg.n
            flat = lambda p: p.reshape(nb, n)
            if isinstance(self._mono, WideFFTPlan):
                if not self.wide_in:
                    xr, xi = wide_from_i32(xr[0]), wide_from_i32(xi[0])
                yr, yi = self._mono.apply(consts["mono"], _tmap(flat, xr),
                                          _tmap(flat, xi))
            else:
                yr, yi = self._mono.apply(consts["mono"], flat(xr[0]),
                                          flat(xi[0]))
                yr, yi = (yr.astype(self._io),), (yi.astype(self._io),)
            blk = lambda p: p.reshape((nb,) + self.block_out_shape)
            return _tmap(blk, yr), _tmap(blk, yi)
        if self.kernel == "xla":
            return self._blocks_xla(consts, xr, xi)
        b_r, b_i = self._pass1.apply(consts["p1"], xr[0], xi[0],
                                     epi=(consts["er"], consts["ei"]))
        d_r, d_i = self._pass2.apply(consts["p2"], b_r, b_i)
        return (d_r,), (d_i,)

    def apply(self, consts, xr, xi):
        """Plane tuples [B, n] -> plane tuples [B, n] (flat view)."""
        n = self.cfg.n
        nb = xr[0].shape[0]
        resh = lambda p: p.reshape((nb,) + self.block_in_shape)
        d_r, d_i = self.apply_blocks(consts, _tmap(resh, xr),
                                     _tmap(resh, xi))
        flat = lambda p: p.reshape(nb, n)
        return _tmap(flat, d_r), _tmap(flat, d_i)

    def _apply_flat(self, consts, xr, xi):
        yr, yi = self.apply(consts, xr, xi)
        if self.wide2:
            return yr, yi
        return yr[0], yi[0]

    def __call__(self, x_re, x_im):
        """x: [n] or [B, n] natural order; int values of cfg.data_width
        bits (host int64 accepted when the input is wider than 32).
        Returns int device arrays, or np.int64 when the output path is
        wider than 32 bits."""
        xr, xi = np.asarray(x_re), np.asarray(x_im)
        single = xr.ndim == 1
        if single:
            xr, xi = xr[None], xi[None]
        if xr.ndim != 2 or xr.shape[-1] != self.cfg.n:
            raise ValueError(f"expected [B, n={self.cfg.n}], got {xr.shape}")
        if self.wide_in:
            xr = wide_from_i64_np(xr)
            xi = wide_from_i64_np(xi)
        else:
            dt = np.int16 if self.io16 else np.int32
            xr = (xr.astype(dt),)
            xi = (xi.astype(dt),)
        if self._run is None:
            self._run = jax.jit(self._apply_flat)
        yr, yi = self._run(self.consts, _tmap(jnp.asarray, xr),
                           _tmap(jnp.asarray, xi))
        if self.wide2:
            yr, yi = wide_to_i64_np(yr), wide_to_i64_np(yi)
        return (yr[0], yi[0]) if single else (yr, yi)
