"""Wide (>32-bit) device path: int32 limb-plane arithmetic + transforms.

The golden oracle computes in int64/object (``golden.int_model``); the
device path carries the same values in two int32 planes (``ops.wideint``).
Bit-for-bit equality across the full admissible width range (33..52) is
the contract — the device analog of the reference's double/triple-DSP tier
verification.
"""

import dataclasses

import numpy as np
import pytest

from intfftk.config import FFTConfig
from intfftk.golden.int_model import fft_int
from intfftk.ops.transform import WideFFTPlan, fft_ifft_pair, make_plan
from intfftk.ops.wideint import (WideCmultPlan, wide_add, wide_cmult,
                                     wide_from_i64_np, wide_neg_guarded,
                                     wide_round_half_up, wide_shr1, wide_sub,
                                     wide_to_i64_np)

RNG = np.random.default_rng(1234)


def rand_wide(width: int, shape) -> np.ndarray:
    lim = 1 << (width - 1)
    v = RNG.integers(-lim, lim, shape, dtype=np.int64)
    # salt with the extremes (most-negative guard paths)
    flat = v.reshape(-1)
    flat[0], flat[-1] = -lim, lim - 1
    return v


# ------------------------------------------------------------ plane algebra

@pytest.mark.parametrize("width", [33, 40, 48, 52])
def test_wide_add_sub_neg_roundtrip(width):
    a = rand_wide(width, 257)
    b = rand_wide(width, 257)
    wa, wb = wide_from_i64_np(a), wide_from_i64_np(b)
    assert np.array_equal(wide_to_i64_np(wide_add(wa, wb)), a + b)
    assert np.array_equal(wide_to_i64_np(wide_sub(wa, wb)), a - b)
    # guarded negate: -v for v >= 0 else ~v
    ng = np.where(a >= 0, -a, -a - 1)
    assert np.array_equal(wide_to_i64_np(wide_neg_guarded(wa)), ng)


@pytest.mark.parametrize("width", [34, 52])
def test_wide_shift_round(width):
    a = rand_wide(width, 513)
    wa = wide_from_i64_np(a)
    assert np.array_equal(wide_to_i64_np(wide_shr1(wa)), a >> 1)
    assert np.array_equal(wide_to_i64_np(wide_round_half_up(wa)),
                          (a >> 1) + (a & 1))


def _pywrap(v: int, w: int) -> int:
    m = 1 << (w - 1)
    return ((v + m) & ((1 << w) - 1)) - m


@pytest.mark.parametrize("dw", [31, 33, 38, 45, 52])
@pytest.mark.parametrize("tw", [16, 18, 19, 25, 27])
def test_wide_cmult_vs_golden(dw, tw):
    """Exact-python oracle incl. the output register wrap (the multiplier's
    true product magnitude can exceed the register by |W| ~ sqrt2)."""
    shift = tw - 1 if tw < 19 else tw - 2
    plan = WideCmultPlan(data_width=dw, twiddle_width=tw, shift=shift)
    br = rand_wide(dw, 129)
    bi = rand_wide(dw, 129)
    mag = (1 << (tw - 1)) - 1 if tw < 18 else (1 << (tw - 2)) - 1
    c = RNG.integers(-mag, mag + 1, 129).astype(np.int64)
    d = RNG.integers(-mag, mag + 1, 129).astype(np.int64)
    gr = np.array([_pywrap((int(br[k]) * int(c[k]) - int(bi[k]) * int(d[k]))
                           >> shift, dw) for k in range(129)], np.int64)
    gi = np.array([_pywrap((int(bi[k]) * int(c[k]) + int(br[k]) * int(d[k]))
                           >> shift, dw) for k in range(129)], np.int64)
    wr, wi = wide_cmult(plan, wide_from_i64_np(br), wide_from_i64_np(bi),
                        np.asarray(c, np.int32), np.asarray(d, np.int32))
    assert np.array_equal(wide_to_i64_np(wr), gr)
    assert np.array_equal(wide_to_i64_np(wi), gi)


# -------------------------------------------------------------- transforms

WIDE_CASES = [
    # (n, mode, rounding, dw, tw) — all with output width > 32
    (256, "unscaled", "truncate", 30, 16),   # out 38
    (1024, "unscaled", "truncate", 24, 25),  # out 34, wide twiddles
    (64, "unscaled", "truncate", 32, 16),    # out 38, full-width input
    (256, "scaled", "truncate", 40, 16),     # wide scaled, floor
    (256, "scaled", "round", 40, 18),        # wide scaled, round-half-up
    (4096, "unscaled", "truncate", 22, 16),  # out 34, Taylor stage p >= 11
]


@pytest.mark.parametrize("n,mode,rounding,dw,tw", WIDE_CASES)
@pytest.mark.parametrize("inverse", [False, True])
def test_wide_transform_bitexact(n, mode, rounding, dw, tw, inverse):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=tw)
    assert cfg.output_width > 32
    re = rand_wide(dw, (2, n))
    im = rand_wide(dw, (2, n))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    plan = WideFFTPlan(cfg, inverse=inverse)
    yr, yi = plan(re, im)
    assert np.array_equal(yr, gr.astype(np.int64))
    assert np.array_equal(yi, gi.astype(np.int64))


def test_make_plan_dispatch():
    narrow = make_plan(FFTConfig(n=256, mode="scaled", data_width=16))
    wide = make_plan(FFTConfig(n=256, mode="unscaled", data_width=30))
    assert not isinstance(narrow, WideFFTPlan)
    assert isinstance(wide, WideFFTPlan)


def test_wide_bypass_fly_is_permutation():
    cfg = FFTConfig(n=64, mode="unscaled", data_width=30, bypass_fly=True)
    re = rand_wide(30, 64)
    im = rand_wide(30, 64)
    yr, yi = WideFFTPlan(cfg)(re, im)
    assert sorted(yr.tolist()) == sorted(re.tolist())
    gr, gi = fft_int(re, im, cfg)
    assert np.array_equal(yr, gr.astype(np.int64))


def test_wide_pair_roundtrip_is_n_times_input():
    """Unscaled FFT->IFFT pair with the inverse escalating to the wide
    plan: result ~= N*x (exactly up to twiddle quantization noise)."""
    n = 256
    cfg = FFTConfig(n=n, mode="unscaled", data_width=20, twiddle_width=25)
    re = rand_wide(16, n)  # headroom below dw keeps SNR meaningful
    im = rand_wide(16, n)
    pr, pi = fft_ifft_pair(re, im, cfg)
    pr, pi = np.asarray(pr, np.int64), np.asarray(pi, np.int64)
    nz = re != 0
    ratio = np.median(pr[nz] / re[nz])
    assert abs(ratio - n) < 0.5
    # and bit-identical to the golden pair composition
    gfr, gfi = fft_int(re, im, cfg)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    gir, gii = fft_int(gfr, gfi, icfg, inverse=True)
    assert np.array_equal(pr, gir.astype(np.int64))
    assert np.array_equal(pi, gii.astype(np.int64))


# ------------------------------------------------------ four-step wide

@pytest.mark.parametrize("mode,dw", [("unscaled", 20), ("unscaled", 24)])
def test_large_plan_wide_pass(mode, dw):
    """64k-point unscaled transform whose second pass exceeds 32 bits
    (dw=24 + 8 stages = 32 -> w1 = 32, narrow; out 40 -> wide): the plan
    runs the four-step on the XLA limb-plane path."""
    from intfftk.golden.four_step import four_step_int
    from intfftk.ops.pallas_fft import LargeFFTPlan

    cfg = FFTConfig(n=1 << 16, mode=mode, data_width=dw, twiddle_width=16)
    plan = LargeFFTPlan(cfg, interpret=True)
    assert plan.wide2 and plan.kernel == "xla"
    re = rand_wide(dw, (1, cfg.n))
    im = rand_wide(dw, (1, cfg.n))
    yr, yi = plan(re.astype(np.int32), im.astype(np.int32))
    gr, gi = four_step_int(re[0], im[0], cfg, plan.n1, plan.n2)
    assert np.array_equal(np.asarray(yr)[0], gr.astype(np.int64))
    assert np.array_equal(np.asarray(yi)[0], gi.astype(np.int64))
