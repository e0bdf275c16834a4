"""Golden-layer tests: the executable spec against external oracles.

Strategy mirrors the reference's own validation ladder (SURVEY §4):
1. float lane model vs numpy.fft        (= fn_radix2 vs Octave builtin fft)
2. integer in-place model vs lane model (= device index algebra vs RTL schedule)
3. integer model SNR vs float reference (mode-dependent bounds)
4. roundtrip identity                   (= fft_double_test)
5. bypass-fly permutation-only check    (= USE_FLY=0 fixture)
"""

import dataclasses

import numpy as np
import pytest

from intfftk.config import FFTConfig, snr_db
from intfftk.golden import (bitrev_indices, chirp_stimulus, fft_dif_float,
                                fft_dit_float, fft_int, fft_int_lanes,
                                random_stimulus, stage_twiddles_float,
                                stage_twiddles_int)

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


# ---------------------------------------------------------------- float model

@pytest.mark.parametrize("n", [8, 16, 128, 1024, 8192])
def test_float_model_vs_numpy(n, ):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    ref = np.fft.fft(x)
    got = fft_dif_float(x)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-12


@pytest.mark.parametrize("n", [8, 64, 1024])
def test_float_inverse_unnormalized(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    got = fft_dit_float(np.fft.fft(x))
    assert np.max(np.abs(got / n - x)) < 1e-10


# ------------------------------------------------- lane vs in-place bit-equal

@pytest.mark.parametrize("n", [8, 64, 512, 4096])
@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("dw,tw", [(16, 16), (12, 18), (24, 25)])
def test_lane_vs_inplace_bitexact(n, mode, rounding, dw, tw):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=tw)
    re, im = random_stimulus(n, dw, seed=n + dw)
    for inv in (False, True):
        r1, i1 = fft_int(re, im, cfg, inverse=inv)
        r2, i2 = fft_int_lanes(re, im, cfg, inverse=inv)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(i1, i2)


# --------------------------------------------------------------- SNR vs float

@pytest.mark.parametrize("n", [256, 1024, 16384])
def test_unscaled_snr(n):
    cfg = FFTConfig(n=n, mode="unscaled", data_width=16, twiddle_width=16)
    re, im = chirp_stimulus(n, 16)
    yr, yi = fft_int(re, im, cfg)
    ref = np.fft.fft(re + 1j * im)
    # 16-bit twiddle quantization floor: ~6.02*16-ish dB minus stage noise
    assert snr_db(ref, yr + 1j * yi) > 70.0


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("rounding", ["truncate", "round"])
def test_scaled_snr(n, rounding):
    cfg = FFTConfig(n=n, mode="scaled", rounding=rounding, data_width=16,
                    twiddle_width=16)
    re, im = chirp_stimulus(n, 16)
    yr, yi = fft_int(re, im, cfg)
    ref = np.fft.fft(re + 1j * im) / n
    s = snr_db(ref, yr + 1j * yi)
    floor = 40.0 if rounding == "truncate" else 45.0
    assert s > floor, f"SNR {s:.1f} < {floor}"
    if rounding == "round":
        # round mode must beat truncate
        cfg_t = dataclasses.replace(cfg, rounding="truncate")
        yr_t, yi_t = fft_int(re, im, cfg_t)
        assert s > snr_db(ref, yr_t + 1j * yi_t)


def test_wide_twiddle_more_accurate():
    n = 4096
    re, im = chirp_stimulus(n, 16)
    ref = np.fft.fft(re + 1j * im)
    out = {}
    for tw in (16, 20, 24):
        cfg = FFTConfig(n=n, mode="unscaled", data_width=16, twiddle_width=tw)
        yr, yi = fft_int(re, im, cfg)
        out[tw] = snr_db(ref, yr + 1j * yi)
    assert out[16] < out[20] < out[24]


# ----------------------------------------------------------------- roundtrip

@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_unscaled_roundtrip(n):
    cfg = FFTConfig(n=n, mode="unscaled", data_width=16, twiddle_width=16)
    re, im = chirp_stimulus(n, 16)
    yr, yi = fft_int(re, im, cfg)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    xr, xi = fft_int(yr, yi, icfg, inverse=True)
    rt = (xr + 1j * xi) / n
    assert snr_db(re + 1j * im, rt) > 65.0


# ------------------------------------------------------------------- twiddles

@pytest.mark.parametrize("p", [2, 5, 10])
def test_twiddle_quantization_small(p):
    tw = 16
    re, im = stage_twiddles_int(p, tw)
    ref = stage_twiddles_float(p)
    mag = (1 << (tw - 1)) - 1
    assert np.max(np.abs(re - np.round(mag * ref.real))) <= 1
    assert np.max(np.abs(im - np.round(mag * ref.imag))) <= 1


@pytest.mark.parametrize("p", [11, 13, 16])
def test_twiddle_taylor_error(p):
    """Taylor stages: first-order correction keeps error within a few LSB."""
    tw = 16
    re, im = stage_twiddles_int(p, tw)
    ref = stage_twiddles_float(p)
    mag = (1 << (tw - 1)) - 1
    err = np.abs((re + 1j * im) - mag * ref)
    assert np.max(err) < 4.0, f"max twiddle err {np.max(err):.2f} LSB"
    # and the rom-exact path must be strictly better
    re2, im2 = stage_twiddles_int(p, tw, twiddle_gen="rom")
    err2 = np.abs((re2 + 1j * im2) - mag * ref)
    assert np.max(err2) <= 1.0


def test_twiddle_fold_quadrant():
    """Quadrant-2 entries are exactly (-j) * quadrant-1 entries."""
    p = 6
    re, im = stage_twiddles_int(p, 16)
    h = 1 << (p - 1)
    np.testing.assert_array_equal(re[h:], im[:h])
    np.testing.assert_array_equal(im[h:], -re[:h])


# ------------------------------------------------------------------ bypass

@pytest.mark.parametrize("n", [16, 256])
def test_bypass_fly_permutation_only(n):
    cfg = FFTConfig(n=n, bypass_fly=True)
    re, im = random_stimulus(n, 16, seed=7)
    rev = bitrev_indices(n)
    yr, yi = fft_int(re, im, cfg)
    np.testing.assert_array_equal(yr, re[rev])
    np.testing.assert_array_equal(yi, im[rev])


# --------------------------------------------------------------- batch shape

def test_batched_golden():
    cfg = FFTConfig(n=64)
    re, im = random_stimulus(64, 16, seed=3, batch=(5,))
    yr, yi = fft_int(re, im, cfg)
    for b in range(5):
        r1, i1 = fft_int(re[b], im[b], cfg)
        np.testing.assert_array_equal(yr[b], r1)
        np.testing.assert_array_equal(yi[b], i1)


# ------------------------------------------------------------- config surface

def test_reference_mode_decoder():
    c = FFTConfig.from_reference_mode(1024, "UNSCALED")
    assert c.mode == "unscaled"
    c = FFTConfig.from_reference_mode(1024, "ROUNDING")
    assert c.mode == "scaled" and c.rounding == "round"
    c = FFTConfig.from_reference_mode(1024, "TRUNCATE")
    assert c.mode == "scaled" and c.rounding == "truncate"


def test_config_validation():
    with pytest.raises(ValueError):
        FFTConfig(n=100)
    with pytest.raises(ValueError):
        FFTConfig(n=1024, data_width=4)
    with pytest.raises(ValueError):
        FFTConfig(n=1024, twiddle_width=40)


# ------------------------------------------------------------- sanitizer

def test_overflow_sanitizer_clean_with_headroom():
    from intfftk.golden.sanitize import check_overflow
    cfg = FFTConfig(n=256, mode="unscaled", data_width=16, twiddle_width=16)
    re, im = random_stimulus(256, 15, seed=1)  # 1 bit headroom
    rep = check_overflow(re, im, cfg)
    assert rep.clean, str(rep)


def test_overflow_sanitizer_detects_fullscale_wrap():
    from intfftk.golden.sanitize import check_overflow
    cfg = FFTConfig(n=256, mode="unscaled", data_width=16, twiddle_width=16)
    re, im = random_stimulus(256, 16, seed=1)  # full scale: sqrt2 wraps
    rep = check_overflow(re, im, cfg)
    assert not rep.clean
    assert min(rep.stage_wraps) >= 0  # inputs in contract, wraps in stages


def test_overflow_sanitizer_scaled_clean_with_headroom():
    """Scaled mode also wraps on full-scale corner inputs (the same sqrt2
    complex-rotation excess as unscaled — a property of the reference
    arithmetic as well); one bit of headroom makes it provably clean."""
    from intfftk.golden.sanitize import check_overflow
    for rnd in ("truncate", "round"):
        cfg = FFTConfig(n=512, mode="scaled", rounding=rnd)
        re, im = random_stimulus(512, 15, seed=2)
        rep = check_overflow(re, im, cfg)
        assert rep.clean, str(rep)


def test_overflow_sanitizer_flags_bad_input():
    from intfftk.golden.sanitize import check_overflow
    cfg = FFTConfig(n=64, data_width=12)
    re, im = random_stimulus(64, 16, seed=3)  # 16-bit data in 12-bit config
    rep = check_overflow(re, im, cfg)
    assert -1 in rep.stage_wraps


# ----------------------------------------------------- Taylor variant matrix

def test_taylor_use_mlt_equivalence():
    """USE_MLT=TRUE (18x18 DSP delta product) and FALSE (16-bit ROM) are
    bit-identical in every legal configuration: MATHPI*(2^(ii+1)-1) <
    pi*2^14 < 2^16, so the ROM's 16-bit wrap never engages
    (row_twiddle_tay.vhd:206-240)."""
    from intfftk.golden.twiddle import taylor_mathpi, taylor_mpi
    for ser in ("old", "new"):
        for ii in range(8):
            cnt = np.arange(1 << (ii + 1))
            rom = taylor_mpi(cnt, ii, ser, use_mlt=False)
            dsp = taylor_mpi(cnt, ii, ser, use_mlt=True)
            np.testing.assert_array_equal(rom, dsp)
            assert taylor_mathpi(ii, ser) * cnt[-1] < (1 << 16)


def test_taylor_mathpi_pinned():
    """The VHDL elaboration constants, re-derived by hand:
    INTEGER(MATH_PI * 2^(13-ii)) for XSER=OLD, 2^(11-ii) for NEW."""
    from intfftk.golden.twiddle import taylor_mathpi
    assert taylor_mathpi(0, "old") == 25736   # pi * 2^13
    assert taylor_mathpi(1, "old") == 12868
    assert taylor_mathpi(7, "old") == 201     # pi * 2^6
    assert taylor_mathpi(0, "new") == 6434    # pi * 2^11
    assert taylor_mathpi(1, "new") == 3217
    assert taylor_mathpi(7, "new") == 50      # pi * 2^4


def test_taylor_xser_variants_pinned():
    """Hand-derived table entries for both XSER constant sets at stage
    order p = 12 (generic ii = 1), entry k = 7: addrx = 1, count = 3.

    OLD: XSHIFT 23, MATHPI 12868 -> mpx = (12868*3) >> 1 = 19302
    NEW: XSHIFT 21, MATHPI  3217 -> mpx = ( 3217*3) >> 1 = 4825
    correction: re' = rnd((re<<XS) + im*mpx), im' = rnd((im<<XS) - re*mpx)
    with rnd = round-half-up at bit XS-1.
    """
    import math
    from intfftk.golden.twiddle import stage_twiddles_int

    mag = 32767
    re0 = int(np.floor(mag * math.cos(math.pi / 1024) + 0.5))
    im0 = -int(np.floor(mag * math.sin(math.pi / 1024) + 0.5))

    def expect(xs, mpx):
        def rnd(v):
            t = v >> (xs - 1)
            return (t >> 1) + (t & 1)
        return (rnd((re0 << xs) + im0 * mpx),
                rnd((im0 << xs) - re0 * mpx))

    for gen, xs, mpx in [("auto", 23, 19302), ("taylor_old", 23, 19302),
                         ("taylor_new", 21, 4825)]:
        re, im = stage_twiddles_int(12, 16, gen)
        er, ei = expect(xs, mpx)
        assert (re[7], im[7]) == (er, ei), (gen, re[7], im[7], er, ei)

    old = stage_twiddles_int(12, 16, "auto")
    new = stage_twiddles_int(12, 16, "taylor_new")
    assert not np.array_equal(old[0], new[0])  # distinct constant sets


def test_taylor_new_accuracy():
    """Both XSER sets track the float twiddles to a few LSB."""
    import math
    from intfftk.golden.twiddle import (magnitude, stage_twiddles_float,
                                            stage_twiddles_int)
    ref = stage_twiddles_float(12) * magnitude(16)
    for gen in ("auto", "taylor_new"):
        re, im = stage_twiddles_int(12, 16, gen)
        err = np.max(np.abs(re + 1j * im - ref))
        assert err < 24, (gen, err)
