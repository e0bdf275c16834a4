"""Native C++ engine vs the NumPy golden model — triple-agreement oracle
(SURVEY §4: the C++ engine is an independent reimplementation of the same
RTL semantics; bit-equality across C++/NumPy/JAX is the framework's
sanitizer)."""

import os

import numpy as np
import pytest

from intfftk.config import FFTConfig
from intfftk.golden import fft_int, random_stimulus, stage_twiddles_int

try:
    from intfftk.runtime import NativeGolden, native_available
    HAVE = native_available()
except Exception:
    HAVE = False

if not HAVE and os.environ.get("INTFFTK_REQUIRE_NATIVE"):
    raise RuntimeError("native golden engine required but unavailable "
                       "(INTFFTK_REQUIRE_NATIVE set) — a silent skip here "
                       "would mask loss of the second oracle")

pytestmark = pytest.mark.skipif(not HAVE, reason="native engine unavailable")

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


@pytest.fixture(scope="module")
def eng():
    return NativeGolden()


@pytest.mark.parametrize("n", [8, 256, 4096])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_native_vs_numpy(eng, n, mode, rounding):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    re, im = random_stimulus(n, 16, seed=n, batch=(4,))
    gr, gi = fft_int(re, im, cfg)
    nr, ni = eng.fft(re, im, cfg)
    np.testing.assert_array_equal(gr, nr)
    np.testing.assert_array_equal(gi, ni)
    gr, gi = fft_int(re, im, cfg, inverse=True)
    nr, ni = eng.fft(re, im, cfg, inverse=True)
    np.testing.assert_array_equal(gr, nr)
    np.testing.assert_array_equal(gi, ni)


def test_native_taylor_stage(eng):
    """n = 8192 -> twiddle order 12 stage exercises the Taylor generator."""
    cfg = FFTConfig(n=8192, mode="scaled", rounding="truncate",
                    data_width=16, twiddle_width=18)
    re, im = random_stimulus(8192, 16, seed=1)
    gr, gi = fft_int(re, im, cfg)
    nr, ni = eng.fft(re, im, cfg)
    np.testing.assert_array_equal(gr, nr)
    np.testing.assert_array_equal(gi, ni)


@pytest.mark.parametrize("p", [2, 7, 11, 13])
@pytest.mark.parametrize("w", [16, 18, 25])
def test_native_twiddle_tables(eng, p, w):
    gre, gim = stage_twiddles_int(p, w)
    nre, nim = eng.stage_twiddles(p, w)
    np.testing.assert_array_equal(gre, nre)
    np.testing.assert_array_equal(gim, nim)
    gre, gim = stage_twiddles_int(p, w, twiddle_gen="rom")
    nre, nim = eng.stage_twiddles(p, w, twiddle_gen="rom")
    np.testing.assert_array_equal(gre, nre)
    np.testing.assert_array_equal(gim, nim)


def test_native_wide_widths(eng):
    """24-bit data, 25-bit twiddles, unscaled growth."""
    cfg = FFTConfig(n=1024, mode="unscaled", data_width=24, twiddle_width=25)
    re, im = random_stimulus(1024, 24, seed=2)
    gr, gi = fft_int(re, im, cfg)
    nr, ni = eng.fft(re, im, cfg)
    np.testing.assert_array_equal(gr, nr)
    np.testing.assert_array_equal(gi, ni)


def test_native_bypass_and_guards(eng):
    cfg = FFTConfig(n=64, bypass_fly=True)
    re, im = random_stimulus(64, 16, seed=3)
    gr, gi = fft_int(re, im, cfg)
    nr, ni = eng.fft(re, im, cfg)
    np.testing.assert_array_equal(gr, nr)
    with pytest.raises(ValueError):
        eng.fft(np.zeros(32), np.zeros(32), FFTConfig(n=64))
    with pytest.raises(ValueError):
        # output width 52 + 14 > 63 -> native rejects, python handles
        eng.fft(np.zeros(16384), np.zeros(16384),
                FFTConfig(n=16384, mode="unscaled", data_width=52))


@pytest.mark.parametrize("gen", ["auto", "rom", "taylor_new"])
def test_native_twiddle_variants(eng, gen):
    """C++ twin matches the Python tables for every generator variant,
    including the XSER="NEW" constant set at a Taylor stage."""
    from intfftk.golden.twiddle import stage_twiddles_int
    p = 12
    gre, gim = stage_twiddles_int(p, 16, gen)
    nre, nim = eng.stage_twiddles(p, 16, gen)
    np.testing.assert_array_equal(gre, nre)
    np.testing.assert_array_equal(gim, nim)
