"""Device (XLA) compute path vs the golden integer model — bit-exact.

This is the framework analog of the reference's RTL-vs-`fn_radix2.m`
comparison (SURVEY §4), with the bar raised from "same waveform" to
"identical integers for every mode/width/size".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from intfftk.config import FFTConfig
from intfftk.golden import cmult_int, fft_int
from intfftk.golden.stimulus import chirp_stimulus, random_stimulus
from intfftk.ops import FFTPlan, fft, fft_ifft_pair, ifft
from intfftk.ops.intmath import CmultPlan, cmult_exact

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


def _run_both(cfg, re, im, inverse=False):
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    plan = FFTPlan(cfg, inverse=inverse)
    dr, di = jax.jit(plan)(jnp.asarray(re, jnp.int32), jnp.asarray(im, jnp.int32))
    return (np.asarray(gr), np.asarray(gi),
            np.asarray(dr, dtype=np.int64), np.asarray(di, dtype=np.int64))


# ------------------------------------------------------------ exact cmult limb

@pytest.mark.parametrize("dw,tw", [(16, 16), (17, 16), (16, 17), (24, 18),
                                   (25, 18), (30, 18), (32, 16), (32, 18),
                                   (16, 25), (20, 25), (24, 25), (28, 25),
                                   (32, 25), (32, 27), (12, 27)])
def test_cmult_exact_vs_int64(dw, tw):
    """Limb-decomposed int32 complex multiply == int64 reference, including
    the extreme corners of both operand ranges."""
    rng = np.random.default_rng(dw * 100 + tw)
    lo_d, hi_d = -(1 << (dw - 1)), (1 << (dw - 1)) - 1
    mag = (1 << (tw - 1)) - 1 if tw < 18 else (1 << (tw - 2)) - 1
    n = 4096
    br = rng.integers(lo_d, hi_d + 1, n)
    bi = rng.integers(lo_d, hi_d + 1, n)
    th = rng.uniform(0, 2 * np.pi, n)
    c = np.round(mag * np.cos(th)).astype(np.int64)
    d = np.round(mag * np.sin(th)).astype(np.int64)
    # corner values
    br[:4] = [lo_d, lo_d, hi_d, hi_d]
    bi[:4] = [lo_d, hi_d, lo_d, hi_d]
    c[:2], d[:2] = [mag, -mag], [-mag, mag]

    shift = tw - 1 if tw < 19 else tw - 2
    ref_r, ref_i = cmult_int(br, bi, c, d, shift, dw)

    plan = CmultPlan(data_width=dw, twiddle_width=tw, shift=shift, out_width=dw)
    got_r, got_i = cmult_exact(plan, jnp.asarray(br, jnp.int32),
                               jnp.asarray(bi, jnp.int32),
                               jnp.asarray(c, jnp.int32),
                               jnp.asarray(d, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got_r, np.int64), ref_r)
    np.testing.assert_array_equal(np.asarray(got_i, np.int64), ref_i)


def test_cmult_exact_conj():
    plan = CmultPlan(data_width=24, twiddle_width=18, shift=16, out_width=24)
    rng = np.random.default_rng(0)
    br = rng.integers(-(1 << 23), 1 << 23, 512)
    bi = rng.integers(-(1 << 23), 1 << 23, 512)
    c = rng.integers(-(1 << 16), 1 << 16, 512)
    d = rng.integers(-(1 << 16), 1 << 16, 512)
    ref_r, ref_i = cmult_int(br, bi, c, -d, 16, 24)
    got_r, got_i = cmult_exact(plan, *map(lambda a: jnp.asarray(a, jnp.int32),
                                          (br, bi, c, d)), conj=True)
    np.testing.assert_array_equal(np.asarray(got_r, np.int64), ref_r)
    np.testing.assert_array_equal(np.asarray(got_i, np.int64), ref_i)


# ----------------------------------------------------- staged transform exact

@pytest.mark.parametrize("n", [8, 64, 1024, 8192])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_device_bitexact(n, mode, rounding):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    if cfg.output_width > 32:
        pytest.skip("exceeds device width")
    re, im = random_stimulus(n, 16, seed=n)
    gr, gi, dr, di = _run_both(cfg, re, im)
    np.testing.assert_array_equal(gr, dr)
    np.testing.assert_array_equal(gi, di)


@pytest.mark.parametrize("n", [8, 64, 1024])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_ifft_device_bitexact(n, mode, rounding):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    if cfg.output_width > 32:
        pytest.skip("exceeds device width")
    re, im = random_stimulus(n, 16, seed=n + 1)
    gr, gi, dr, di = _run_both(cfg, re, im, inverse=True)
    np.testing.assert_array_equal(gr, dr)
    np.testing.assert_array_equal(gi, di)


@pytest.mark.parametrize("dw,tw", [(8, 16), (12, 18), (16, 24), (20, 25),
                                   (24, 16), (32, 16), (32, 25), (28, 27)])
def test_fft_device_width_sweep_scaled(dw, tw):
    """Scaled mode keeps width constant — every input width up to 32 works."""
    n = 256
    cfg = FFTConfig(n=n, mode="scaled", rounding="round", data_width=dw,
                    twiddle_width=tw)
    re, im = random_stimulus(n, dw, seed=dw * 7 + tw)
    gr, gi, dr, di = _run_both(cfg, re, im)
    np.testing.assert_array_equal(gr, dr)
    np.testing.assert_array_equal(gi, di)


@pytest.mark.parametrize("n,dw", [(256, 24), (4096, 20), (16384, 18)])
def test_fft_device_unscaled_growth(n, dw):
    """Unscaled growth up to the 32-bit output ceiling (incl. 64k points)."""
    cfg = FFTConfig(n=n, mode="unscaled", data_width=dw, twiddle_width=16)
    assert cfg.output_width == 32
    re, im = random_stimulus(n, dw, seed=dw)
    gr, gi, dr, di = _run_both(cfg, re, im)
    np.testing.assert_array_equal(gr, dr)
    np.testing.assert_array_equal(gi, di)


def test_fft_device_taylor_stages():
    """N = 8192 forward has a stage of twiddle order 12 -> Taylor path."""
    n = 8192
    cfg = FFTConfig(n=n, mode="scaled", rounding="truncate", data_width=16,
                    twiddle_width=18)
    re, im = chirp_stimulus(n, 16)
    gr, gi, dr, di = _run_both(cfg, re, im)
    np.testing.assert_array_equal(gr, dr)
    np.testing.assert_array_equal(gi, di)


def test_fft_device_batched_jit():
    cfg = FFTConfig(n=512, mode="scaled", rounding="round")
    re, im = random_stimulus(512, 16, seed=5, batch=(3, 4))
    gr, gi = fft_int(re, im, cfg)
    plan = FFTPlan(cfg)
    dr, di = jax.jit(plan)(jnp.asarray(re, jnp.int32), jnp.asarray(im, jnp.int32))
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_fft_device_vmap():
    cfg = FFTConfig(n=256)
    re, im = random_stimulus(256, 16, seed=6, batch=(4,))
    plan = FFTPlan(cfg)
    vr, vi = jax.vmap(plan)(jnp.asarray(re, jnp.int32), jnp.asarray(im, jnp.int32))
    br, bi = plan(jnp.asarray(re, jnp.int32), jnp.asarray(im, jnp.int32))
    np.testing.assert_array_equal(np.asarray(vr), np.asarray(br))
    np.testing.assert_array_equal(np.asarray(vi), np.asarray(bi))


def test_bypass_fly_device():
    cfg = FFTConfig(n=128, bypass_fly=True)
    re, im = random_stimulus(128, 16, seed=9)
    gr, gi, dr, di = _run_both(cfg, re, im)
    np.testing.assert_array_equal(gr, dr)
    np.testing.assert_array_equal(gi, di)


# ------------------------------------------------------------------ roundtrip

@pytest.mark.parametrize("mode,rounding", MODES)
def test_pair_roundtrip_device(mode, rounding):
    """FFT->IFFT pair == golden pair, and scaled pair ~= identity/unscaled
    pair == N*x (the int_fft_ifft_pair contract)."""
    n = 1024
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    if icfg.output_width > 32:
        pytest.skip("exceeds device width")
    re, im = random_stimulus(n, 14, seed=11)
    yr, yi = fft_int(re, im, cfg)
    gr, gi = fft_int(yr, yi, icfg, inverse=True)
    dr, di = jax.jit(lambda a, b: fft_ifft_pair(a, b, cfg))(
        jnp.asarray(re, jnp.int32), jnp.asarray(im, jnp.int32))
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_unscaled_pair_is_n_times_input():
    n = 256
    cfg = FFTConfig(n=n, mode="unscaled", data_width=12, twiddle_width=25)
    re, im = random_stimulus(n, 10, seed=13)
    dr, di = fft_ifft_pair(jnp.asarray(re, jnp.int32),
                           jnp.asarray(im, jnp.int32), cfg)
    # unscaled roundtrip = N*x up to twiddle quantization noise
    err_r = np.asarray(dr, np.float64) / n - re
    err_i = np.asarray(di, np.float64) / n - im
    assert np.max(np.abs(err_r)) < 4.0 and np.max(np.abs(err_i)) < 4.0


def test_device_width_guard():
    cfg = FFTConfig(n=1 << 17, mode="unscaled", data_width=16)
    with pytest.raises(NotImplementedError):
        FFTPlan(cfg)


def test_pair_fly_knockouts():
    """FLY_FWD/FLY_INV per-core bypass on the pair
    (``int_fft_ifft_pair.vhd:92-93``): both off -> pure permutation
    roundtrip == identity; one off -> the live core applied to the other
    side's permutation-only stream."""
    n = 256
    cfg = FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    re, im = random_stimulus(n, 14, seed=17)
    xr, xi = jnp.asarray(re, jnp.int32), jnp.asarray(im, jnp.int32)

    # both knocked out: bitrev then un-bitrev — exact identity
    dr, di = fft_ifft_pair(xr, xi, cfg, fly_fwd=False, fly_inv=False)
    np.testing.assert_array_equal(re, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(im, np.asarray(di, np.int64))

    # fwd knocked out: fwd emits bitrev(x), the live natural-order IFFT
    # consumes it -> pair == IFFT(x[rev]) at the widened config
    from intfftk.golden.float_model import bitrev_indices
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    rev = bitrev_indices(n)
    gr, gi = fft_int(re[rev], im[rev], icfg, inverse=True)
    dr, di = fft_ifft_pair(xr, xi, cfg, fly_fwd=False)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))

    # inv knocked out: the bypassed inverse core still applies its input
    # bit-reversal (the permutation network stays live) -> FFT(x)[rev]
    fr, fi = fft_int(re, im, cfg)
    dr, di = fft_ifft_pair(xr, xi, cfg, fly_inv=False)
    np.testing.assert_array_equal(fr[rev], np.asarray(dr, np.int64))
    np.testing.assert_array_equal(fi[rev], np.asarray(di, np.int64))


@pytest.mark.parametrize("n", [1 << 16, 1 << 19])
def test_staged_monolithic_bits_64k_512k(n):
    """The staged XLA core carries the MONOLITHIC bit contract at the
    reference's large sizes (int_fftNk.vhd:12 bit-specifies N up to
    512K; per-stage rounding int_dif2_fly.vhd:144-219), the engine of
    LargeFFTPlan(schedule="monolithic"): monolithic bits at 64K and the
    512K maximum, batch 1, scaled/round int16."""
    cfg = FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    re, im = random_stimulus(n, 15, seed=31)
    gr, gi = fft_int(re, im, cfg)
    plan = FFTPlan(cfg)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))
