"""Overlap-save convolution: host oracle vs numpy convolve (SNR), and the
mesh/single-device implementations vs the host oracle (bit-exact)."""

import numpy as np
import pytest

from conftest import cpu_mesh

from intfftk.config import snr_db
from intfftk.golden import make_conv_spec, overlap_save_int
from intfftk.parallel.convolve import OverlapSaveConv


def _taps(m, width, seed=0, complex_taps=False):
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 2)
    hr = rng.integers(-lim, lim, m)
    hi = rng.integers(-lim, lim, m) if complex_taps else np.zeros(m, np.int64)
    return hr, hi


def _signal(t, width, seed=1):
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 2)
    return rng.integers(-lim, lim, t), rng.integers(-lim, lim, t)


def test_spec_widths():
    spec = make_conv_spec(n=1024, taps_len=129, data_width=16, taps_width=16)
    assert spec.payload == 1024 - 129 + 1
    assert spec.product_width <= 32
    assert spec.spectrum_width <= 18


def test_overlap_save_vs_numpy():
    spec = make_conv_spec(n=512, taps_len=65, data_width=16, taps_width=16)
    hr, hi = _taps(65, 16)
    t = spec.payload * 4
    xr, xi = _signal(t, 16)
    yr, yi = overlap_save_int(xr, xi, hr, hi, spec)
    ref = (np.convolve(xr + 1j * xi, hr + 1j * hi)[:t]
           / float(1 << spec.scale_log2))
    s = snr_db(ref, yr + 1j * yi)
    assert s > 50.0, f"conv SNR {s:.1f}"


def test_overlap_save_complex_taps():
    spec = make_conv_spec(n=256, taps_len=33, data_width=12, taps_width=12)
    hr, hi = _taps(33, 12, complex_taps=True)
    t = spec.payload * 3
    xr, xi = _signal(t, 12)
    yr, yi = overlap_save_int(xr, xi, hr, hi, spec)
    ref = (np.convolve(xr + 1j * xi, hr + 1j * hi)[:t]
           / float(1 << spec.scale_log2))
    s = snr_db(ref, yr + 1j * yi)
    assert s > 45.0, f"conv SNR {s:.1f}"


def test_overlap_save_rounding_beats_truncate():
    hr, hi = _taps(65, 16)
    out = {}
    for rnd in ("truncate", "round"):
        spec = make_conv_spec(n=512, taps_len=65, rounding=rnd)
        t = spec.payload * 4
        xr, xi = _signal(t, 16)
        yr, yi = overlap_save_int(xr, xi, hr, hi, spec)
        ref = (np.convolve(xr + 1j * xi, hr + 1j * hi)[:t]
               / float(1 << spec.scale_log2))
        out[rnd] = snr_db(ref, yr + 1j * yi)
    assert out["round"] > out["truncate"]


@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_device_conv_bitexact(ndev):
    spec = make_conv_spec(n=256, taps_len=33, data_width=12, taps_width=12)
    hr, hi = _taps(33, 12, complex_taps=True)
    t = spec.payload * 2 * ndev
    xr, xi = _signal(t, 12)
    gr, gi = overlap_save_int(xr, xi, hr, hi, spec)
    mesh = cpu_mesh((ndev,), ("fft",)) if ndev > 1 else None
    conv = OverlapSaveConv(spec, hr, hi, mesh=mesh)
    dr, di = conv(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_device_conv_batched():
    spec = make_conv_spec(n=256, taps_len=17, data_width=10, taps_width=10)
    hr, hi = _taps(17, 10)
    t = spec.payload * 4
    rng = np.random.default_rng(3)
    xr = rng.integers(-256, 256, (3, t))
    xi = rng.integers(-256, 256, (3, t))
    gr, gi = overlap_save_int(xr, xi, hr, hi, spec)
    mesh = cpu_mesh((4,), ("fft",))
    conv = OverlapSaveConv(spec, hr, hi, mesh=mesh)
    dr, di = conv(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_conv_four_step_engine_wide():
    """Milestone-config-4 shape at CI scale: blocks beyond the fused
    kernel's single-pass budget run the two-pass raw-chained four-step
    engine (spec.factors auto-set) with a WIDE (>32-bit) frequency product
    and limb-plane inverse — bit-exact vs the matching golden composition
    and SNR-correct vs numpy (the wide product keeps the renormalizing
    downshift shallow; a 32-bit budget at this scale costs ~30 dB)."""
    # spectrum 25 bits (the wide-B multiplier tier): taps quantization is
    # the SNR floor — every spectrum bit is ~6 dB
    spec = make_conv_spec(n=1 << 14, taps_len=(1 << 11) + 1,
                          twiddle_width=16, max_product_width=44,
                          max_spectrum_width=25)
    assert spec.factors == (128, 128)
    assert spec.product_width == 44 and spec.spectrum_width <= 25
    hr, hi = _taps(spec.taps_len, 16, complex_taps=True)
    t = spec.payload * 2
    xr, xi = _signal(t, 16)
    gr, gi = overlap_save_int(xr, xi, hr, hi, spec)
    conv = OverlapSaveConv(spec, hr, hi, mesh=None, interpret=True)
    assert conv.wide
    dr, di = conv(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))
    ref = (np.convolve(xr + 1j * xi, hr + 1j * hi)[:t]
           / float(1 << spec.scale_log2))
    s = snr_db(ref, gr + 1j * gi)
    assert s > 55.0, f"conv SNR {s:.1f}"


def test_conv_four_step_sharded():
    """Four-step blocks + ppermute halo exchange on the virtual mesh."""
    spec = make_conv_spec(n=1 << 13, taps_len=1 << 10)
    assert spec.factors is not None
    hr, hi = _taps(spec.taps_len, 16)
    ndev = 4
    t = spec.payload * ndev
    xr, xi = _signal(t, 16)
    gr, gi = overlap_save_int(xr, xi, hr, hi, spec)
    conv = OverlapSaveConv(spec, hr, hi, mesh=cpu_mesh((ndev,), ("fft",)))
    dr, di = conv(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_device_conv_length_guard():
    spec = make_conv_spec(n=256, taps_len=17)
    hr, hi = _taps(17, 16)
    conv = OverlapSaveConv(spec, hr, hi, mesh=None)
    with pytest.raises(ValueError):
        conv(np.zeros(1000), np.zeros(1000))
