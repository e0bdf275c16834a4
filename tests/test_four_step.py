"""Four-step decomposition: host oracle vs numpy, and the mesh-sharded
device implementation vs the host oracle (bit-exact), on the virtual
8-device CPU mesh (SURVEY §4: same shard_map/collective code paths as a
real pod slice)."""

import numpy as np
import pytest

from conftest import cpu_mesh

from intfftk.config import FFTConfig, snr_db
from intfftk.golden import fft_int
from intfftk.golden.four_step import (four_step_float, four_step_int)
from intfftk.golden.stimulus import random_stimulus
from intfftk.parallel import Channelizer, FourStepPlan

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


# ------------------------------------------------------------- float algebra

@pytest.mark.parametrize("n1,n2", [(8, 8), (16, 64), (64, 32)])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_float_vs_numpy(n1, n2, inverse):
    n = n1 * n2
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    ref = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    got = four_step_float(x, n1, n2, inverse=inverse)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-11


# ---------------------------------------------------- integer oracle quality

@pytest.mark.parametrize("mode,rounding", MODES)
def test_four_step_int_snr(mode, rounding):
    """Composed integer transform tracks the float transform with the same
    kind of error budget as the monolithic core."""
    n1, n2 = 32, 32
    cfg = FFTConfig(n=n1 * n2, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    # one bit of headroom: full-scale corner inputs can wrap by sqrt(2) at a
    # multiply stage in unscaled mode — identical contract to the reference
    # hardware (see docs/numerics.md)
    re, im = random_stimulus(cfg.n, 15, seed=42)
    yr, yi = four_step_int(re, im, cfg, n1, n2)
    ref = np.fft.fft(re + 1j * im)
    if mode == "scaled":
        ref = ref / cfg.n
    s = snr_db(ref, yr + 1j * yi)
    assert s > (65.0 if mode == "unscaled" else 35.0), f"SNR {s:.1f}"


def test_four_step_vs_monolithic_close():
    """Four-step and monolithic integer cores agree to within rounding noise
    (they are NOT bit-identical — different rounding schedule)."""
    n1, n2 = 32, 64
    # NOTE twiddle_width=18 is a pathological reference configuration (the
    # magnitude-headroom rule gives 2^16-1 but the renorm shift is still
    # TWD-1=17, halving data at every multiply stage — mirrored faithfully);
    # cross-checks need a unity-gain width: 16 or >= 19.
    cfg = FFTConfig(n=n1 * n2, mode="unscaled", data_width=12,
                    twiddle_width=20)
    re, im = random_stimulus(cfg.n, 11, seed=1)  # headroom, see numerics.md
    fr, fi = four_step_int(re, im, cfg, n1, n2)
    mr, mi = fft_int(re, im, cfg)
    s = snr_db(mr + 1j * mi, fr + 1j * fi)
    # each path carries its own ~62 dB quantization noise vs float; their
    # mutual agreement is bounded by that, not by machine epsilon
    assert s > 58.0, f"four-step vs monolithic SNR {s:.1f}"


def test_four_step_int_roundtrip():
    """Classic pairing: forward unscaled (exact DFT growth) + inverse scaled
    (per-stage /2 supplies exactly 1/N) -> identity up to rounding noise."""
    import dataclasses
    n1, n2 = 16, 32
    fwd = FFTConfig(n=n1 * n2, mode="unscaled", data_width=12,
                    twiddle_width=20)
    re, im = random_stimulus(fwd.n, 11, seed=2)
    yr, yi = four_step_int(re, im, fwd, n1, n2)
    inv = dataclasses.replace(fwd, mode="scaled", rounding="round",
                              data_width=fwd.output_width)
    xr, xi = four_step_int(yr, yi, inv, n1, n2, inverse=True)
    s = snr_db(re + 1j * im, xr + 1j * xi)
    assert s > 55.0, f"roundtrip SNR {s:.1f}"


# ----------------------------------------------------- device mesh bit-exact

@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("inverse", [False, True])
def test_mesh_four_step_bitexact(mode, rounding, inverse):
    n1, n2 = 32, 64
    cfg = FFTConfig(n=n1 * n2, mode=mode, rounding=rounding, data_width=12,
                    twiddle_width=16)
    mesh = cpu_mesh((8,), ("fft",))
    plan = FourStepPlan(cfg, n1, n2, mesh, inverse=inverse)
    re, im = random_stimulus(cfg.n, 12, seed=3)
    gr, gi = four_step_int(re, im, cfg, n1, n2, inverse=inverse)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_mesh_four_step_transposed_output():
    """natural_out=False returns the frequency matrix D with
    X[k2*n1+k1] = D[k1,k2]."""
    n1, n2 = 16, 32
    cfg = FFTConfig(n=n1 * n2, data_width=12)
    mesh = cpu_mesh((4,), ("fft",))
    plan = FourStepPlan(cfg, n1, n2, mesh, natural_out=False)
    re, im = random_stimulus(cfg.n, 12, seed=4)
    gr, gi = four_step_int(re, im, cfg, n1, n2)
    dr, di = plan(re, im)
    assert dr.shape == (n1, n2)
    np.testing.assert_array_equal(
        gr, np.asarray(dr, np.int64).T.reshape(-1))
    np.testing.assert_array_equal(
        gi, np.asarray(di, np.int64).T.reshape(-1))


def test_mesh_four_step_batched():
    n1, n2 = 16, 16
    cfg = FFTConfig(n=n1 * n2, data_width=10)
    mesh = cpu_mesh((4,), ("fft",))
    plan = FourStepPlan(cfg, n1, n2, mesh)
    re, im = random_stimulus(cfg.n, 10, seed=5, batch=(3,))
    gr, gi = four_step_int(re, im, cfg, n1, n2)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_mesh_four_step_large_taylor():
    """A factor large enough (8192) to exercise the Taylor twiddle stage
    inside the distributed cores, plus the 512K-class full size 8192x64."""
    n1, n2 = 8192, 64
    cfg = FFTConfig(n=n1 * n2, mode="scaled", rounding="truncate",
                    data_width=16, twiddle_width=18)
    mesh = cpu_mesh((8,), ("fft",))
    plan = FourStepPlan(cfg, n1, n2, mesh)
    re, im = random_stimulus(cfg.n, 16, seed=6)
    gr, gi = four_step_int(re, im, cfg, n1, n2)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


# -------------------------------------------------------------- channelizer

def test_channelizer_bitexact():
    cfg = FFTConfig(n=1024, mode="scaled", rounding="round")
    mesh = cpu_mesh((8,), ("ch",))
    ch = Channelizer(cfg, mesh)
    re, im = random_stimulus(1024, 16, seed=7, batch=(32,))
    gr, gi = fft_int(re, im, cfg)
    dr, di = ch(ch.shard(re), ch.shard(im))
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_channelizer_inverse_roundtrip():
    """Channelizer(inverse=True): unscaled forward -> scaled inverse
    across the mesh recovers the input to twiddle-quantization noise,
    and the inverse is bit-exact vs golden."""
    import dataclasses
    from conftest import cpu_mesh
    from intfftk.parallel.channelizer import Channelizer
    from intfftk.parallel.mesh import CHANNEL_AXIS
    from intfftk.golden import fft_int, random_stimulus

    mesh = cpu_mesh((8,), (CHANNEL_AXIS,))
    cfg = FFTConfig(n=256, mode="unscaled", data_width=12,
                    twiddle_width=16)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    fwd = Channelizer(cfg, mesh)
    inv = Channelizer(icfg, mesh, inverse=True)
    re, im = random_stimulus(256, 11, seed=13, batch=(16,))
    yr, yi = fwd(re, im)
    gr, gi = fft_int(re, im, cfg)
    g2r, g2i = fft_int(gr, gi, icfg, inverse=True)
    xr, xi = inv(np.asarray(yr), np.asarray(yi))
    np.testing.assert_array_equal(g2r, np.asarray(xr, np.int64))
    np.testing.assert_array_equal(g2i, np.asarray(xi, np.int64))
    assert np.max(np.abs(g2r - re)) < 8
