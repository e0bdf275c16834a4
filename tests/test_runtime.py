"""Streaming executor and utils: bursty-chunk protocol tests (the analog of
the reference testbench's continuous/gapped/1-in-3 enable stress,
``fft_signle_test.vhd:154-358``) plus .dat IO and roofline sanity."""

import numpy as np

from intfftk.config import FFTConfig
from intfftk.golden import fft_int, random_stimulus
from intfftk.ops.pallas_fft import PallasFFTPlan
from intfftk.runtime.stream import StreamExecutor
from intfftk.utils import (fft_cost, read_dat, roofline_fraction,
                               write_dat)


def _collect(gen):
    out_r, out_i = [], []
    for yr, yi in gen:
        out_r.append(yr)
        out_i.append(yi)
    return out_r, out_i


def test_stream_bursty_chunks(tmp_path):
    """Feed 300 transforms in irregular bursts; output == batch reference
    regardless of chunking (the WRAP-mode contract)."""
    n, total = 64, 300
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    plan = PallasFFTPlan(cfg, layout="nb", interpret=True)
    re, im = random_stimulus(n, 16, seed=1, batch=(total,))
    gr, gi = fft_int(re, im, cfg)

    ex = StreamExecutor(plan, n=n, lane_tile=128)
    rng = np.random.default_rng(0)
    pos, chunks_r, chunks_i = 0, [], []
    got_r, got_i = [], []
    while pos < total:
        c = int(rng.integers(1, 97))
        c = min(c, total - pos)
        r, i = _collect(ex.feed(re[pos:pos + c].T, im[pos:pos + c].T))
        got_r += r
        got_i += i
        pos += c
    r, i = _collect(ex.flush())
    got_r += r
    got_i += i
    out_r = np.concatenate(got_r, axis=1).T
    out_i = np.concatenate(got_i, axis=1).T
    np.testing.assert_array_equal(gr, out_r.astype(np.int64))
    np.testing.assert_array_equal(gi, out_i.astype(np.int64))


def test_stream_sharded_channelizer():
    """BASELINE config 3's streaming half COMPOSED with its sharded half:
    a StreamExecutor feeds a mesh-sharded Channelizer (8 virtual devices
    on the 'ch' axis); bursty chunks in, bit-exact blocks out, channels
    split across the mesh inside every dispatch."""
    from conftest import cpu_mesh
    from intfftk.parallel.channelizer import Channelizer
    from intfftk.parallel.mesh import CHANNEL_AXIS

    n, total = 64, 300
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    mesh = cpu_mesh((8,), (CHANNEL_AXIS,))
    ch = Channelizer(cfg, mesh)
    re, im = random_stimulus(n, 16, seed=3, batch=(total,))
    gr, gi = fft_int(re, im, cfg)

    ex = ch.stream(lane_tile=128, depth=2)
    rng = np.random.default_rng(1)
    pos, got_r, got_i = 0, [], []
    while pos < total:
        c = min(int(rng.integers(1, 97)), total - pos)
        r, i = _collect(ex.feed(re[pos:pos + c].T, im[pos:pos + c].T))
        got_r += r
        got_i += i
        pos += c
    r, i = _collect(ex.flush())
    out_r = np.concatenate(got_r + r, axis=1).T
    out_i = np.concatenate(got_i + i, axis=1).T
    np.testing.assert_array_equal(gr, out_r.astype(np.int64))
    np.testing.assert_array_equal(gi, out_i.astype(np.int64))

    import pytest
    with pytest.raises(ValueError, match="divide over"):
        ch.stream(lane_tile=100)


def test_dat_roundtrip(tmp_path):
    p = str(tmp_path / "di_single.dat")
    re, im = random_stimulus(128, 16, seed=2)
    write_dat(p, re, im)
    r2, i2 = read_dat(p)
    np.testing.assert_array_equal(re, r2)
    np.testing.assert_array_equal(im, i2)
    # four-column pair layout
    p2 = str(tmp_path / "di_double.dat")
    write_dat(p2, re, im, im, re)
    cols = read_dat(p2)
    assert len(cols) == 4
    np.testing.assert_array_equal(cols[3], re)


def test_roofline_model():
    c_fused = fft_cost(65536, 128, fused=True)
    c_staged = fft_cost(65536, 128, fused=False)
    assert c_staged.hbm_bytes == 16 * c_fused.hbm_bytes  # log2(n) passes
    # fraction of a hypothetical 2x-roofline measurement against
    # caller-supplied ceilings (int ops/s, bytes/s)
    ceil = (1e12, 1e12)
    f = roofline_fraction(2 * c_fused.time_bound(ceil), c_fused, ceil)
    assert abs(f - 0.5) < 1e-9


def test_lane_format_conversions():
    """iobuf/inbuf/outbuf parity: the format conversions compose the way
    the reference buffers do, and PAIR bitrev matches its spec."""
    from intfftk.utils.lanes import (bitrev_pair, bitrev_pair_indices,
                                         halves_to_interleave2,
                                         interleave2_to_halves,
                                         merge_halves, split_halves)
    from intfftk.golden import bitrev_indices
    n = 64
    x = np.arange(n) * 10
    a, b = split_halves(x)
    np.testing.assert_array_equal(merge_halves(a, b), x)
    ev, od = x[0::2], x[1::2]
    ha, hb = interleave2_to_halves(ev, od)
    np.testing.assert_array_equal(merge_halves(ha, hb), x)
    e2, o2 = halves_to_interleave2(ha, hb)
    np.testing.assert_array_equal(e2, ev)
    np.testing.assert_array_equal(o2, od)
    # PAIR bitrev: MSB fixed, low bits reversed
    rev = bitrev_pair_indices(n)
    full = bitrev_indices(n)
    h = n // 2
    np.testing.assert_array_equal(rev[:h] * 2, full[:h])
    y = bitrev_pair(x)
    assert y[0] == x[0] and y[h] == x[h]


def test_channelizer_nc_layout():
    """layout='nc' ([n, channels], channels across): the transpose-free
    engine, sharded over the channel axis — bit-exact, both batched and
    streamed."""
    from conftest import cpu_mesh
    from intfftk.parallel.channelizer import Channelizer
    from intfftk.parallel.mesh import CHANNEL_AXIS

    n, ch = 128, 256
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    mesh = cpu_mesh((8,), (CHANNEL_AXIS,))
    c = Channelizer(cfg, mesh, layout="nc")
    re, im = random_stimulus(n, 16, seed=5, batch=(ch,))
    gr, gi = fft_int(re, im, cfg)
    yr, yi = c(re.T, im.T)          # [n, ch]
    np.testing.assert_array_equal(gr, np.asarray(yr, np.int64).T)
    np.testing.assert_array_equal(gi, np.asarray(yi, np.int64).T)

    ex = c.stream(lane_tile=128)
    got_r = []
    for sl in (np.s_[0:100], np.s_[100:256]):
        for br, bi_ in ex.feed(re[sl].T, im[sl].T):
            got_r.append(br)
    for br, bi_ in ex.flush():
        got_r.append(br)
    out = np.concatenate(got_r, axis=1).T
    np.testing.assert_array_equal(gr, out.astype(np.int64))


def test_examples_run():
    """The user-facing example walkthroughs (the reference's
    fft_single.m / fft_double_test analogs) stay green."""
    import os
    import subprocess
    import sys as _sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for script, args in [("examples/fft_single.py", ["256", "16"]),
                         ("examples/fft_ifft_pair.py", ["256"])]:
        r = subprocess.run(
            [_sys.executable, os.path.join(root, script), *args, "--cpu"],
            capture_output=True, text=True, timeout=500, cwd=root)
        assert r.returncode == 0, f"{script}: {r.stderr[-1500:]}"
