"""Taylor twiddle synthesis (ops/twiddle_synth.py) vs the golden spec.

The reference never materializes O(N) twiddles: a 512-deep quarter-wave
ROM plus an exact first-order integer Taylor MACC generates every stage
stream (``rom_twiddle_int.vhd:40-58``, ``row_twiddle_tay.vhd:28-42``).
These tests pin the device generator to ``golden.twiddle`` bit-for-bit:
the traced block synthesizer against the host circle table at several
sizes/XSER sets/directions, and the generated epilogue table through a
256K two-pass pipeline in interpret mode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from intfftk.config import FFTConfig
from intfftk.golden import random_stimulus
from intfftk.golden.four_step import four_step_int
from intfftk.golden.twiddle import circle_twiddles_int
from intfftk.ops.twiddle_synth import (can_synth, device_circle_table,
                                           packed_coarse,
                                           synth_circle_block)


@pytest.mark.parametrize("n,gen", [(1 << 18, "auto"), (1 << 20, "auto"),
                                   (1 << 20, "taylor_new")])
@pytest.mark.parametrize("inverse", [False, True])
def test_synth_block_bits(n, gen, inverse):
    L = n.bit_length() - 1
    l2 = L // 2
    n2, n1 = 1 << l2, n >> l2
    cfg = FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16, twiddle_gen=gen)
    assert can_synth(cfg)
    wc_re, wc_im = circle_twiddles_int(n, 16, gen)
    m = (np.arange(n1)[:, None] * np.arange(n2)[None, :]) % n
    if inverse:
        m = (-m) % n
    tbl = jnp.asarray(packed_coarse(cfg))
    er, ei = jax.jit(lambda t: synth_circle_block(
        t, n1, n2, 0, n, cfg, inverse))(tbl)
    assert np.array_equal(np.asarray(er), wc_re[m])
    assert np.array_equal(np.asarray(ei), wc_im[m])


def test_device_circle_table_bits():
    n = 1 << 19
    cfg = FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    n1, n2 = 1 << 10, 1 << 9
    wc_re, wc_im = circle_twiddles_int(n, 16, "auto")
    m = (np.arange(n1)[:, None] * np.arange(n2)[None, :]) % n
    er, ei = device_circle_table(cfg, n, n1, n2, inverse=False)
    assert np.array_equal(np.asarray(er), wc_re[m])
    assert np.array_equal(np.asarray(ei), wc_im[m])


def test_device_synth_pipeline_bits():
    """The device-generated epilogue table (no O(N) host array) through a
    full 256K two-pass pipeline, fwd + inverse, vs the four-step golden."""
    import intfftk.ops.pallas_fft as pf

    cfg = FFTConfig(n=1 << 18, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = pf.LargeFFTPlan(cfg, interpret=True)
    assert plan.epi_mode == "device"
    re, im = random_stimulus(cfg.n, 15, seed=5, batch=(1,))
    g = four_step_int(re, im, cfg, plan.n1, plan.n2)
    d = plan(re, im)
    assert all(np.array_equal(a, np.asarray(b, np.int64))
               for a, b in zip(g, d))
    ip = pf.LargeFFTPlan(cfg, inverse=True, interpret=True)
    assert ip.epi_mode == "device"
    gi = four_step_int(re, im, cfg, ip.n1, ip.n2, inverse=True)
    assert all(np.array_equal(a, np.asarray(b, np.int64))
               for a, b in zip(gi, ip(re, im)))


def test_device_mode_default_and_consts():
    """Default split plans source the epilogue from the device generator:
    consts carry the generated table; no host circle table is built."""
    import intfftk.ops.pallas_fft as pf

    cfg = FFTConfig(n=1 << 18, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = pf.LargeFFTPlan(cfg, interpret=True)
    assert plan.epi_mode == "device"
    wc_re, _ = circle_twiddles_int(cfg.n, 16, "auto")
    m = (np.arange(plan.n1)[:, None] * np.arange(plan.n2)[None, :]) % cfg.n
    assert np.array_equal(np.asarray(plan.consts["er"]), wc_re[m])
