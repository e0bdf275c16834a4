"""Pallas fused-kernel path vs the golden model — bit-exact in interpreter
mode (CPU CI); the same kernels compile through Triton on the GPU
(``chip_smoke.py``, ``bench.py``)."""

import numpy as np
import pytest

from intfftk.config import FFTConfig
from intfftk.golden import fft_int, random_stimulus
from intfftk.golden.four_step import four_step_int
from intfftk.ops.pallas_fft import LargeFFTPlan, PallasFFTPlan

BATCH = 128
MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


@pytest.mark.parametrize("n", [8, 64, 1024])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_pallas_fwd_bitexact(n, mode, rounding):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    if cfg.output_width > 32:
        pytest.skip("width")
    re, im = random_stimulus(n, 16, seed=n, batch=(BATCH,))
    gr, gi = fft_int(re, im, cfg)
    dr, di = PallasFFTPlan(cfg, layout="bn", interpret=True)(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


@pytest.mark.parametrize("mode,rounding", MODES)
def test_pallas_inv_bitexact(mode, rounding):
    n = 512
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=14,
                    twiddle_width=18)
    if cfg.output_width > 32:
        pytest.skip("width")
    re, im = random_stimulus(n, 14, seed=7, batch=(BATCH,))
    gr, gi = fft_int(re, im, cfg, inverse=True)
    dr, di = PallasFFTPlan(cfg, inverse=True, layout="bn",
                           interpret=True)(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_pallas_nb_layout():
    """Native [n, B] layout, many kernel blocks."""
    cfg = FFTConfig(n=256)
    re, im = random_stimulus(256, 16, seed=3, batch=(2 * BATCH,))
    gr, gi = fft_int(re, im, cfg)
    dr, di = PallasFFTPlan(cfg, layout="nb", interpret=True)(re.T, im.T)
    np.testing.assert_array_equal(gr.T, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi.T, np.asarray(di, np.int64))


def test_pallas_wide_twiddle_limbs():
    """Config driving the multi-limb cmult tiers inside the kernel."""
    cfg = FFTConfig(n=256, mode="scaled", rounding="round", data_width=24,
                    twiddle_width=25)
    re, im = random_stimulus(256, 24, seed=4, batch=(BATCH,))
    gr, gi = fft_int(re, im, cfg)
    dr, di = PallasFFTPlan(cfg, layout="bn", interpret=True)(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_pallas_bypass_fly():
    cfg = FFTConfig(n=128, bypass_fly=True)
    re, im = random_stimulus(128, 16, seed=5, batch=(BATCH,))
    gr, gi = fft_int(re, im, cfg)
    dr, di = PallasFFTPlan(cfg, layout="bn", interpret=True)(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_pallas_guards():
    with pytest.raises(NotImplementedError):
        PallasFFTPlan(FFTConfig(n=8192))
    cfg = FFTConfig(n=64)
    plan = PallasFFTPlan(cfg, interpret=True)
    # any batch: the wrapper pads to whole blocks and cuts the result
    re, im = random_stimulus(64, 16, seed=1, batch=(100,))
    yr, yi = plan(re.T, im.T)
    gr, gi = fft_int(re, im, cfg)
    np.testing.assert_array_equal(gr.T, np.asarray(yr, np.int64))
    np.testing.assert_array_equal(gi.T, np.asarray(yi, np.int64))
    with pytest.raises(ValueError):
        plan(np.zeros((32, 128)), np.zeros((32, 128)))  # wrong n


@pytest.mark.parametrize("mode,rounding", MODES)
def test_large_fft_vs_four_step_golden(mode, rounding):
    cfg = FFTConfig(n=1 << 15, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    if mode == "unscaled":
        cfg = FFTConfig(n=1 << 15, mode=mode, rounding=rounding,
                        data_width=12, twiddle_width=16)
    plan = LargeFFTPlan(cfg, interpret=True)
    re, im = random_stimulus(cfg.n, cfg.data_width - 1, seed=6)
    gr, gi = four_step_int(re, im, cfg, plan.n1, plan.n2)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_large_fft_inverse():
    cfg = FFTConfig(n=1 << 15, mode="scaled", rounding="truncate",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, inverse=True, interpret=True)
    re, im = random_stimulus(cfg.n, 15, seed=8)
    gr, gi = four_step_int(re, im, cfg, plan.n1, plan.n2, inverse=True)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_pallas_bitrev_order_pair():
    """order='bitrev' raw cores compose into the reference pair: DIF raw
    output feeds DIT raw input with no reorder (int_fft_ifft_pair)."""
    import dataclasses
    cfg = FFTConfig(n=256, mode="unscaled", data_width=12, twiddle_width=16)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    re, im = random_stimulus(256, 11, seed=9, batch=(BATCH,))
    fwd = PallasFFTPlan(cfg, layout="bn", order="bitrev", interpret=True)
    inv = PallasFFTPlan(icfg, inverse=True, layout="bn", order="bitrev",
                        interpret=True)
    yr, yi = fwd(re, im)
    xr, xi = inv(yr, yi)
    # unscaled fwd + scaled inv = identity up to twiddle rounding
    assert np.max(np.abs(np.asarray(xr, np.int64) - re)) < 8
    assert np.max(np.abs(np.asarray(xi, np.int64) - im)) < 8
    # and bitrev order is exactly natural order permuted
    from intfftk.golden import bitrev_indices, fft_int
    gr, gi = fft_int(re, im, cfg)
    rev = bitrev_indices(256)
    np.testing.assert_array_equal(gr[..., rev], np.asarray(yr, np.int64))


def test_large_fft_raw_chaining():
    """order='raw' pair contract: a raw forward's output layout equals a
    swapped-factor raw inverse's input layout (the combined reversal index
    is an involution), so fwd -> inv with NO reorder gathers reproduces the
    natural-order golden roundtrip exactly."""
    import dataclasses
    cfg = FFTConfig(n=1 << 13, mode="unscaled", data_width=12,
                    twiddle_width=16)
    fwd = LargeFFTPlan(cfg, interpret=True, order="raw")
    w1 = cfg.output_width
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=w1)
    # swapped factors: inverse (n1', n2') = (n2, n1)
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, interpret=True,
                       order="raw")
    re, im = random_stimulus(cfg.n, 11, seed=11)
    yr, yi = fwd(re, im)
    xr, xi = inv(np.asarray(yr), np.asarray(yi))
    # golden: natural-order four-step fwd + inv composition
    gr, gi = four_step_int(re, im, cfg, fwd.n1, fwd.n2)
    hr, hi = four_step_int(gr, gi, icfg, inv.n1, inv.n2, inverse=True)
    np.testing.assert_array_equal(hr, np.asarray(xr, np.int64))
    np.testing.assert_array_equal(hi, np.asarray(xi, np.int64))
    # and the raw spectrum layout is exactly the advertised permutation
    nat = LargeFFTPlan(cfg, interpret=True)
    nr, _ = nat(re, im)
    np.testing.assert_array_equal(
        np.asarray(nr, np.int64)[fwd.raw_spectrum_order()],
        np.asarray(yr, np.int64))


def test_large_fft_wide_roundtrip():
    """Milestone-config-2 shape at CI scale: unscaled int32 forward (wide
    limb-plane kernels from stage 1) into a scaled inverse with a >32-bit
    input (the widened pair IFFT side, int_fft_ifft_pair.vhd:261), raw
    chaining, all bit-exact vs the host oracle."""
    import dataclasses
    # twiddle 20 bits: unity-gain (the reference's w=18 magnitude/shift
    # mismatch halves data per multiply stage — docs/numerics.md)
    cfg = FFTConfig(n=1 << 13, mode="unscaled", data_width=32,
                    twiddle_width=20)
    fwd = LargeFFTPlan(cfg, interpret=True, order="raw")
    assert fwd.wide1 and fwd.wide2
    w1 = cfg.output_width                    # 45 bits
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=w1)
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, interpret=True,
                       order="raw")
    assert inv.wide_in
    # amplitude backed off: spectrum peaks |X| <= sqrt2 * A * n must fit
    # the 45-bit growth container (the same wrap contract as the hardware)
    re, im = random_stimulus(cfg.n, 28, seed=12)
    yr, yi = fwd(re, im)
    gr, gi = four_step_int(re, im, cfg, fwd.n1, fwd.n2)
    np.testing.assert_array_equal(
        gr[fwd.raw_spectrum_order()], np.asarray(yr))
    xr, xi = inv(yr, yi)
    hr, hi = four_step_int(gr, gi, icfg, inv.n1, inv.n2, inverse=True)
    np.testing.assert_array_equal(hr, np.asarray(xr))
    np.testing.assert_array_equal(hi, np.asarray(xi))
    # scaled inverse of unscaled forward recovers the input up to twiddle
    # quantization noise
    from intfftk.config import snr_db
    s = snr_db(re + 1j * im, np.asarray(xr) + 1j * np.asarray(xi))
    assert s > 80, s


def test_large_fft_512k():
    """The reference's native maximum size (int_fftNk.vhd:12) on the fused
    two-pass pipeline, bit-exact vs the host oracle."""
    cfg = FFTConfig(n=1 << 19, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, interpret=True)
    assert (plan.n1, plan.n2) == (1 << 10, 1 << 9)
    re, im = random_stimulus(cfg.n, 15, seed=13)
    gr, gi = four_step_int(re, im, cfg, plan.n1, plan.n2)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_large_fft_batched():
    cfg = FFTConfig(n=1 << 14, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, interpret=True)
    re, im = random_stimulus(cfg.n, 15, seed=10, batch=(3,))
    gr, gi = four_step_int(re, im, cfg, plan.n1, plan.n2)
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_monolithic_schedule_modes():
    """schedule="monolithic" is bit-identical to the MONOLITHIC golden
    core fft_int at full size n — the single int_fftNk's per-stage
    rounding (int_dif2_fly.vhd:144-219) and full-size twiddle stream
    (rom_twiddle_int.vhd:187-202), which the four-step schedule
    deliberately does not reproduce (golden/four_step.py)."""
    for mode, rnd in MODES:
        dw = 12 if mode == "unscaled" else 14
        cfg = FFTConfig(n=1 << 10, mode=mode, rounding=rnd, data_width=dw,
                       twiddle_width=16)
        re, im = random_stimulus(cfg.n, dw - 1, seed=21, batch=(2,))
        gr, gi = fft_int(re, im, cfg)
        plan = LargeFFTPlan(cfg, interpret=True, schedule="monolithic")
        dr, di = plan(re, im)
        np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
        np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_monolithic_schedule_inverse_roundtrip():
    cfg = FFTConfig(n=1 << 10, mode="scaled", rounding="round",
                   data_width=14, twiddle_width=16)
    re, im = random_stimulus(cfg.n, 13, seed=22, batch=(2,))
    gr, gi = fft_int(re, im, cfg, inverse=True)
    plan = LargeFFTPlan(cfg, inverse=True, interpret=True,
                        schedule="monolithic")
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))
    # forward then inverse through the monolithic kernels == the golden
    # monolithic roundtrip
    fwd = LargeFFTPlan(cfg, interpret=True, schedule="monolithic")
    fr, fi = fwd(re, im)
    rr, ri = plan(np.asarray(fr), np.asarray(fi))
    hr, hi = fft_int(*fft_int(re, im, cfg), cfg, inverse=True)
    np.testing.assert_array_equal(hr, np.asarray(rr, np.int64))
    np.testing.assert_array_equal(hi, np.asarray(ri, np.int64))


def test_monolithic_schedule_taylor_8k():
    """8k monolithic: top stage order 12 >= TAYLOR_STAGE exercises the
    Taylor twiddle generation inside the 2-D stage tables."""
    cfg = FFTConfig(n=1 << 13, mode="scaled", rounding="round",
                   data_width=16, twiddle_width=16)
    re, im = random_stimulus(cfg.n, 15, seed=23)
    gr, gi = fft_int(re, im, cfg)
    plan = LargeFFTPlan(cfg, interpret=True, schedule="monolithic")
    dr, di = plan(re, im)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_monolithic_large_runs_staged_core():
    """The monolithic schedule at any size runs the staged XLA core; the
    fused engine refuses it rather than computing other bits."""
    from intfftk.ops.transform import FFTPlan
    cfg = FFTConfig(n=1 << 19, mode="scaled", rounding="round")
    plan = LargeFFTPlan(cfg, interpret=True, schedule="monolithic")
    assert plan.kernel == "xla" and isinstance(plan._mono, FFTPlan)
    with pytest.raises(NotImplementedError):
        LargeFFTPlan(cfg, interpret=True, schedule="monolithic",
                     kernel="pallas")


def test_intmath_fast_identities():
    """The op-diet closed forms are exact for every int32 edge case:
    neg_guarded's (x>>31)-x vs the reference's guarded negate
    (``int_dif2_fly.vhd:281-304``), and shift_wrap's fused bit-field
    extract vs shift-then-wrap (the DSP48 output slice)."""
    import jax.numpy as jnp
    from intfftk.ops.intmath import neg_guarded, shift_wrap, wrap_width

    edge = np.array([-2**31, -2**31 + 1, -3, -2, -1, 0, 1, 2, 3,
                     2**31 - 2, 2**31 - 1], np.int64)
    rng = np.random.default_rng(0)
    vals = np.concatenate([edge, rng.integers(-2**31, 2**31, 4096)])
    x = jnp.asarray(vals.astype(np.int32))
    ref_neg = np.where(vals >= 0, -vals, -vals - 1).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(neg_guarded(x)), ref_neg)

    for s, w in [(15, 16), (15, 17), (17, 15), (0, 16), (1, 32),
                 (23, 24), (25, 7)]:
        got = np.asarray(shift_wrap(x, s, w))
        want = np.asarray(wrap_width(x >> s, w) if s else wrap_width(x, w))
        np.testing.assert_array_equal(got, want, err_msg=f"s={s} w={w}")


def test_audit_kernel_ops():
    """The traced roofline numerator of the two-pass engine: counts drop
    when trivial stages are cheaper (the flat 12/stage hand model
    overcharged them), and the Stockham reorders are moves, not ALU."""
    from intfftk.utils.roofline import audit_kernel_ops

    cfg = FFTConfig(n=1 << 12, data_width=16, twiddle_width=16,
                    mode="scaled", rounding="round")
    alu, move = audit_kernel_ops(cfg, 64, 64)
    stages = cfg.stages
    # multiply stages ~10/sample, trivial ~5-7, epilogue ~10: the flat
    # model's 12*(stages+1) must exceed the audited count
    assert alu < 12.0 * (stages + 1)
    assert alu > 5.0 * stages
    assert move > 0
    alu_inv, _ = audit_kernel_ops(cfg, 64, 64, inverse=True)
    assert 5.0 * stages < alu_inv < 12.0 * (stages + 1)


def _adversarial(n, batch, w=16):
    """Full-scale no-headroom pattern that drives the round-mode
    difference to +2^(w-1): most-negative everywhere with max
    interspersed (the register-wrap sharp edge, docs/numerics.md)."""
    rng = np.random.default_rng(99)
    xr = np.full((batch, n), -(1 << (w - 1)), np.int64)
    xr[:, ::3] = (1 << (w - 1)) - 1
    xi = rng.integers(-(1 << (w - 1)), 1 << (w - 1), (batch, n))
    return xr, xi


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("inverse", [False, True])
def test_pallas_fullscale_register_wrap(mode, rounding, inverse):
    """Round-mode diff (a-b+1)>>1 hits +2^(w-1) on full-scale inputs and
    must wrap to -2^(w-1) exactly like the hardware's DTW-bit result
    register (int_dif2_fly.vhd:167-219) — a case random stimuli never
    hit (bug found round 4 by the adversarial probe; rounds 1-3's
    kernels elided this wrap)."""
    cfg = FFTConfig(n=256, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    if cfg.output_width > 32:
        cfg = FFTConfig(n=256, mode=mode, rounding=rounding, data_width=12,
                        twiddle_width=16)
    xr, xi = _adversarial(256, BATCH, cfg.data_width)
    gr, gi = fft_int(xr, xi, cfg, inverse=inverse)
    dr, di = PallasFFTPlan(cfg, layout="bn", interpret=True,
                           inverse=inverse)(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_large_fullscale_register_wrap():
    """Same sharp edge through the two-pass four-step pipeline."""
    cfg = FFTConfig(n=1 << 12, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, interpret=True)
    xr, xi = _adversarial(cfg.n, 2)
    gr, gi = four_step_int(xr, xi, cfg, plan.n1, plan.n2)
    dr, di = plan(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))


def test_staged_xla_fullscale_register_wrap():
    """And through the staged XLA core (narrow + wide butterflies)."""
    from intfftk.ops.transform import FFTPlan
    cfg = FFTConfig(n=256, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    xr, xi = _adversarial(256, 4)
    gr, gi = fft_int(xr, xi, cfg)
    dr, di = FFTPlan(cfg)(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))
    # wide path: 40-bit scaled/round data (limb-plane butterflies)
    from intfftk.ops.transform import WideFFTPlan
    cfgw = FFTConfig(n=64, mode="scaled", rounding="round", data_width=40,
                     twiddle_width=16)
    xrw, xiw = _adversarial(64, 4, 40)
    grw, giw = fft_int(xrw, xiw, cfgw)
    drw, diw = WideFFTPlan(cfgw)(xrw, xiw)
    np.testing.assert_array_equal(grw, np.asarray(drw, np.int64))
    np.testing.assert_array_equal(giw, np.asarray(diw, np.int64))
    # wide inverse (dit_stage_wide's diff wrap)
    giw2 = fft_int(xrw, xiw, cfgw, inverse=True)
    diw2 = WideFFTPlan(cfgw, inverse=True)(xrw, xiw)
    np.testing.assert_array_equal(giw2[0], np.asarray(diw2[0], np.int64))
    np.testing.assert_array_equal(giw2[1], np.asarray(diw2[1], np.int64))


def test_apply_blocks_contract_nonsquare():
    """apply_blocks (the streaming hot path) must agree with the flat
    apply for non-square factor splits, and the block shapes must match
    the advertised properties."""
    import jax.numpy as jnp
    cfg = FFTConfig(n=1 << 10, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, n1=16, n2=64, interpret=True)
    assert plan.block_in_shape == (16, 64)
    assert plan.block_out_shape == (64, 16)
    re, im = random_stimulus(cfg.n, 15, seed=21, batch=(2,))
    flat_r, flat_i = plan(re, im)
    dt = jnp.int16 if plan.io16 else jnp.int32
    xb = jnp.asarray(re.reshape((2,) + plan.block_in_shape), dt)
    yb = jnp.asarray(im.reshape((2,) + plan.block_in_shape), dt)
    (br_,), (bi_,) = plan.apply_blocks(plan.consts, (xb,), (yb,))
    assert br_.shape == (2,) + plan.block_out_shape
    np.testing.assert_array_equal(np.asarray(flat_r),
                                  np.asarray(br_).reshape(2, cfg.n))
    np.testing.assert_array_equal(np.asarray(flat_i),
                                  np.asarray(bi_).reshape(2, cfg.n))


def test_monolithic_fullscale_register_wrap():
    """The monolithic schedule (2-D full-size twiddle tables) hits the
    same round-mode register-wrap corner through _stage_rows_2d."""
    cfg = FFTConfig(n=1 << 13, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, interpret=True, schedule="monolithic")
    xr, xi = _adversarial(cfg.n, 2)
    gr, gi = fft_int(xr, xi, cfg)
    dr, di = plan(xr, xi)
    np.testing.assert_array_equal(gr, np.asarray(dr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(di, np.int64))
