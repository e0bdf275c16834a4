"""Benchmark harness — emits ONE JSON line with the headline metric.

Headline: complex Msamples/s at the 64k-point scaled/round int16 integer
FFT (BASELINE.md north star) on the two-pass fused Pallas pipeline, timed
on the GPU, with the timed output bit-checked against the golden model on
a sub-batch.  The card's name and power limit (``nvidia-smi``) are
printed and recorded beside every number: a card set below its maximum
power limit runs slower under load.

Timing: every number is a **marginal** time: the computation is chained
K times inside one jitted ``lax.scan`` and timed at two K values —
(T(K_hi) − T(K_lo)) / (K_hi − K_lo) cancels dispatch latency and the
final synchronization (``utils.roofline.marginal_time``).

vs_baseline: the reference publishes no absolute throughput (BASELINE.json
published = {}); its architectural rate is 2 complex samples/clock —
1000 Msamples/s at a representative 500 MHz Ultrascale+ clock, which we use
as the comparison denominator.

Usage (on a machine with a GPU; there is no CPU fallback):
  python bench.py                 headline (64k fused) + bit check
  python bench.py --all           + milestone configs 2/3/4, 512K, 1M
                                  (+ config 5 when several GPUs are visible)
  python bench.py --weak          weak-scaling sweep (batch on one GPU;
                                  channel-axis sweep on several)
  python bench.py --engines       the fused kernel vs the plain XLA engine
                                  at the headline and channelizer shapes
  python bench.py --profile DIR   wrap the headline step in a profiler trace
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_MSPS = 1000.0  # 2 samples/clk @ 500 MHz, the reference's design point


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_info() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def _devdata(shape, width=15, seed=0):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 1)
    a = jnp.asarray(rng.integers(-lim, lim, shape), jnp.int32)
    b = jnp.asarray(rng.integers(-lim, lim, shape), jnp.int32)
    return a, b


def _chain(apply_fn, consts, state, k_lo=8, k_hi=72):
    """Marginal per-pass time of state -> apply_fn(consts, state) -> state."""
    import jax
    from intfftk.utils.roofline import marginal_time

    def mk(K):
        @jax.jit
        def loop(c, s):
            def body(cur, _):
                return apply_fn(c, cur), None
            out, _ = jax.lax.scan(body, s, None, length=K)
            return jax.tree_util.tree_leaves(out)[0].reshape(-1)[0]
        return loop

    return marginal_time(mk, consts, state, k_lo=k_lo, k_hi=k_hi)


# ------------------------------------------------------------------ headline

def _large_plan(n, **kw):
    from intfftk.config import FFTConfig
    from intfftk.ops.pallas_fft import LargeFFTPlan
    cfg = FFTConfig(n=n, data_width=16, twiddle_width=16,
                    **(kw or dict(mode="scaled", rounding="round")))
    return LargeFFTPlan(cfg)


def _plan_data(plan, shape, width=15, seed=0):
    """Device stimulus in the plan's io dtype (int16 fast path)."""
    import jax.numpy as jnp
    xr, xi = _devdata(shape, width=width, seed=seed)
    if getattr(plan, "io16", False):
        xr, xi = xr.astype(jnp.int16), xi.astype(jnp.int16)
    return xr, xi


def bench_64k(batch=64, profile_dir=None):
    """Batched 64k-point scaled/round int16 FFT on the block path.
    Returns (msamples/s, marginal s/pass, plan, bits_ok).

    The scan carries [B, n1, n2] blocks (``apply_blocks``); 64k factors
    square (256 x 256), so output blocks feed back as input blocks.  The
    output of one pass over the stimulus is bit-checked against the
    four-step golden model on a 4-item sub-batch."""
    import jax
    from intfftk.golden.four_step import four_step_int

    plan = _large_plan(1 << 16, mode="scaled", rounding="round")
    assert plan.block_in_shape == plan.block_out_shape[::-1] and \
        plan.n1 == plan.n2
    xr, xi = _plan_data(plan, (batch,) + plan.block_in_shape)

    def step(consts, s):
        (yr,), (yi,) = plan.apply_blocks(consts, (s[0],), (s[1],))
        return (yr, yi)

    dt = _chain(step, plan.consts, (xr, xi))
    run = jax.jit(step)
    yr, yi = run(plan.consts, (xr, xi))
    sub = lambda v: np.asarray(v[:4], np.int64).reshape(4, -1)
    g = four_step_int(sub(xr), sub(xi), plan.cfg, plan.n1, plan.n2)
    bits_ok = (np.array_equal(g[0], sub(yr))
               and np.array_equal(g[1], sub(yi)))
    if profile_dir:
        jax.block_until_ready(run(plan.consts, (xr, xi)))
        with jax.profiler.trace(profile_dir):
            jax.block_until_ready(run(plan.consts, (xr, xi)))
        _log(f"profiler trace written to {profile_dir}")
    return batch * plan.cfg.n / dt / 1e6, dt, plan, bits_ok


def bench_64k_flat(plan, batch=64):
    """Flat-contract companion to ``bench_64k``: [B, n] in/out."""
    xr, xi = _plan_data(plan, (batch, plan.cfg.n))

    def step(consts, s):
        (yr,), (yi,) = plan.apply(consts, (s[0],), (s[1],))
        return (yr, yi)

    dt = _chain(step, plan.consts, (xr, xi), k_lo=8, k_hi=72)
    return batch * plan.cfg.n / dt / 1e6


def headline_snr(plan, seed=11):
    """(tone_snr_db, white_snr_db) of the headline 64k scaled/round
    device output vs the float FFT reference — the second half of the
    north-star metric (BASELINE.json: Msamples/s AND output SNR).

    Two stimuli: a near-full-scale TONE + noise — the reference's own
    test signal (``math/fft_single.m:93-98``), whose concentrated
    spectrum exercises the full output range (golden gives ~43 dB at
    64k/16-bit) — and WHITE noise, whose energy spreads over all n bins so
    the scaled output holds only ~log2(sqrt(n)) fewer signal bits (golden
    gives ~12 dB at 64k: an inherent property of any 1/n-scaled 16-bit
    FFT, not a defect).  Both figures are bit-exactly those of the golden
    spec."""
    from intfftk.config import snr_db

    n = plan.cfg.n
    rng = np.random.default_rng(seed)

    def run(x_re, x_im):
        yr, yi = plan(x_re[None], x_im[None])
        y = np.asarray(yr, np.int64)[0] + 1j * np.asarray(yi, np.int64)[0]
        # scaled mode divides by 2 per stage == exactly 1/n overall
        ref = np.fft.fft(x_re + 1j * x_im) / n
        return snr_db(ref, y)

    t = np.arange(n)
    a = 0.9 * ((1 << 15) - 1)
    tone = (a * np.exp(2j * np.pi * 1234 * t / n)
            + rng.normal(0, 64, n) + 1j * rng.normal(0, 64, n))
    s_tone = run(np.round(tone.real).astype(np.int64),
                 np.round(tone.imag).astype(np.int64))
    s_white = run(rng.integers(-(1 << 15), 1 << 15, n),
                  rng.integers(-(1 << 15), 1 << 15, n))
    return s_tone, s_white


def _device():
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def headline(card, profile_dir=None):
    from intfftk.ops.pallas_fft import NUM_WARPS, block_cols
    msps, dt, plan, bits_ok = bench_64k(profile_dir=profile_dir)
    flat_msps = bench_64k_flat(plan)
    snr, snr_white = headline_snr(plan)
    _log(f"64k fused: {msps:.0f} Msamples/s, {1e3*dt:.4f} ms/pass, "
         f"bits_ok={bits_ok}, SNR {snr:.1f} dB tone / {snr_white:.1f} dB "
         f"white [{card}]")
    return {
        "metric": "fft64k_int16_msamples_per_sec",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / REF_MSPS, 3),
        "bits_ok": bool(bits_ok),
        # the same pipeline through the flat [B, n] contract
        "value_flat_contract": round(flat_msps, 1),
        # tone stimulus (math/fft_single.m:93-98); white-noise figure for
        # transparency (inherently ~12 dB at 64k scaled 16-bit)
        "snr_db": round(snr, 1),
        "snr_db_white": round(snr_white, 1),
        "engine": {"kernel": plan.kernel,
                   "block_cols": [block_cols(plan.n1),
                                  block_cols(plan.n2)],
                   "num_warps": NUM_WARPS,
                   "io_dtype": "int16" if plan.io16 else "int32"},
        "card": card,
        "device": _device(),
    }


# ------------------------------------------------------- milestone configs

def bench_config2(batch=8):
    """64k unscaled int32 wide chain, the user shape: forward -> pointwise
    wide spectrum product -> inverse, raw-chained (the convolution
    composition, ``int_fft_ifft_pair.vhd:87-107`` + frequency product).

    The timed scan carries the INPUT with a 1-op dependence on the
    output (no renarrowing inside the measured pipeline); the product
    multiplies by the exact-unity spectrum 2^23 >> 23 so the roundtrip SNR
    of the identical chain is meaningful.  Returns (msamples/s through
    fwd+product+inv, SNR dB)."""
    import jax
    import jax.numpy as jnp
    from intfftk.config import FFTConfig, snr_db
    from intfftk.ops.pallas_fft import LargeFFTPlan
    from intfftk.ops.wideint import (WideCmultPlan, wide_cmult,
                                         wide_to_i64_np)

    cfg = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                    twiddle_width=20)
    fwd = LargeFFTPlan(cfg, order="raw")
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, order="raw")
    # 25-bit taps-spectrum product tier (the conv engine's width regime)
    wplan = WideCmultPlan(data_width=cfg.output_width, twiddle_width=25,
                          shift=23, out_width=cfg.output_width)
    bo = fwd.block_out_shape
    assert inv.block_in_shape == bo and inv.block_out_shape == \
        fwd.block_in_shape
    consts = {"f": fwd.consts, "i": inv.consts,
              "hr": jnp.full(bo, 1 << 23, jnp.int32),
              "hi": jnp.zeros(bo, jnp.int32)}

    def once(c, s):
        yr, yi = fwd.apply_blocks(c["f"], (s[0],), (s[1],))
        pr, pi = wide_cmult(wplan, yr, yi, c["hr"], c["hi"])
        return inv.apply_blocks(c["i"], pr, pi)

    def chain(c, s):
        zr, zi = once(c, s)
        # carry the input forward with a 1-op dependence on the output
        return (s[0] + (zr[0][:, :1, :1] & 1),
                s[1] + (zi[0][:, :1, :1] & 1))

    rng = np.random.default_rng(0)
    x_re = rng.integers(-(1 << 27), 1 << 27, (batch, cfg.n))
    x_im = rng.integers(-(1 << 27), 1 << 27, (batch, cfg.n))
    bshape = (batch,) + fwd.block_in_shape
    xr = jnp.asarray(x_re.astype(np.int32).reshape(bshape))
    xi = jnp.asarray(x_im.astype(np.int32).reshape(bshape))
    dt = _chain(chain, consts, (xr, xi), k_lo=6, k_hi=36)
    zr, zi = jax.jit(once)(consts, (xr, xi))
    y = (wide_to_i64_np(zr).reshape(batch, cfg.n)
         + 1j * wide_to_i64_np(zi).reshape(batch, cfg.n))
    snr = snr_db(x_re + 1j * x_im, y)
    # fwd + inv = 2 transforms of n samples each per batch row
    return 2 * batch * cfg.n / dt / 1e6, snr


def bench_config3(channels=4096, n=4096):
    """Channelizer: 4096-channel x 4k FFT through the Channelizer class
    (fused kernels under shard_map) on the local device mesh.

    Returns (batched msamples/s, streamed msamples/s, nc-layout
    msamples/s, stream cost decomposition): the streamed number drives
    the SAME sharded plan through the StreamExecutor composition
    (``Channelizer.stream`` — BASELINE config 3's streaming block
    pipeline), wall-clock across bursty host chunks, host repacking and
    host<->device copies included."""
    import time
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from intfftk.config import FFTConfig
    from intfftk.parallel.channelizer import Channelizer

    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    devs = np.array(jax.devices())
    mesh = Mesh(devs, ("ch",))
    ch = Channelizer(cfg, mesh)
    xr, xi = _devdata((channels, n))
    fn = jax.shard_map(ch.plan.apply, mesh=mesh,
                       in_specs=(P(), P("ch"), P("ch")),
                       out_specs=(P("ch"), P("ch")), check_vma=False)
    dt = _chain(lambda c, s: fn(c, s[0], s[1]), ch.plan.consts, (xr, xi))
    # exercise the public class path once for real
    ch(xr, xi)

    # the [n, channels] layout: transform down the rows, no transposes
    chn = Channelizer(cfg, mesh, layout="nc")
    fnn = jax.shard_map(chn.plan.apply, mesh=mesh,
                        in_specs=(P(), P(None, "ch"), P(None, "ch")),
                        out_specs=(P(None, "ch"), P(None, "ch")),
                        check_vma=False)
    xt, yt = _devdata((n, channels), seed=1)
    dt_nc = _chain(lambda c, s: fnn(c, s[0], s[1]), chn.plan.consts,
                   (xt, yt))
    _log(f"config3 nc-layout engine: {channels * n / dt_nc / 1e6:.0f} "
         f"Msamples/s")

    # streamed composition: bursty chunks -> StreamExecutor -> sharded plan
    lt = 512 if len(devs) == 1 else 128 * len(devs)
    ex = ch.stream(lane_tile=lt, depth=4)
    hr, hi = np.asarray(xr).T.copy(), np.asarray(xi).T.copy()   # [n, ch]
    rng = np.random.default_rng(3)
    # warm the dispatch path (compile) with one full tile
    for _ in ex.feed(hr[:, :ex.lane_tile], hi[:, :ex.lane_tile]):
        pass
    for _ in ex.flush():
        pass
    ex.reset_stats()
    t0 = time.perf_counter()
    pos, total = 0, hr.shape[1]
    while pos < total:
        c = min(int(rng.integers(64, 256)), total - pos)
        for _ in ex.feed(hr[:, pos:pos + c], hi[:, pos:pos + c]):
            pass
        pos += c
    for _ in ex.flush():
        pass
    dt_s = time.perf_counter() - t0
    st = ex.stats
    stream_stats = {
        "total_ms": round(1e3 * dt_s, 2),
        "repack_ms": round(1e3 * st["repack_s"], 2),
        "dispatch_enqueue_ms": round(1e3 * st["dispatch_s"], 2),
        "drain_wait_ms": round(1e3 * st["wait_s"], 2),
        "dispatches": st["dispatches"],
        "engine_device_ms_same_samples": round(1e3 * dt, 2),
    }
    return (channels * n / dt / 1e6, channels * n / dt_s / 1e6,
            channels * n / dt_nc / 1e6, stream_stats)


def bench_config4():
    """Overlap-save convolution, 64k-point block FFTs / 8k+1 taps (wide
    frequency product + wide inverse, raw-chained four-step blocks).

    Returns (msamples/s of payload throughput, SNR dB vs float ref)."""
    import jax.numpy as jnp
    from intfftk.config import snr_db
    from intfftk.golden import make_conv_spec
    from intfftk.parallel.convolve import OverlapSaveConv

    spec = make_conv_spec(n=1 << 16, taps_len=(1 << 13) + 1,
                          twiddle_width=16, max_product_width=44,
                          max_spectrum_width=25)
    rng = np.random.default_rng(1)
    m = spec.taps_len
    h = rng.integers(-(1 << 13), 1 << 13, m)
    conv = OverlapSaveConv(spec, h, np.zeros(m))
    t = spec.payload * 4
    x_re = rng.integers(-(1 << 13), 1 << 13, t)
    x_im = rng.integers(-(1 << 13), 1 << 13, t)

    def step(consts, s):
        zh = jnp.zeros(s[0].shape[:-1] + (m - 1,), jnp.int32)
        yr, yi = conv._blocks(s[0], s[1], zh, zh, consts)
        return (yr[0], yi[0])   # low planes feed the next pass (timing mix)

    xr = jnp.asarray(x_re, jnp.int32)
    xi = jnp.asarray(x_im, jnp.int32)
    dt = _chain(step, conv.consts, (xr, xi), k_lo=8, k_hi=64)
    yr, yi = conv(x_re, x_im)
    # float reference by FFT convolution (np.convolve is O(t*m) — too slow)
    size = 1 << 18
    ref = np.fft.ifft(np.fft.fft(x_re + 1j * x_im, size)
                      * np.fft.fft(h, size))[:t]
    snr = snr_db(ref / float(1 << spec.scale_log2), yr + 1j * yi)
    return t / dt / 1e6, snr


def bench_large_blocks(n, batch=8):
    """n-point scaled int16 FFT on the BLOCK contract at non-square factor
    splits: the scan alternates two plans with swapped factors (a's output
    block shape is b's input block shape) — 2 transforms per pass."""
    from intfftk.config import FFTConfig
    from intfftk.ops.pallas_fft import LargeFFTPlan

    cfg = FFTConfig(n=n, data_width=16, twiddle_width=16, mode="scaled",
                    rounding="round")
    a = LargeFFTPlan(cfg)
    b = LargeFFTPlan(cfg, a.n2, a.n1)
    assert b.block_in_shape == a.block_out_shape
    assert b.block_out_shape == a.block_in_shape
    consts = {"a": a.consts, "b": b.consts}
    xr, xi = _plan_data(a, (batch,) + a.block_in_shape)

    def step(c, s):
        (yr,), (yi,) = a.apply_blocks(c["a"], (s[0],), (s[1],))
        (zr,), (zi,) = b.apply_blocks(c["b"], (yr,), (yi,))
        return (zr, zi)

    dt = _chain(step, consts, (xr, xi), k_lo=8, k_hi=40)
    return 2 * batch * n / dt / 1e6


def bench_large(n, batch=8):
    """n-point scaled int16 FFT on the fused pipeline (flat contract)."""
    plan = _large_plan(n, mode="scaled", rounding="round")
    xr, xi = _plan_data(plan, (batch, n))

    def step(consts, s):
        (yr,), (yi,) = plan.apply(consts, (s[0],), (s[1],))
        return (yr, yi)

    dt = _chain(step, plan.consts, (xr, xi), k_lo=8, k_hi=72)
    return batch * n / dt / 1e6


def bench_config5(devices=None, n=1 << 20, chain=(4, 24)):
    """Milestone-5 shape: the large-n four-step sharded over the FULL
    device mesh ('fft' axis, all_to_all corner turns), value-checked
    against the host golden model before it is timed.

    Returns a dict: msamples/s, n, device count and platform, bits_ok."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from intfftk.config import FFTConfig
    from intfftk.golden import random_stimulus
    from intfftk.golden.four_step import four_step_int
    from intfftk.parallel.four_step import FourStepPlan

    devs = devices if devices is not None else jax.devices()
    cfg = FFTConfig(n=n, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    # square factors so the timed chain feeds output blocks back as
    # input blocks ([B, n2, n1] == [B, n1, n2])
    l2 = cfg.stages // 2
    n2, n1 = 1 << l2, n >> l2
    assert n1 == n2
    mesh = Mesh(np.array(devs), ("fft",))
    fsp = FourStepPlan(cfg, n1, n2, mesh)

    re, im = random_stimulus(n, 15, seed=31, batch=(1,))
    g = four_step_int(re, im, cfg, n1, n2)
    d = fsp(re, im)
    ok = all(np.array_equal(a, np.asarray(b, np.int64))
             for a, b in zip(g, d))

    spec = P(None, "fft", None)
    fn = jax.shard_map(fsp._local, mesh=mesh,
                       in_specs=(spec, spec, P()), out_specs=(spec, spec),
                       check_vma=fsp.kernel != "pallas")
    batch = 2
    xr, xi = _devdata((batch, n1, n2))

    def step(consts, s):
        return fn(s[0], s[1], consts)

    dt = _chain(step, fsp.consts, (xr, xi), k_lo=chain[0], k_hi=chain[1])
    return {"msamples_per_sec": round(batch * n / dt / 1e6, 1), "n": n,
            "devices": len(devs), "platform": devs[0].platform,
            "bits_ok": bool(ok), "kernel": fsp.kernel}


# ------------------------------------------------------------ engine A/B

def bench_engines():
    """Marginal ms per step of each hand-written kernel against what XLA
    makes of the plain version, end to end through the public plans, at
    the headline (64k, batch 64, apply_blocks) and channelizer (4096 x
    4096, both layouts) shapes.  Returns {cell: {engine: ms}}."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from intfftk.config import FFTConfig
    from intfftk.ops.pallas_fft import LargeFFTPlan
    from intfftk.parallel.channelizer import Channelizer

    out = {}
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    out["headline_64k_b64"] = {}
    for kernel in ("pallas", "xla"):
        plan = LargeFFTPlan(cfg, kernel=kernel)
        xr, xi = _plan_data(plan, (64,) + plan.block_in_shape)

        def step(consts, s, plan=plan):
            (yr,), (yi,) = plan.apply_blocks(consts, (s[0],), (s[1],))
            return (yr, yi)

        out["headline_64k_b64"][kernel] = 1e3 * _chain(
            step, plan.consts, (xr, xi))

    ccfg = FFTConfig(n=4096, mode="scaled", rounding="round")
    mesh = Mesh(np.array(jax.devices()[:1]), ("ch",))
    for layout, spec, shape in (("cn", P("ch"), (4096, 4096)),
                                ("nc", P(None, "ch"), (4096, 4096))):
        cell = f"channelizer_4096x4096_{layout}"
        out[cell] = {}
        for kernel in ("pallas", "xla"):
            ch = Channelizer(ccfg, mesh, kernel=kernel, layout=layout)
            fn = jax.shard_map(ch.plan.apply, mesh=mesh,
                               in_specs=(P(), spec, spec),
                               out_specs=(spec, spec), check_vma=False)
            xr, xi = _devdata(shape)
            out[cell][kernel] = 1e3 * _chain(
                lambda c, s, fn=fn: fn(c, s[0], s[1]), ch.plan.consts,
                (xr, xi), k_lo=4, k_hi=36)
    for cell, v in out.items():
        _log(f"{cell}: pallas {v['pallas']:.4f} ms, xla {v['xla']:.4f} ms "
             f"({v['xla'] / v['pallas']:.2f}x)")
    return out


# ---------------------------------------------------------------- weak scale

def bench_weak(devices=None):
    """Weak-scaling sweep.

    On several devices: channel-parallel weak scaling — per-device batch
    constant, devices 1..D; efficiency = rate(d) / (d * rate(1)).  On one
    device: batch weak scaling (dispatch amortization).  Emits a table to
    stderr and returns (efficiency dict, mode).
    """
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from intfftk.config import FFTConfig
    from intfftk.parallel.channelizer import Channelizer

    devs = devices if devices is not None else jax.devices()
    eff = {}
    mode = "channel" if len(devs) > 1 else "batch_retention"
    if len(devs) > 1:
        cfg = FFTConfig(n=1024, mode="scaled", rounding="round")
        per_dev = 512
        base = None
        for d in range(1, len(devs) + 1):
            if len(devs) % d:
                continue
            mesh = Mesh(np.array(devs[:d]), ("ch",))
            ch = Channelizer(cfg, mesh)
            xr, xi = _devdata((per_dev * d, cfg.n))
            fn = jax.shard_map(ch.plan.apply, mesh=mesh,
                               in_specs=(P(), P("ch"), P("ch")),
                               out_specs=(P("ch"), P("ch")),
                               check_vma=False)
            dt = _chain(lambda c, s: fn(c, s[0], s[1]), ch.plan.consts,
                        (xr, xi), k_lo=4, k_hi=12)
            rate = per_dev * d * cfg.n / dt / 1e6
            base = base or rate
            eff[d] = rate / (d * base)
            _log(f"weak ch-scaling d={d}: {rate:.1f} Msamples/s, "
                 f"eff {eff[d]:.2f}")
    else:
        plan = _large_plan(1 << 16, mode="scaled", rounding="round")

        def step(consts, s):
            (yr,), (yi,) = plan.apply_blocks(consts, (s[0],), (s[1],))
            return (yr, yi)

        base = None
        for b in (8, 16, 32, 64):
            xr, xi = _plan_data(plan, (b,) + plan.block_in_shape)
            k_hi = max(72, 4608 // b)
            dt = _chain(step, plan.consts, (xr, xi), k_lo=k_hi // 8,
                        k_hi=k_hi)
            rate = b * (1 << 16) / dt / 1e6
            # one saturated device has CONSTANT throughput in the batch:
            # efficiency here is throughput RETENTION vs the smallest batch
            base = base or rate
            eff[b] = rate / base
            _log(f"weak batch-scaling B={b}: {rate:.1f} Msamples/s, "
                 f"eff {eff[b]:.2f}")
    return eff, mode


# --------------------------------------------------------------------- main

def main():
    argv = sys.argv[1:]
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py measures the GPU; found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        sys.exit(2)
    from intfftk.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    card = card_info()
    _log(card)
    profile_dir = None
    if "--profile" in argv:
        profile_dir = argv[argv.index("--profile") + 1]

    if "--weak" in argv:
        eff, mode = bench_weak()
        worst = min(eff.values()) if eff else 0.0
        metric = ("weak_scaling_efficiency" if mode == "channel"
                  else "batch_retention")
        print(json.dumps({"metric": metric, "value": round(worst, 3),
                          "unit": "fraction",
                          "vs_baseline": round(worst / 0.8, 3),
                          "mode": mode,
                          "points": {str(k): round(v, 3)
                                     for k, v in eff.items()},
                          "card": card, "device": _device()}))
        return

    if "--engines" in argv:
        print(json.dumps({"metric": "engine_ms_per_step",
                          "cells": bench_engines(), "card": card,
                          "device": _device()}))
        return

    out = headline(card, profile_dir=profile_dir)
    if "--all" in argv:
        msps2, snr2 = bench_config2()
        _log(f"config2 64k unscaled-int32 wide roundtrip: {msps2:.0f} "
             f"Msamples/s, SNR {snr2:.1f} dB")
        msps3, msps3s, msps3n, st3 = bench_config3()
        _log(f"config3 channelizer 4096ch x 4k: {msps3:.0f} Msamples/s "
             f"batched, {msps3n:.0f} nc-layout, {msps3s:.0f} streamed")
        msps4, snr4 = bench_config4()
        _log(f"config4 overlap-save 64k/8k taps: {msps4:.0f} Msamples/s "
             f"payload, SNR {snr4:.1f} dB")
        m512 = bench_large(1 << 19)
        m512b = bench_large_blocks(1 << 19)
        m1m = bench_large(1 << 20, batch=4)
        m1mb = bench_large_blocks(1 << 20, batch=4)
        _log(f"512K: {m512:.0f} flat / {m512b:.0f} blocks, 1M: {m1m:.0f} "
             f"flat / {m1mb:.0f} blocks Msamples/s")
        out["configs"] = {
            "c2_64k_unscaled32_roundtrip_msps": round(msps2, 1),
            "c2_roundtrip_snr_db": round(snr2, 1),
            "c3_channelizer_msps": round(msps3, 1),
            "c3_channelizer_nc_msps": round(msps3n, 1),
            "c3_channelizer_streamed_msps": round(msps3s, 1),
            "c3_streamed_decomposition": st3,
            "c4_conv64k_8k_msps": round(msps4, 1),
            "c4_conv_snr_db": round(snr4, 1),
            "fft512k_msps": round(m512, 1),
            "fft512k_blocks_msps": round(m512b, 1),
            "fft1m_msps": round(m1m, 1),
            "fft1m_blocks_msps": round(m1mb, 1),
        }
        if len(jax.devices()) > 1:
            c5 = bench_config5()
            _log(f"config5 four-step over {c5['devices']} devices: "
                 f"{c5['msamples_per_sec']:.0f} Msamples/s, bits_ok="
                 f"{c5['bits_ok']}")
            out["configs"]["c5_sharded_four_step"] = c5
    print(json.dumps(out))
    if not out["bits_ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
