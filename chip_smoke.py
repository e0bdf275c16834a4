"""Smoke run of the integer FFT on one NVIDIA GPU (or four, with --multi).

Drives the library's main path once through its public plans at the sizes
its users run, every Pallas kernel compiled through Triton (never the
interpreter), and compares every output with the golden integer model and
with the plain XLA engine: bit for bit, ``array_equal``.

    python chip_smoke.py            one GPU: every phase below, then the
                                    tests marked ``gpu``
    python chip_smoke.py --multi    four GPUs: the sharded four-step,
                                    channelizer and convolution only

Phases print one line each: name, shapes, engine, bits_ok, wall seconds
(compilation included; ``steady_ms`` is one more call of the same step —
a smoke figure, not a benchmark).  The last line is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a GPU, or with fewer than four for --multi, the script exits
non-zero before the first phase.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from intfftk.config import FFTConfig  # noqa: E402
from intfftk.golden import (fft_int, make_conv_spec,  # noqa: E402
                            overlap_save_int, random_stimulus)
from intfftk.golden.four_step import four_step_int  # noqa: E402
from intfftk.utils.compile_cache import enable_compile_cache  # noqa: E402

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def equal(golden, device):
    return all(np.array_equal(np.asarray(g, np.int64),
                              np.asarray(d, np.int64))
               for g, d in zip(golden, device))


def steady_ms(fn, *args, reps=10):
    """Mean wall ms of ``reps`` more calls after a warm one."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return 1e3 * (time.perf_counter() - t0) / reps


def engine(plan):
    """Name of the engine a plan runs; refuses interpret mode."""
    kernel = getattr(plan, "kernel", "pallas")
    interp = getattr(plan, "interpret", None)
    if interp is None and hasattr(plan, "_pass"):
        interp = plan._pass.interpret
    if interp:
        fail(f"{type(plan).__name__} would run in interpret mode")
    return "pallas-triton" if kernel == "pallas" else kernel


class Phases:
    def __init__(self):
        self.results = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            info = fn()
        except Exception as e:  # reported, then the run fails at the end
            info = {"bits_ok": False, "error": f"{type(e).__name__}: {e}"}
        info["wall_s"] = round(time.perf_counter() - t0, 2)
        line = {"phase": name, **info}
        print(json.dumps(line), flush=True)
        self.results.append(line)

    @property
    def ok(self):
        return bool(self.results) and all(r.get("bits_ok") is True
                                          for r in self.results)


# ------------------------------------------------------------ one GPU

def phase_single_pass():
    """PallasFFTPlan / FusedAxisFFT at n = 1024 and 4096: three modes,
    forward and inverse, against the golden model and the staged XLA
    core on the whole batch."""
    from intfftk.ops.pallas_fft import FusedAxisFFT, PallasFFTPlan
    from intfftk.ops.transform import FFTPlan
    ok, names, ms = True, [], {}
    for n in (1024, 4096):
        for mode, rnd in MODES:
            dw = 16 if n == 1024 or mode == "scaled" else 12
            cfg = FFTConfig(n=n, mode=mode, rounding=rnd, data_width=dw,
                            twiddle_width=16)
            re, im = random_stimulus(n, dw - 1, seed=n, batch=(512,))
            for inv in (False, True):
                axis = FusedAxisFFT(cfg, inverse=inv)
                rows = PallasFFTPlan(cfg, inverse=inv, layout="nb")
                names = [engine(axis), engine(rows)]
                ref = FFTPlan(cfg, inverse=inv)
                ya = axis(re, im)
                yr = rows(re.T, im.T)
                yx = ref(re, im)
                g = fft_int(re[:8], im[:8], cfg, inverse=inv)
                ok &= equal(g, (ya[0][:8], ya[1][:8]))
                ok &= equal(yx, ya)
                ok &= equal(yx, (yr[0].T, yr[1].T))
            ms[f"{n}_{mode}_{rnd}"] = round(steady_ms(
                jax.jit(axis.apply), axis.consts, jnp.asarray(re, jnp.int32),
                jnp.asarray(im, jnp.int32)), 3)
    return {"shapes": "[512, n] and [n, 512], n in {1024, 4096}",
            "engine": sorted(set(names)), "bits_ok": bool(ok),
            "steady_ms_inverse_axis": ms}


def phase_headline_64k():
    """The 64k scaled/round int16 headline: LargeFFTPlan at batch 64
    through apply_blocks, as bench.py times it."""
    from intfftk.ops.pallas_fft import LargeFFTPlan
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg)
    ref = LargeFFTPlan(cfg, kernel="xla")
    re, im = random_stimulus(cfg.n, 15, seed=4, batch=(64,))
    blk = (64,) + plan.block_in_shape
    xr = jnp.asarray(re.reshape(blk), jnp.int16)
    xi = jnp.asarray(im.reshape(blk), jnp.int16)
    run = jax.jit(plan.apply_blocks)
    (yr,), (yi,) = run(plan.consts, (xr,), (xi,))
    (zr,), (zi,) = jax.jit(ref.apply_blocks)(ref.consts, (xr,), (xi,))
    g = four_step_int(re[:4], im[:4], cfg, plan.n1, plan.n2)
    flat = lambda v: np.asarray(v[:4]).reshape(4, -1)
    ok = equal(g, (flat(yr), flat(yi))) and equal((zr, zi), (yr, yi))
    return {"shapes": f"[64, {plan.n1}, {plan.n2}] int16",
            "engine": engine(plan), "bits_ok": bool(ok),
            "steady_ms": round(steady_ms(run, plan.consts, (xr,), (xi,)),
                               3)}


def phase_channelizer(devices, channels=4096, n=4096):
    """Channelizer at 4096 channels x 4096 points (128 MB of int32
    re+im) on a mesh of ``devices``, both layouts, against the XLA
    engine on the whole array and the golden model on 8 channels."""
    from jax.sharding import Mesh
    from intfftk.parallel.channelizer import Channelizer
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    mesh = Mesh(np.array(devices), ("ch",))
    re, im = random_stimulus(n, 15, seed=24, batch=(channels,))
    cn = Channelizer(cfg, mesh)
    nc = Channelizer(cfg, mesh, layout="nc")
    ref = Channelizer(cfg, mesh, kernel="xla")
    xr, xi = cn.shard(re), cn.shard(im)
    y = cn(xr, xi)
    yx = ref(xr, xi)
    ynr, yni = nc(nc.shard(re.T), nc.shard(im.T))
    g = fft_int(re[:8], im[:8], cfg)
    ok = (equal(g, (y[0][:8], y[1][:8])) and equal(yx, y)
          and equal(y, (ynr.T, yni.T)))
    spread = len({s.device for s in y[0].addressable_shards})
    ok &= spread == len(devices)
    return {"shapes": f"[{channels}, {n}] int32 on {len(devices)} device(s)",
            "engine": engine(cn.plan), "bits_ok": bool(ok),
            "devices_holding_output": spread,
            "steady_ms": round(steady_ms(cn, xr, xi), 3)}, y


def phase_large_1m():
    """1M-point LargeFFTPlan at batch 4, forward and inverse."""
    from intfftk.ops.pallas_fft import LargeFFTPlan
    cfg = FFTConfig(n=1 << 20, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    re, im = random_stimulus(cfg.n, 15, seed=20, batch=(4,))
    ok, ms = True, None
    for inv in (False, True):
        plan = LargeFFTPlan(cfg, inverse=inv)
        g = four_step_int(re, im, cfg, plan.n1, plan.n2, inverse=inv)
        ok &= equal(g, plan(re, im))
        if ms is None:
            ms = steady_ms(plan, re, im)
    return {"shapes": f"[4, {cfg.n}] int16 ({plan.n1} x {plan.n2})",
            "engine": engine(plan), "bits_ok": bool(ok),
            "steady_ms_incl_host_copies": round(ms, 3)}


def phase_c2_roundtrip():
    """The c2 64k unscaled-32 raw forward -> inverse roundtrip (the wide
    data path: > 32 bits, plain XLA limb planes)."""
    import dataclasses
    from intfftk.ops.pallas_fft import LargeFFTPlan
    cfg = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                    twiddle_width=20)
    fwd = LargeFFTPlan(cfg, order="raw")
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, order="raw")
    re, im = random_stimulus(cfg.n, 28, seed=12, batch=(4,))
    yr, yi = fwd(re, im)
    xr, xi = inv(yr, yi)
    g = four_step_int(re, im, cfg, fwd.n1, fwd.n2)
    h = four_step_int(*g, icfg, inv.n1, inv.n2, inverse=True)
    ok = equal(g, (yr, yi)) and equal(h, (xr, xi))
    return {"shapes": f"[4, {cfg.n}] int32 -> {cfg.output_width}-bit",
            "engine": f"{engine(fwd)}/{engine(inv)}", "bits_ok": bool(ok)}


def conv_setup(blocks):
    spec = make_conv_spec(n=1 << 16, taps_len=(1 << 13) + 1,
                          twiddle_width=16, max_product_width=44,
                          max_spectrum_width=25)
    rng = np.random.default_rng(9)
    m = spec.taps_len
    h_re = rng.integers(-(1 << 13), 1 << 13, m)
    h_im = rng.integers(-(1 << 13), 1 << 13, m)
    t = spec.payload * blocks
    x_re = rng.integers(-(1 << 13), 1 << 13, t)
    x_im = rng.integers(-(1 << 13), 1 << 13, t)
    g = overlap_save_int(x_re, x_im, h_re, h_im, spec)
    return spec, (h_re, h_im), (x_re, x_im), g


def phase_overlap_save():
    """Overlap-save convolution at 64k FFT / 8k taps, one device."""
    from intfftk.parallel.convolve import OverlapSaveConv
    spec, h, x, g = conv_setup(4)
    conv = OverlapSaveConv(spec, *h)
    y = conv(*x)
    return {"shapes": f"T={x[0].size}, n={spec.n}, taps={spec.taps_len}",
            "engine": f"{engine(conv.fwd.plan)}/{engine(conv.inv.plan)}",
            "bits_ok": bool(equal(g, y)),
            "steady_ms_incl_host_copies": round(steady_ms(conv, *x), 3)}


def phase_stream():
    """StreamExecutor over a few tiles: bursty chunks into a 4096-point
    PallasFFTPlan, blocks out in order."""
    from intfftk.ops.pallas_fft import PallasFFTPlan
    from intfftk.runtime.stream import StreamExecutor
    cfg = FFTConfig(n=4096, mode="scaled", rounding="round")
    plan = PallasFFTPlan(cfg, layout="nb")
    re, im = random_stimulus(cfg.n, 15, seed=25, batch=(1200,))
    ex = StreamExecutor(plan, cfg.n, lane_tile=256, depth=2)
    rng = np.random.default_rng(0)
    outs, pos = [], 0
    while pos < re.shape[0]:
        c = min(int(rng.integers(1, 300)), re.shape[0] - pos)
        outs.extend(ex.feed(re[pos:pos + c].T, im[pos:pos + c].T))
        pos += c
    outs.extend(ex.flush())
    yr = np.concatenate([o[0] for o in outs], axis=1).T
    yi = np.concatenate([o[1] for o in outs], axis=1).T
    ok = equal(fft_int(re, im, cfg), (yr, yi))
    return {"shapes": f"1200 transforms of {cfg.n} in tiles of 256",
            "engine": engine(plan), "bits_ok": bool(ok),
            "dispatches": ex.stats["dispatches"]}


def phase_gpu_tests():
    """The test suite's tests marked ``gpu``, in this process."""
    import pytest
    os.environ["INTFFTK_TESTS_ON_GPU"] = "1"
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests", "test_gpu_kernels.py")])
    return {"shapes": "tests -m gpu", "engine": "pytest",
            "bits_ok": rc == 0, "pytest_rc": int(rc)}


# ----------------------------------------------------------- four GPUs

def phase_multi_four_step(devices):
    """FourStepPlan at 1M on a ('ch','fft') = (1, 4) mesh vs the golden
    model and the same plan on one device."""
    from jax.sharding import Mesh
    from intfftk.parallel.four_step import FourStepPlan
    cfg = FFTConfig(n=1 << 20, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    re, im = random_stimulus(cfg.n, 15, seed=31, batch=(4,))
    mesh = Mesh(np.array(devices).reshape(1, 4), ("ch", "fft"))
    one = Mesh(np.array(devices[:1]).reshape(1, 1), ("ch", "fft"))
    plan = FourStepPlan(cfg, 1024, 1024, mesh, batch_axis="ch")
    y = plan(re, im)
    y1 = FourStepPlan(cfg, 1024, 1024, one, batch_axis="ch")(re, im)
    g = four_step_int(re, im, cfg, 1024, 1024)
    spread = len({s.device for s in y[0].addressable_shards})
    ok = equal(g, y) and equal(y1, y) and spread == 4
    return {"shapes": f"[4, {cfg.n}] on mesh (ch, fft) = (1, 4)",
            "engine": plan.kernel, "bits_ok": bool(ok),
            "devices_holding_output": spread,
            "steady_ms": round(steady_ms(plan, re, im), 3)}


def phase_multi_channelizer(devices):
    info, y = phase_channelizer(devices)
    _, y1 = phase_channelizer(devices[:1])
    info["bits_ok"] = bool(info["bits_ok"] and equal(y1, y))
    return info


def phase_multi_conv(devices):
    """OverlapSaveConv with its ppermute halo over 4 devices vs the
    golden model and the one-device plan."""
    from jax.sharding import Mesh
    from intfftk.parallel.convolve import OverlapSaveConv
    spec, h, x, g = conv_setup(8)
    conv = OverlapSaveConv(spec, *h, mesh=Mesh(np.array(devices), ("fft",)))
    y = conv(*x)
    y1 = OverlapSaveConv(spec, *h)(*x)
    return {"shapes": f"T={x[0].size} over 4 devices, n={spec.n}, "
                      f"taps={spec.taps_len}",
            "engine": conv.kernel, "bits_ok": bool(equal(g, y)
                                                   and equal(y1, y))}


# ------------------------------------------------------------------ main

def main(argv):
    multi = "--multi" in argv
    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX found {devices[0].platform}")
    need = 4 if multi else 1
    if len(devices) < need:
        fail(f"needs {need} GPUs, found {len(devices)}")
    devices = devices[:need]
    cache = enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    print(f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
          f", compile cache {cache}", flush=True)

    ph = Phases()
    if multi:
        ph.run("four_step_1m_mesh4", lambda: phase_multi_four_step(devices))
        ph.run("channelizer_4096x4096_mesh4",
               lambda: phase_multi_channelizer(devices))
        ph.run("overlap_save_64k_8k_mesh4", lambda: phase_multi_conv(devices))
    else:
        ph.run("single_pass_1k_4k", phase_single_pass)
        ph.run("headline_64k_b64", phase_headline_64k)
        ph.run("channelizer_4096x4096",
               lambda: phase_channelizer(devices)[0])
        ph.run("large_1m_b4", phase_large_1m)
        ph.run("c2_64k_unscaled32_roundtrip", phase_c2_roundtrip)
        ph.run("overlap_save_64k_8k", phase_overlap_save)
        ph.run("stream_executor", phase_stream)
        ph.run("gpu_marked_tests", phase_gpu_tests)
    if not ph.ok:
        fail("a phase failed: " + ", ".join(
            r["phase"] for r in ph.results if r.get("bits_ok") is not True))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main(sys.argv[1:])
