"""The fused Triton engine on the CPU: kernels in interpret mode against
the golden model, the Triton lowering of every kernel shape, the block
shapes, the engine choice per platform, the compile cache, and the chip
smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from intfftk.config import FFTConfig
from intfftk.golden import fft_int, random_stimulus
from intfftk.golden.four_step import twiddle_apply_int
from intfftk.ops import pallas_fft as pf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


@pytest.mark.parametrize("n", [8, 64, 1024, 4096])
@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_bitexact(n, mode, rounding, inverse):
    """The Triton kernel (interpret mode) vs fft_int at every block
    regime: n = 8 (512 columns per block) up to n = 4096 (one)."""
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    re, im = random_stimulus(n, 15, seed=n + inverse, batch=(6,))
    g = fft_int(re, im, cfg, inverse=inverse)
    d = pf.FusedAxisFFT(cfg, inverse=inverse, interpret=True)(re, im)
    for a, b in zip(g, d):
        np.testing.assert_array_equal(a, np.asarray(b, np.int64))


@pytest.mark.parametrize("n", [8, 64, 512, 4096])
def test_block_cols_from_n(n):
    bc = pf.block_cols(n)
    assert bc >= 1 and bc & (bc - 1) == 0           # a power of two
    assert n * bc == max(pf.BLOCK_ELEMS, n)          # one block's elements


@pytest.mark.parametrize("layout", ["bn", "nb"])
@pytest.mark.parametrize("batch", [1, 5, 129])
def test_batch_padding(layout, batch):
    """Any batch: the wrapper pads to whole blocks and cuts the result."""
    cfg = FFTConfig(n=256, mode="scaled", rounding="round")
    re, im = random_stimulus(256, 15, seed=batch, batch=(batch,))
    g = fft_int(re, im, cfg)
    plan = pf.PallasFFTPlan(cfg, layout=layout, interpret=True)
    if layout == "bn":
        d = plan(re, im)
    else:
        d = tuple(v.T for v in plan(re.T, im.T))
    for a, b in zip(g, d):
        np.testing.assert_array_equal(a, np.asarray(b, np.int64))


@pytest.mark.parametrize("n1,n2", [(16, 64), (64, 16), (256, 256)])
@pytest.mark.parametrize("inverse", [False, True])
def test_epilogue_corner_turn_pass(n1, n2, inverse):
    """Pass 1 of the four-step — factor-1 stages, the W_N^(+-k1*j2)
    epilogue and the corner turn in one kernel — against the golden
    four-step's intermediate (fft_int over n1, twiddle_apply_int)."""
    cfg = FFTConfig(n=n1 * n2, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = pf.LargeFFTPlan(cfg, n1, n2, inverse=inverse, interpret=True)
    re, im = random_stimulus(cfg.n, 15, seed=n1, batch=(2,))
    a_re = re.reshape(2, n1, n2).swapaxes(-1, -2)
    a_im = im.reshape(2, n1, n2).swapaxes(-1, -2)
    cfg1 = plan._pass1.cfg
    b_re, b_im = fft_int(a_re, a_im, cfg1, inverse=inverse)
    m = np.arange(n2)[:, None] * np.arange(n1)[None, :]
    if inverse:
        m = (-m) % cfg.n
    g = twiddle_apply_int(b_re, b_im, m, cfg, cfg1.output_width)
    x = (jnp.asarray(re.reshape(2, n1, n2), jnp.int16),
         jnp.asarray(im.reshape(2, n1, n2), jnp.int16))
    d = plan._pass1.apply(plan.consts["p1"], *x,
                          epi=(plan.consts["er"], plan.consts["ei"]))
    assert d[0].shape == (2, n2, n1)
    for a, b in zip(g, d):
        np.testing.assert_array_equal(a, np.asarray(b, np.int64))


@pytest.mark.parametrize("mode,rounding", MODES)
def test_large_plan_engines_agree(mode, rounding):
    """kernel="pallas" and the plain XLA four-step give the same bits."""
    dw = 12 if mode == "unscaled" else 16
    cfg = FFTConfig(n=1 << 12, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=16)
    re, im = random_stimulus(cfg.n, dw - 1, seed=2, batch=(2,))
    a = pf.LargeFFTPlan(cfg, kernel="pallas", interpret=True)(re, im)
    b = pf.LargeFFTPlan(cfg, kernel="xla", interpret=True)(re, im)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


# -------------------------------------------------------- Triton lowering

def _lower_for_gpu(fp, *shapes):
    fp.interpret = False
    args = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    jax.jit(fp.apply).trace(fp.consts, *args).lower(
        lowering_platforms=("cuda",))


@pytest.mark.parametrize("n", [8, 1024, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_triton_lowering_axis(n, inverse):
    """Every primitive of the kernel body lowers to Triton IR (the GPU
    compile itself needs the card; this catches an unsupported op here)."""
    cfg = FFTConfig(n=n, mode="scaled", rounding="round", data_width=24,
                    twiddle_width=25)
    fp = pf._FusedPass(cfg, inverse, has_epi=False, transpose_in=True,
                       transpose_out=True, interpret=True)
    _lower_for_gpu(fp, ((1, 64, n), jnp.int32), ((1, 64, n), jnp.int32))


@pytest.mark.parametrize("order", ["natural", "bitrev"])
def test_triton_lowering_epilogue_int16(order):
    cfg = FFTConfig(n=256, mode="scaled", rounding="round")
    fp = pf._FusedPass(cfg, False, has_epi=True, transpose_out=True,
                       interpret=True, in_dtype=jnp.int16,
                       out_dtype=jnp.int16, spectrum_rows=order)
    fp.interpret = False
    s = jax.ShapeDtypeStruct
    tab = s((256, 256), jnp.int32)
    jax.jit(fp.apply).trace(
        fp.consts, s((4, 256, 256), jnp.int16), s((4, 256, 256), jnp.int16),
        (tab, tab)).lower(lowering_platforms=("cuda",))


# ------------------------------------------------------- engine selection

class _Dev:
    def __init__(self, platform):
        self.platform = platform


def test_engine_interprets_on_cpu_only():
    assert pf.resolve_interpret() is True
    assert pf.resolve_interpret(True) is True
    with pytest.raises(ValueError):
        pf.resolve_interpret(False)         # no compiled kernel on the CPU


def test_engine_never_interprets_on_gpu():
    assert pf.resolve_interpret(devices=[_Dev("gpu")]) is False
    assert pf.resolve_interpret(False, devices=[_Dev("gpu")]) is False
    with pytest.raises(ValueError):
        pf.resolve_interpret(True, devices=[_Dev("gpu")])


@pytest.mark.parametrize("platform", ["metal", "neuron"])
def test_engine_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError):
        pf.resolve_interpret(devices=[_Dev(platform)])


def test_parallel_plans_read_the_mesh():
    from conftest import cpu_mesh
    from intfftk.parallel.four_step import resolve_kernel
    cfg = FFTConfig(n=256)
    kernel, interp = resolve_kernel("auto", None, cpu_mesh((2,), ("fft",)),
                                    cfg)
    assert (kernel, interp) == ("pallas", True)
    wide = FFTConfig(n=8192)
    assert resolve_kernel("auto", None, cpu_mesh((2,), ("fft",)),
                          wide)[0] == "xla"


# ----------------------------------------------------------- compile cache

def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from intfftk.utils import compile_cache as cc
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_dir(monkeypatch):
    from intfftk.utils import compile_cache as cc
    monkeypatch.delenv(cc.ENV, raising=False)
    assert cc.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.enable_compile_cache() == cc.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ------------------------------------------------------------- chip smoke

def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and r.stdout.strip() == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
