"""Single-path FFT walkthrough — the analog of the reference's user flow
``math/fft_single.m`` (stimulus generation + spectrum check) and the
``fft_signle_test.vhd`` testbench (all three numeric modes side by side).

Generates the reference-style stimulus (tone + noise, quantized to the
input width), writes/reads the ``di_single.dat`` file format, runs the
natural-order transform in all three numeric modes through the fused
device plan (compiled Triton on a GPU, the Pallas interpreter on the
CPU), checks every result bit-for-bit against the golden integer model,
and reports SNR vs the float FFT.

Run:  python examples/fft_single.py [n] [data_width] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    # run on the host CPU: the kernels then run in the Pallas interpreter
    sys.argv.remove("--cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

import tempfile

import numpy as np

from intfftk import FFTConfig, snr_db
from intfftk.golden import fft_int
from intfftk.ops.pallas_fft import PallasFFTPlan, resolve_interpret
from intfftk.utils.compile_cache import enable_compile_cache
from intfftk.utils.dat_io import read_dat, write_dat


def main(n: int = 1024, data_width: int = 16) -> None:
    enable_compile_cache()
    # --- stimulus: near-full-scale tone + noise, the reference's test
    # signal shape (math/fft_single.m:93-98), one bit of headroom
    rng = np.random.default_rng(42)
    t = np.arange(n)
    a = 0.45 * ((1 << (data_width - 1)) - 1)   # half-range amplitude
    bin_k = min(50, n // 4)       # derived from n: valid at any size
    sig = (a * np.exp(2j * np.pi * bin_k * t / n)
           + rng.normal(0, a / 512, n) + 1j * rng.normal(0, a / 512, n))
    x_re = np.round(sig.real).astype(np.int64)
    x_im = np.round(sig.imag).astype(np.int64)

    # --- the reference's .dat interchange format
    path = os.path.join(tempfile.gettempdir(), "di_single.dat")
    write_dat(path, x_re, x_im)
    x_re, x_im = read_dat(path)
    print(f"stimulus: n={n}, {data_width}-bit tone+noise -> {path}")

    interp = resolve_interpret()
    print(f"device plan: fused Pallas kernel "
          f"({'interpreter' if interp else 'compiled Triton'})")

    batch = np.broadcast_to(x_re, (128, n)), np.broadcast_to(x_im, (128, n))
    for mode, rounding in [("unscaled", "truncate"), ("scaled", "truncate"),
                           ("scaled", "round")]:
        cfg = FFTConfig(n=n, mode=mode, rounding=rounding,
                        data_width=data_width, twiddle_width=16)
        if cfg.output_width > 32:
            print(f"  {mode}/{rounding}: output {cfg.output_width} b > 32 "
                  f"-> golden host path only")
            g_re, g_im = fft_int(x_re, x_im, cfg)
            y = g_re + 1j * g_im
        else:
            plan = PallasFFTPlan(cfg, layout="bn")
            d_re, d_im = plan(*batch)
            g_re, g_im = fft_int(x_re, x_im, cfg)
            assert np.array_equal(g_re, np.asarray(d_re, np.int64)[0]) \
                and np.array_equal(g_im, np.asarray(d_im, np.int64)[0]), \
                "device bits != golden bits"
            y = g_re + 1j * g_im
        scale = 1.0 if mode == "unscaled" else 1.0 / n
        ref = np.fft.fft(x_re + 1j * x_im) * scale
        print(f"  {mode:8s}/{rounding:8s}: output width "
              f"{cfg.output_width:2d} b, SNR {snr_db(ref, y):5.1f} dB "
              f"vs float FFT  [device bits == golden bits]")

    peak = int(np.argmax(np.abs(y)))
    print(f"spectrum peak at bin {peak} (expected {bin_k})")
    assert peak == bin_k


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    main(n, w)
