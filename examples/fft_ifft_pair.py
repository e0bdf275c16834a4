"""FFT -> IFFT pair roundtrip — the analog of the reference's
``int_fft_ifft_pair`` wrapper and ``fft_double_test.vhd`` testbench.

Composes a raw (bit-reversed spectrum) unscaled forward core with a raw
scaled inverse core — NO reorder between them, the
``int_fft_ifft_pair`` trick (DIF output order == DIT input order) — and
checks the roundtrip recovers the input to within twiddle-quantization
noise.  The inverse input is widened to the forward's output width,
mirroring ``int_fft_ifft_pair.vhd:261``.  Per-core FLY knockouts
(``bypass_fly`` / USE_FLY, ``int_fftNk.vhd:259-277``) are demonstrated
through the pair plan in ``intfftk.ops.transform.fft_ifft_pair``.

Run:  python examples/fft_ifft_pair.py [n] [--cpu]
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    # run on the host CPU: the kernels then run in the Pallas interpreter
    sys.argv.remove("--cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np

from intfftk import FFTConfig
from intfftk.golden import fft_int, random_stimulus
from intfftk.ops.pallas_fft import PallasFFTPlan
from intfftk.utils.compile_cache import enable_compile_cache


def main(n: int = 1024) -> None:
    enable_compile_cache()
    cfg = FFTConfig(n=n, mode="unscaled", data_width=12, twiddle_width=16)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    print(f"pair: {cfg.data_width}-bit unscaled fwd (out "
          f"{cfg.output_width} b) -> widened scaled/round inv, raw "
          f"spectrum order, no reorder between cores")

    fwd = PallasFFTPlan(cfg, layout="bn", order="bitrev")
    inv = PallasFFTPlan(icfg, inverse=True, layout="bn", order="bitrev")

    re, im = random_stimulus(n, cfg.data_width - 1, seed=7, batch=(128,))
    yr, yi = fwd(re, im)                       # bit-reversed spectrum
    xr, xi = inv(np.asarray(yr), np.asarray(yi))   # natural time out

    err_r = np.max(np.abs(np.asarray(xr, np.int64) - re))
    err_i = np.max(np.abs(np.asarray(xi, np.int64) - im))
    print(f"roundtrip max |error|: re {err_r}, im {err_i} LSB "
          f"(twiddle-quantization floor)")
    assert max(err_r, err_i) < 8

    # the raw spectrum really is the natural spectrum, bit-reversed
    from intfftk.golden import bitrev_indices
    g_re, g_im = fft_int(re, im, cfg)
    rev = bitrev_indices(n)
    assert np.array_equal(g_re[..., rev], np.asarray(yr, np.int64))
    assert np.array_equal(g_im[..., rev], np.asarray(yi, np.int64))
    print("raw spectrum == natural golden spectrum under bit-reversal: OK")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
