"""The fused kernels compiled for the GPU (marker ``gpu``).

These need the card: on a CPU they skip (the ``gpu`` fixture), and
``chip_smoke.py`` runs them on the GPU.  Their CPU counterparts are the
interpret-mode tests of test_pallas.py and test_engine.py."""

import numpy as np
import pytest

from intfftk.config import FFTConfig
from intfftk.golden import fft_int, random_stimulus
from intfftk.golden.four_step import four_step_int

pytestmark = pytest.mark.gpu


def test_engine_compiles_on_gpu(gpu):
    from intfftk.ops.pallas_fft import FusedAxisFFT, resolve_interpret
    assert resolve_interpret(devices=[gpu]) is False
    plan = FusedAxisFFT(FFTConfig(n=256))
    assert plan._pass.interpret is False
    with pytest.raises(ValueError):
        FusedAxisFFT(FFTConfig(n=256), interpret=True)


@pytest.mark.parametrize("n", [8, 256, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_compiled_kernel_matches_xla_and_golden(gpu, n, inverse):
    from intfftk.ops.pallas_fft import FusedAxisFFT
    from intfftk.ops.transform import FFTPlan
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    re, im = random_stimulus(n, 16, seed=n, batch=(300,))
    yk = FusedAxisFFT(cfg, inverse=inverse)(re, im)
    yx = FFTPlan(cfg, inverse=inverse)(re, im)
    g = fft_int(re[:4], im[:4], cfg, inverse=inverse)
    for a, b, c in zip(yk, yx, g):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a, np.int64)[:4], c)


def test_compiled_four_step_matches_golden(gpu):
    from intfftk.ops.pallas_fft import LargeFFTPlan
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    for inverse in (False, True):
        plan = LargeFFTPlan(cfg, inverse=inverse)
        assert plan.kernel == "pallas" and plan.interpret is False
        re, im = random_stimulus(cfg.n, 15, seed=3, batch=(3,))
        g = four_step_int(re, im, cfg, plan.n1, plan.n2, inverse=inverse)
        d = plan(re, im)
        for a, b in zip(g, d):
            np.testing.assert_array_equal(a, np.asarray(b, np.int64))
