"""Test harness configuration.

Tests run JAX on CPU with 8 virtual devices so the same shard_map /
collective code paths a multi-GPU mesh runs are exercised here (SURVEY
§4); the Pallas kernels run in interpret mode.  Must be set before jax is
imported anywhere.

Tests marked ``gpu`` need the card and skip here; ``chip_smoke.py`` runs
them on the GPU in its own process, with ``INTFFTK_TESTS_ON_GPU=1`` so
that this file leaves the platform alone.
"""

import os
import sys

ON_GPU = os.environ.get("INTFFTK_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def cpu_mesh(shape, axis_names):
    """Mesh over the virtual CPU devices (explicitly, never the default
    backend)."""
    devs = np.array(jax.devices("cpu")[: int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devs, axis_names)

from intfftk.config import FFTConfig  # noqa: E402
from intfftk.golden.stimulus import chirp_stimulus, random_stimulus  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


def make_cfg(**kw) -> FFTConfig:
    return FFTConfig(**kw)


MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]
