"""The multi-device path (bench_config5) exercised on the virtual mesh:
``bench.py --all`` emits the config-5 sharded four-step whenever several
GPUs are visible.  This test keeps that path green on the 8-virtual-device
CPU mesh at a reduced n (the harness, not a performance claim)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def test_config5_virtual_mesh():
    import jax
    from bench import bench_config5

    devs = jax.devices("cpu")
    assert len(devs) == 8
    out = bench_config5(devices=devs, n=1 << 16, chain=(1, 3))
    assert out["bits_ok"] is True
    assert out["devices"] == 8 and out["n"] == 1 << 16
    assert out["platform"] == "cpu"        # recorded: not a GPU number
    assert out["msamples_per_sec"] > 0
