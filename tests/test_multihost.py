"""Multi-host bring-up helpers (parallel.multihost) and the weak-scaling
harness — exercised on the virtual 8-device CPU backend (SURVEY §4: the
same code paths a real pod slice runs)."""

import numpy as np
import pytest

import jax

from conftest import cpu_mesh

from intfftk.parallel import multihost
from intfftk.parallel.mesh import CHANNEL_AXIS, FFT_AXIS


def test_pod_mesh_defaults(monkeypatch):
    devs = jax.devices("cpu")[:8]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    monkeypatch.setattr(jax, "local_device_count", lambda *a: 4)
    mesh = multihost.pod_mesh()
    # fft = local devices (ICI), ch = "hosts" (DCN boundary)
    assert dict(mesh.shape) == {CHANNEL_AXIS: 2, FFT_AXIS: 4}
    assert mesh.axis_names == (CHANNEL_AXIS, FFT_AXIS)
    # fft axis is innermost: consecutive devices share a row
    assert mesh.devices[0, 0] is devs[0] and mesh.devices[0, 3] is devs[3]
    assert mesh.devices[1, 0] is devs[4]


def test_pod_mesh_explicit(monkeypatch):
    devs = jax.devices("cpu")[:8]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    mesh = multihost.pod_mesh(ch=4, fft=2)
    assert dict(mesh.shape) == {CHANNEL_AXIS: 4, FFT_AXIS: 2}
    with pytest.raises(ValueError):
        multihost.pod_mesh(ch=3, fft=2)


def test_initialize_multihost_idempotent(monkeypatch):
    calls = {}

    def fake_init(**kw):
        calls.update(kw)
        raise RuntimeError("backend is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    multihost.initialize_multihost()          # swallowed: already up
    assert "coordinator_address" in calls

    def fake_fail(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", fake_fail)
    with pytest.raises(RuntimeError, match="unreachable"):
        multihost.initialize_multihost()


def test_pod_mesh_runs_four_step():
    """A pod_mesh-shaped 2D mesh drives the four-step + channel DP path
    end to end (value-checked against the host oracle)."""
    from intfftk.config import FFTConfig
    from intfftk.golden.four_step import four_step_int
    from intfftk.parallel import FourStepPlan

    mesh = cpu_mesh((2, 4), (CHANNEL_AXIS, FFT_AXIS))
    cfg = FFTConfig(n=1024, mode="scaled", rounding="round", data_width=12)
    plan = FourStepPlan(cfg, 32, 32, mesh, axis=FFT_AXIS,
                        batch_axis=CHANNEL_AXIS)
    rng = np.random.default_rng(0)
    xr = rng.integers(-1024, 1024, (4, cfg.n)).astype(np.int32)
    xi = rng.integers(-1024, 1024, (4, cfg.n)).astype(np.int32)
    yr, yi = plan(xr, xi)
    gr, gi = four_step_int(xr, xi, cfg, 32, 32)
    np.testing.assert_array_equal(gr, np.asarray(yr, np.int64))
    np.testing.assert_array_equal(gi, np.asarray(yi, np.int64))


def test_weak_scaling_harness():
    """bench.py's weak-scaling sweep runs on the virtual mesh and emits an
    efficiency point per device count (values are CPU-host timings — the
    harness contract, not a performance claim)."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    eff, mode = bench.bench_weak(devices=jax.devices("cpu")[:4])
    assert mode == "channel"
    assert set(eff) == {1, 2, 4}
    assert all(v > 0 for v in eff.values())


def _run_two_process(tmp_path, size: str, timeout: int = 300):
    """Launch the 2-process jax.distributed bring-up and assert both
    workers report OK.  The coordinator port comes from a bind-then-close
    probe, which is inherently racy under parallel CI (another process can
    grab it in between — ADVICE r3); the WHOLE bring-up is retried once
    on failure with a fresh port."""
    import os
    import socket
    import subprocess
    import sys as _sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "distributed_worker.py")
    # the workers set their own platform and virtual device count
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}

    def attempt(tag):
        with socket.socket() as s:       # free localhost port (racy)
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        coordinator = f"localhost:{port}"
        procs, outs = [], []
        for i in range(2):
            out = tmp_path / f"worker{tag}_{i}.txt"
            outs.append(out)
            procs.append(subprocess.Popen(
                [_sys.executable, worker, coordinator, "2", str(i),
                 str(out), size],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        errs = []
        for i, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                return f"worker {i} timed out"
            if p.returncode != 0:
                errs.append(f"worker {i} rc={p.returncode}\n"
                            f"{err.decode()[-2000:]}")
        if errs:
            return "\n".join(errs)
        for out in outs:
            if out.read_text() != "OK":
                return f"{out} != OK"
        return None

    err = attempt("a")
    if err is not None:                 # once more with a fresh port
        err = attempt("b")
    assert err is None, err


def test_two_process_distributed(tmp_path):
    """REAL jax.distributed bring-up: two OS processes, each with 4
    virtual CPU devices, joined through a localhost coordinator into one
    8-device process group; a ('ch','fft') pod mesh spans the process
    boundary and FourStepPlan's all_to_all corner turns execute across
    it.  Both workers value-check the distributed result against the
    host golden oracle (tests/distributed_worker.py)."""
    _run_two_process(tmp_path, "small")


@pytest.mark.slow
def test_two_process_distributed_1m(tmp_path):
    """BASELINE.md milestone 5 at full scale: the 1M-point four-step
    (n1 = n2 = 1024) across a REAL 2-process group, its all_to_all corner
    turns crossing the process boundary, value-checked on both workers
    against the host golden oracle — the reference's own directive for
    N beyond 512K (``int_fftNk.vhd:13``) run distributed."""
    _run_two_process(tmp_path, "1m", timeout=600)
