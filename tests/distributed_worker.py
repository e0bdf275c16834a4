"""Worker process for the REAL 2-process jax.distributed test.

Each process owns 4 virtual CPU devices; the coordinator glues them into
one 8-device process group (the bring-up two hosts use — SURVEY §2.8
communication-backend row, BASELINE.md 2+ hosts line).  The
('ch', 'fft') pod mesh then spans the process boundary and a
FourStepPlan runs with its all_to_all corner turns crossing it; the
result is value-checked against the host golden oracle on every process.

Usage (spawned by tests/test_multihost.py::test_two_process_distributed):
    python distributed_worker.py <coordinator> <num_procs> <proc_id> <out> \
        [small|1m]

``1m`` runs the full BASELINE.md milestone-5 shape: a 1M-point four-step
(n1 = n2 = 1024) whose all_to_all corner turns cross the real process
boundary, value-checked against the host golden oracle (the reference's
own scaling directive beyond 512K, ``int_fftNk.vhd:13``).  It uses the
staged XLA local engine — compiled CPU code; the Pallas interpreter would
take minutes at this size without testing anything more.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(coordinator: str, num_processes: int, process_id: int,
         out_path: str, size: str = "small") -> None:
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils

    from intfftk.config import FFTConfig
    from intfftk.golden.four_step import four_step_int
    from intfftk.parallel import FourStepPlan
    from intfftk.parallel.mesh import CHANNEL_AXIS, FFT_AXIS
    from intfftk.parallel.multihost import (initialize_multihost,
                                                pod_mesh)

    initialize_multihost(coordinator=coordinator,
                         num_processes=num_processes,
                         process_id=process_id)
    assert jax.process_count() == num_processes, jax.process_count()
    assert jax.device_count() == 4 * num_processes

    # ch (no traffic) across the process/DCN boundary, fft (all_to_all)
    # within each process's devices — pod_mesh's documented layout
    mesh = pod_mesh()
    assert dict(mesh.shape)[CHANNEL_AXIS] == num_processes

    if size == "1m":
        # BASELINE.md milestone 5: 1M-point four-step, N >= 2 processes,
        # all-to-all across the group.  kernel="xla": compiled CPU code.
        cfg = FFTConfig(n=1 << 20, mode="scaled", rounding="round",
                        data_width=16, twiddle_width=16)
        n1 = n2 = 1 << 10
    else:
        cfg = FFTConfig(n=1024, mode="scaled", rounding="round",
                        data_width=12)
        n1 = n2 = 32
    plan = FourStepPlan(cfg, n1, n2, mesh, axis=FFT_AXIS,
                        batch_axis=CHANNEL_AXIS,
                        kernel="xla" if size == "1m" else "auto")

    rng = np.random.default_rng(7)   # same stimulus on every process
    batch = 2 * num_processes
    lim = 1 << (cfg.data_width - 2)
    xr = rng.integers(-lim, lim, (batch, cfg.n)).astype(np.int32)
    xi = rng.integers(-lim, lim, (batch, cfg.n)).astype(np.int32)

    # globally replicated device arrays: each process contributes every
    # shard it addresses (the plan's jit then re-shards along the specs)
    rep = NamedSharding(mesh, P())
    mk = lambda h: jax.make_array_from_callback(h.shape, rep,
                                                lambda idx: h[idx])
    yr, yi = plan(mk(xr), mk(xi))
    yr = multihost_utils.process_allgather(yr, tiled=True)
    yi = multihost_utils.process_allgather(yi, tiled=True)

    gr, gi = four_step_int(xr, xi, cfg, n1, n2)
    ok = (np.array_equal(gr, np.asarray(yr, np.int64))
          and np.array_equal(gi, np.asarray(yi, np.int64)))
    with open(out_path, "w") as f:
        f.write("OK" if ok else "MISMATCH")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5] if len(sys.argv) > 5 else "small")
