"""Multi-host mesh bring-up — execution across processes and hosts.

The reference has no multi-device story; SURVEY §2.8 requires the
communication backend to be a first-class component: inside a device
(the Pallas kernels), between the devices of a host (collectives in
``four_step``/``convolve``), and between hosts (the same collectives once
the mesh spans processes).  The collectives are topology-agnostic — this
module only owns process-group bring-up and host-spanning mesh
construction.

Weak-scaling expectation (BASELINE.md: >= 0.8 at 2+ hosts): the four-step
all_to_all is the only cross-host traffic; with the 'fft' axis inside a
host and the channel axis across hosts, cross-host bytes are zero for the
channelizer and O(N/hosts) per transform for the four-step.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from .mesh import CHANNEL_AXIS, FFT_AXIS


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join the jax.distributed process group (idempotent).

    Pass all three arguments (``coordinator`` as ``host:port``) unless the
    cluster environment provides them.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def pod_mesh(ch: int | None = None, fft: int | None = None) -> Mesh:
    """Global ('ch', 'fft') mesh over all devices of all hosts.

    The 'fft' axis (all_to_all corner turns) is laid out over the
    *innermost* device dimension so its collectives stay inside each
    host; the 'ch' axis (no communication) absorbs the host boundary.
    Defaults: fft = local device count, ch = host count.
    """
    devs = np.asarray(jax.devices())
    n = devs.size
    if fft is None:
        fft = jax.local_device_count()
    if ch is None:
        ch = n // fft
    if ch * fft != n:
        raise ValueError(f"ch*fft = {ch * fft} != device count {n}")
    return Mesh(devs.reshape(ch, fft), (CHANNEL_AXIS, FFT_AXIS))
