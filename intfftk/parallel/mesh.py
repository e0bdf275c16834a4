"""Device-mesh helpers — the framework's distributed communication backend.

The reference is a single-die streaming engine whose only "transport" is
on-chip delay-line RAM (``/root/reference/src/vhdl/delay/int_delay_line.vhd``)
— it has no multi-device story beyond directing users at a 2D decomposition
for N > 512K.  SURVEY §2.8 maps that structural parallelism onto first-class
mesh axes here:

* ``ch``  — channel/batch data parallelism (the 2-lane superscalar analog,
            scaled to thousands of channels),
* ``fft`` — within-transform parallelism (four-step factor sharding;
            the all-to-all corner turns are collectives over whatever
            devices the axis holds, across hosts too when the mesh spans
            them via ``jax.distributed``).

The mesh follows the algorithm alone: nothing here depends on how the
devices are wired.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHANNEL_AXIS = "ch"
FFT_AXIS = "fft"


def make_mesh(shape=None, axis_names=(CHANNEL_AXIS,), devices=None) -> Mesh:
    """Build a mesh over ``devices`` (default: all default-backend devices).

    ``shape=None`` puts every device on the first axis.  For multi-host
    meshes call ``jax.distributed.initialize()`` first and pass
    ``jax.devices()`` — the collectives here are topology-agnostic.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if shape is None:
        shape = (devices.size,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names)


def single_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def channel_sharding(mesh: Mesh, ndim: int, axis: str = CHANNEL_AXIS):
    """NamedSharding splitting the leading (channel) axis of an
    [channels, ..., n] batch."""
    return NamedSharding(mesh, P(axis, *(None,) * (ndim - 1)))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
