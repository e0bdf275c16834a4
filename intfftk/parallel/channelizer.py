"""Channel-parallel batched FFT — the data-parallel execution model.

The reference core is 2-lane superscalar (two complex samples per clock,
``/root/reference/src/vhdl/fft/int_fftNk.vhd:91-101``); its DP story is
"instantiate more cores".  Here the same capability is a channel-sharded
batch transform over a mesh axis: thousands of independent channels, each an
N-point integer FFT, partitioned across chips with **zero** inter-chip
communication (XLA partitions the batched plan; every collective-free stage
stays local by construction).

This is BASELINE.md milestone config 3: the 4096-channel x 4k channelizer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FFTConfig
from .four_step import local_plan, resolve_kernel
from .mesh import CHANNEL_AXIS


class _RowsPlan:
    """A last-axis plan applied down the rows of [n, B] tiles."""

    def __init__(self, plan):
        self.plan, self.consts = plan, plan.consts

    def apply(self, consts, xr, xi):
        yr, yi = self.plan.apply(consts, xr.T, xi.T)
        return yr.T, yi.T


class Channelizer:
    """Channel-sharded batched integer FFT.

    Input/output: int32 [channels, ..., n] arrays sharded on the leading
    channel axis over ``mesh[axis]``.  The local transform is the fused
    Pallas kernel by default (``kernel="auto"``, see
    ``four_step.resolve_kernel``) wrapped in ``shard_map`` — every shard
    sweeps HBM twice instead of 2*log2(n) times, with zero inter-chip
    communication; ``kernel="xla"`` keeps the staged GSPMD-partitioned
    path.
    """

    def __init__(self, cfg: FFTConfig, mesh: Mesh, axis: str = CHANNEL_AXIS,
                 inverse: bool = False, kernel: str = "auto",
                 interpret: bool | None = None, layout: str = "cn"):
        """``layout``: "cn" — [channels, ..., n] arrays, transform along
        the last axis (the engine corner-turns each tile in the kernel);
        "nc" — [n, channels], transform down the rows with channels
        across: no transposes anywhere (the reference's lane picture
        itself: samples flow down the pipeline, channels ride the width,
        ``int_fftNk.vhd:91-101``).  "nc" is what ``stream()`` feeds."""
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        if layout not in ("cn", "nc"):
            raise ValueError(f"bad layout {layout!r}")
        self.layout = layout
        self.kernel, interpret = resolve_kernel(kernel, interpret, mesh, cfg)
        if layout == "nc" and self.kernel == "pallas":
            from ..ops.pallas_fft import PallasFFTPlan
            # [n, B] row-transform kernel: batch across, no transposes;
            # natural spectrum order produced in the kernel
            self.plan = PallasFFTPlan(cfg, inverse=inverse, layout="nb",
                                      interpret=interpret)
        elif layout == "nc":
            self.plan = _RowsPlan(local_plan(cfg, inverse, "xla", interpret))
        else:
            self.plan = local_plan(cfg, inverse, self.kernel, interpret)
        self._jit = None

    def sharding(self, ndim: int = 2) -> NamedSharding:
        if self.layout == "nc":
            return NamedSharding(self.mesh, P(None, self.axis))
        return NamedSharding(self.mesh, P(self.axis, *(None,) * (ndim - 1)))

    def shard(self, x):
        """Place a host array onto the mesh with channel sharding."""
        return jax.device_put(jnp.asarray(x, jnp.int32),
                              self.sharding(jnp.ndim(x)))

    def stream(self, lane_tile: int = 128, depth: int = 2):
        """A ``runtime.StreamExecutor`` feeding THIS mesh-sharded
        channelizer — BASELINE config 3's "streaming block pipeline" as
        one composition: bursty [n, c] chunks (the WRAP-protocol analog,
        ``int_fftNk.vhd:23-37``) are repacked into [n, lane_tile] tiles,
        each tile is corner-turned and dispatched through the sharded
        plan (channels split over ``mesh[axis]``), and transformed
        blocks emerge in order with ``depth`` dispatches in flight.

        ``lane_tile`` (channels per dispatch) must divide over the mesh
        axis; per-device batch is lane_tile / mesh.shape[axis]."""
        from ..runtime.stream import StreamExecutor

        d = self.mesh.shape[self.axis]
        if lane_tile % d:
            raise ValueError(f"lane_tile {lane_tile} must divide over "
                             f"{d} devices on axis {self.axis!r}")

        if self.layout == "nc":
            # executor tiles [n, B] ARE the plan's native layout: the
            # whole streamed pipeline runs transpose-free
            tile_plan = self
        else:
            def tile_plan(xr, xi):
                # executor tiles are [n, B] (channels across); the
                # sharded plan is [channels, n]
                yr, yi = self(xr.T, xi.T)
                return yr.T, yi.T

        return StreamExecutor(tile_plan, self.cfg.n, lane_tile=lane_tile,
                              depth=depth)

    def __call__(self, x_re, x_im):
        if self._jit is None:
            s = self.sharding(jnp.ndim(x_re))
            rep = NamedSharding(self.mesh, P())
            if self.layout == "nc":
                # channels across, sharded over the LAST axis; each
                # shard runs the [n, B] row transform
                spec = P(None, self.axis)
                fn = jax.shard_map(self.plan.apply, mesh=self.mesh,
                                   in_specs=(P(), spec, spec),
                                   out_specs=(spec, spec),
                                   check_vma=False)
                self._jit = jax.jit(fn, in_shardings=(rep, s, s),
                                    out_shardings=(s, s))
            elif self.kernel == "pallas":
                # pallas_call is a custom call GSPMD cannot partition;
                # shard_map runs the fused kernel per shard explicitly
                spec = P(self.axis, *(None,) * (jnp.ndim(x_re) - 1))
                fn = jax.shard_map(self.plan.apply, mesh=self.mesh,
                                   in_specs=(P(), spec, spec),
                                   out_specs=(spec, spec),
                                   check_vma=False)
                self._jit = jax.jit(fn, in_shardings=(rep, s, s),
                                    out_shardings=(s, s))
            else:
                # plan tables ride the parameter pytree, replicated
                self._jit = jax.jit(self.plan.apply,
                                    in_shardings=(rep, s, s),
                                    out_shardings=(s, s))
        return self._jit(self.plan.consts, x_re, x_im)
