"""Distributed four-step FFT over a mesh axis — within-transform parallelism.

The reference's scaling directive for N > 512K is "build a 2D scheme from
the cores" (``/root/reference/src/vhdl/fft/int_fftNk.vhd:13``,
``src/vhdl/twiddle/row_twiddle_tay.vhd:22``).  This module is that scheme as
a first-class mesh program (SURVEY §2.8 TP/SP rows):

* N = N1 x N2 factor sharding: each chip transforms its local rows with the
  exact integer cores (``ops.FFTPlan``),
* the corner turns are ``jax.lax.all_to_all`` collectives, which XLA
  hands to the interconnect (NCCL between GPUs, also across hosts once
  the mesh spans them via ``jax.distributed``),
* the inter-factor twiddle multiply W_N^(n2*k1) uses the same quantized
  full-circle table and renormalizing floor-shift as the in-core stage
  multiplies, gathered per-shard (index arithmetic in int32: n is a power
  of two, so (n2*k1) mod n == low bits of the wrapped product).

Bit-exact against the host oracle ``golden.four_step.four_step_int``
(tests/test_four_step.py) — the distributed rounding schedule IS the spec,
device and host compute identical integers.

Layouts: input natural order [..., n] sharded contiguously; output natural
order sharded contiguously (``natural_out=True``, 3 all-to-alls), or the
transposed frequency matrix D[k1, k2] row-sharded (``natural_out=False``,
2 all-to-alls — the cheaper choice when the consumer is a pointwise
frequency-domain op followed by an inverse plan, which folds the turn away).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import FFTConfig
from ..golden.twiddle import circle_twiddles_int
from ..ops.intmath import CmultPlan, cmult_exact
from ..ops.pallas_fft import MAX_ROWS, FusedAxisFFT, resolve_interpret
from ..ops.transform import FFTPlan
from .mesh import FFT_AXIS


def resolve_kernel(kernel: str, interpret, mesh: Mesh, *cfgs):
    """Resolve the local-transform engine selector shared by the parallel
    plans.  ``kernel``: "pallas" (the fused Pallas engine), "xla" (the
    staged jnp path), or "auto" (pallas whenever the factor configs fit
    the fused kernel).  ``interpret``: checked against the mesh's own
    devices — the interpreter on CPU meshes, compiled Triton on GPU
    meshes (``pallas_fft.resolve_interpret``)."""
    if kernel == "auto":
        ok = all(c.n <= MAX_ROWS and c.output_width <= 32 for c in cfgs)
        kernel = "pallas" if ok else "xla"
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"bad kernel {kernel!r}")
    interpret = resolve_interpret(interpret, list(mesh.devices.flat))
    return kernel, interpret


def local_plan(cfg: FFTConfig, inverse: bool, kernel: str, interpret: bool):
    """Local per-shard transform plan: fused Pallas or staged XLA."""
    if kernel == "pallas":
        return FusedAxisFFT(cfg, inverse=inverse, interpret=interpret)
    return FFTPlan(cfg, inverse=inverse)


class FourStepPlan:
    """Mesh-sharded four-step integer FFT of size n = n1 * n2."""

    def __init__(self, cfg: FFTConfig, n1: int, n2: int, mesh: Mesh,
                 axis: str = FFT_AXIS, inverse: bool = False,
                 natural_out: bool = True, batch_axis: str | None = None,
                 kernel: str = "auto", interpret: bool | None = None):
        """``batch_axis``: optionally shard the *leading* batch dimension
        over a second mesh axis (channel data-parallelism composed with the
        within-transform sharding — a 2D ('ch', 'fft') mesh).
        ``kernel``/``interpret``: see ``resolve_kernel``."""
        if n1 * n2 != cfg.n:
            raise ValueError(f"n1*n2 = {n1 * n2} != cfg.n = {cfg.n}")
        for f in (n1, n2):
            if f < 8 or f & (f - 1):
                raise ValueError(f"factors must be powers of two >= 8, "
                                 f"got {n1}x{n2}")
        d = mesh.shape[axis]
        if n1 % d or n2 % d:
            raise ValueError(f"both factors must divide over {d} devices")
        self.cfg, self.n1, self.n2 = cfg, n1, n2
        self.mesh, self.axis = mesh, axis
        self.inverse, self.natural_out = inverse, natural_out
        self.batch_axis = batch_axis

        cfg1 = dataclasses.replace(cfg, n=n1)
        w1 = cfg1.output_width
        cfg2 = dataclasses.replace(cfg, n=n2, data_width=w1)
        self.kernel, interpret = resolve_kernel(kernel, interpret, mesh,
                                                cfg1, cfg2)
        self.plan1 = local_plan(cfg1, inverse, self.kernel, interpret)
        self.plan2 = local_plan(cfg2, inverse, self.kernel, interpret)
        self.out_width = cfg2.output_width

        w_re, w_im = circle_twiddles_int(cfg.n, cfg.twiddle_width,
                                         cfg.twiddle_gen)
        self._cplan = CmultPlan(data_width=w1,
                                twiddle_width=cfg.twiddle_width,
                                shift=cfg.twiddle_shift, out_width=w1)
        # every device table rides the jit parameter pytree, never a
        # closure constant baked into the program
        self.consts = {"w_re": jnp.asarray(w_re, jnp.int32),
                       "w_im": jnp.asarray(w_im, jnp.int32),
                       "p1": self.plan1.consts, "p2": self.plan2.consts}
        self._jit = None

    # ---------------------------------------------------------------- local

    def _local(self, xr, xi, consts):
        """Per-shard program; xr/xi local [..., n1/D, n2]."""
        n, n1, n2 = self.cfg.n, self.n1, self.n2
        ax = self.axis
        d = self.mesh.shape[ax]
        nd = xr.ndim
        sa, ca = nd - 1, nd - 2
        a2a = partial(jax.lax.all_to_all, axis_name=ax, split_axis=sa,
                      concat_axis=ca, tiled=True)

        # corner turn 1: rows(n1)-sharded -> cols(n2)-sharded
        xr, xi = a2a(xr), a2a(xi)                     # [..., n1, n2/D]
        xr, xi = xr.swapaxes(-1, -2), xi.swapaxes(-1, -2)   # [..., n2/D, n1]

        # column FFTs (length n1) over the last axis
        br, bi = self.plan1.apply(consts["p1"], xr, xi)     # [..., n2/D, k1]

        # inter-factor twiddle W_N^(+-n2*k1); power-of-two n makes the
        # wrapped int32 product exact mod n
        me = jax.lax.axis_index(ax)
        n2_glob = me * (n2 // d) + jnp.arange(n2 // d, dtype=jnp.int32)
        k1 = jnp.arange(n1, dtype=jnp.int32)
        m = (n2_glob[:, None] * k1[None, :]) & (n - 1)
        if self.inverse:
            m = (n - m) & (n - 1)
        cr, ci = cmult_exact(self._cplan, br, bi,
                             jnp.take(consts["w_re"], m),
                             jnp.take(consts["w_im"], m))

        # corner turn 2: cols-sharded -> k1-row-sharded
        cr, ci = a2a(cr), a2a(ci)                     # [..., n2, n1/D]
        cr, ci = cr.swapaxes(-1, -2), ci.swapaxes(-1, -2)   # [..., n1/D, n2]

        # row FFTs (length n2)
        dr, di = self.plan2.apply(consts["p2"], cr, ci)     # [..., k1/D, k2]

        if not self.natural_out:
            return dr, di
        # corner turn 3: emit X[k2*n1 + k1] contiguously (rows k2)
        dr, di = a2a(dr), a2a(di)                     # [..., n1, n2/D]
        return dr.swapaxes(-1, -2), di.swapaxes(-1, -2)     # [..., n2/D, n1]

    # --------------------------------------------------------------- public

    def __call__(self, x_re, x_im):
        """x_re, x_im: [..., n] int32, natural order.  Returns natural-order
        [..., n] when ``natural_out`` else the frequency matrix
        [..., n1, n2] = D[k1, k2] (X[k2*n1+k1] = D[k1, k2])."""
        if self._jit is None:
            nb = jnp.ndim(x_re) - 1
            lead = (self.batch_axis,) + (None,) * (nb - 1) if (
                self.batch_axis and nb) else (None,) * nb
            spec_in = P(*lead, self.axis, None)
            spec_out = spec_in
            # P() is a spec-prefix for the whole consts subtree (replicated)
            # check_vma off on the pallas path: pallas_call's out_shape
            # carries no varying-mesh-axes annotation
            fn = jax.shard_map(self._local, mesh=self.mesh,
                               in_specs=(spec_in, spec_in, P()),
                               out_specs=(spec_out, spec_out),
                               check_vma=self.kernel != "pallas")

            def run(xr, xi, consts):
                shp = xr.shape[:-1]
                xr = xr.reshape(shp + (self.n1, self.n2))
                xi = xi.reshape(shp + (self.n1, self.n2))
                yr, yi = fn(xr, xi, consts)
                if self.natural_out:
                    yr = yr.reshape(shp + (self.cfg.n,))
                    yi = yi.reshape(shp + (self.cfg.n,))
                return yr, yi

            self._jit = jax.jit(run)
        return self._jit(jnp.asarray(x_re, jnp.int32),
                         jnp.asarray(x_im, jnp.int32), self.consts)
