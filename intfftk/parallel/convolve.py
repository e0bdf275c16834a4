"""Distributed overlap-save FFT convolution — halo-exchange parallelism.

The neighbor-exchange ("ring") communication shape of SURVEY §2.8: a long
signal is sharded into contiguous chunks over a mesh axis; every block of
n = L + M - 1 samples needs the M-1 samples preceding it, so each shard
receives its predecessor's tail via one ``jax.lax.ppermute`` hop (a
neighbor exchange) per call.  All arithmetic is the exact integer pipeline
of the host oracle ``golden.convolve.overlap_save_int`` — forward unscaled
block FFT, renormalized frequency product, scaled inverse FFT — and the
device result is bit-identical to it (tests/test_convolve.py).

Mesh-less operation (``mesh=None``) runs the same plan on one device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..golden.convolve import ConvSpec, taps_spectrum_int
from ..ops.intmath import CmultPlan, cmult_exact
from ..ops.pallas_fft import (FusedAxisFFT, LargeFFTPlan, _tmap,
                               resolve_interpret)
from ..ops.transform import FFTPlan
from ..ops.wideint import WideCmultPlan, wide_cmult, wide_from_i32
from .mesh import FFT_AXIS


class _LargeRawFFT:
    """Adapter giving ``LargeFFTPlan`` the FFTPlan.apply calling shape
    (plane tuples of [..., n] int32) in the raw spectrum order — the conv
    engine for blocks beyond the fused kernel's single-pass row budget.
    Raw chaining around a pointwise product is bit-identical to the
    natural composition (a spectrum permutation commutes with an
    elementwise multiply)."""

    def __init__(self, cfg, factors, inverse, interpret):
        n1, n2 = factors if not inverse else factors[::-1]
        self.plan = LargeFFTPlan(cfg, n1, n2, inverse=inverse,
                                 interpret=interpret, order="raw")
        self.consts = self.plan.consts
        self.n = cfg.n

    def apply_planes(self, consts, xr, xi):
        shp = xr[0].shape[:-1]
        fl = lambda p: p.reshape(-1, self.n)
        yr, yi = self.plan.apply(consts, _tmap(fl, xr), _tmap(fl, xi))
        re = lambda p: p.reshape(shp + (self.n,))
        return _tmap(re, yr), _tmap(re, yi)

    def apply(self, consts, xr, xi):
        (yr,), (yi,) = self.apply_planes(consts, (xr,), (xi,))
        return yr, yi

    def blocks_planes(self, consts, xr, xi):
        """Block-native pass: planes of [..., R, C] (R, C =
        ``plan.block_in_shape``) -> planes of [..., *block_out_shape].
        The conv chain stays in block layout from the forward through
        the frequency product into the inverse (whose swapped-factor
        block_in_shape equals this plan's block_out_shape by
        construction)."""
        shp = xr[0].shape[:-2]
        bi = self.plan.block_in_shape
        bo = self.plan.block_out_shape
        fl = lambda p: p.reshape((-1,) + bi)
        yr, yi = self.plan.apply_blocks(consts, _tmap(fl, xr),
                                        _tmap(fl, xi))
        re = lambda p: p.reshape(shp + bo)
        return _tmap(re, yr), _tmap(re, yi)


class OverlapSaveConv:
    """Streaming integer FIR convolution by overlap-save.

    taps: integer arrays (h_re, h_im) of length spec.taps_len.  The taps
    spectrum is precomputed host-side (exact integer FFT) — the analog of
    the reference precomputing twiddle ROMs at elaboration.

    Block transforms run on the fused Pallas engine: single-pass
    ``FusedAxisFFT`` for n <= 4096, the two-pass ``LargeFFTPlan`` in raw
    spectrum order when ``spec.factors`` is set (64k-block/8k-tap scale —
    BASELINE.md milestone config 4); ``kernel="xla"`` keeps the staged
    path.  All engines are bit-identical to ``golden.convolve``.

    Call with x_re, x_im of shape [..., T]; T must divide into payload
    blocks across the mesh: T % (L * n_devices) == 0 for the sharded path
    (pad host-side; ``golden.convolve`` documents the semantics).  Returns
    the first T samples of the causal linear convolution, scaled by
    2^-spec.scale_log2.
    """

    def __init__(self, spec: ConvSpec, h_re, h_im, mesh: Mesh | None = None,
                 axis: str = FFT_AXIS, kernel: str = "auto",
                 interpret: bool | None = None):
        self.spec = spec
        self.mesh, self.axis = mesh, axis
        interpret = resolve_interpret(
            interpret, None if mesh is None else list(mesh.devices.flat))
        hr, hi = taps_spectrum_int(np.asarray(h_re), np.asarray(h_im), spec)
        if kernel == "auto":
            kernel = "pallas"
        self.kernel = kernel
        #: products wider than 32 bits run on the limb-plane path (higher
        #: SNR at large n/taps: less renormalizing downshift)
        self.wide = spec.product_width > 32
        if self.wide and not (kernel == "pallas"
                              and spec.factors is not None):
            raise NotImplementedError(
                "products wider than 32 bits need the four-step pallas "
                "engine (spec.factors set, kernel='pallas')")
        if kernel == "pallas" and spec.factors is not None:
            self.fwd = _LargeRawFFT(spec.fft_cfg, spec.factors, False,
                                    interpret)
            self.inv = _LargeRawFFT(spec.ifft_cfg, spec.factors, True,
                                    interpret)
            # taps spectrum permuted once to the raw layout (host-side)
            # and stored in the forward's OUTPUT BLOCK shape: the whole
            # fwd -> product -> inv chain runs block-native (the inverse's
            # swapped-factor block_in_shape equals fwd's block_out_shape)
            perm = self.fwd.plan.raw_spectrum_order()
            bo = self.fwd.plan.block_out_shape
            hr, hi = hr[perm].reshape(bo), hi[perm].reshape(bo)
            assert self.inv.plan.block_in_shape == bo
        elif kernel == "pallas":
            self.fwd = FusedAxisFFT(spec.fft_cfg, interpret=interpret)
            self.inv = FusedAxisFFT(spec.ifft_cfg, inverse=True,
                                    interpret=interpret)
        else:
            self.fwd = FFTPlan(spec.fft_cfg)
            self.inv = FFTPlan(spec.ifft_cfg, inverse=True)
        # device tables ride the jit parameter pytree (never jit closures)
        self.consts = {"hr": jnp.asarray(hr, jnp.int32),
                       "hi": jnp.asarray(hi, jnp.int32),
                       "fwd": self.fwd.consts, "inv": self.inv.consts}
        mk = WideCmultPlan if self.wide else CmultPlan
        self._cplan = mk(data_width=spec.fft_cfg.output_width,
                         twiddle_width=spec.spectrum_width,
                         shift=spec.product_shift,
                         out_width=spec.product_width)
        self._jit = None

    # ----------------------------------------------------------- block math

    def _blocks(self, xr, xi, tail_r, tail_i, consts):
        """[..., C] chunk + [..., M-1] predecessor tail -> conv chunk
        (plane tuples out: 1-plane narrow, 2-plane wide)."""
        spec = self.spec
        n, m, lpay = spec.n, spec.taps_len, spec.payload
        c = xr.shape[-1]
        nb = c // lpay
        er = jnp.concatenate([tail_r, xr], axis=-1)
        ei = jnp.concatenate([tail_i, xi], axis=-1)

        # overlapping windows [..., nb, n]: nb static contiguous slices,
        # stacked (not an element-level gather over nb*n indices)
        def win(e):
            return jnp.stack(
                [jax.lax.slice_in_dim(e, k * lpay, k * lpay + n, axis=-1)
                 for k in range(nb)], axis=-2)

        br, bi = win(er), win(ei)
        shp = xr.shape[:-1]
        cut = lambda p: p[..., m - 1:].reshape(shp + (c,))

        if isinstance(self.fwd, _LargeRawFFT):
            # block-native chain: windows -> [.., nb, R, C] blocks ->
            # fwd -> product (tables pre-reshaped to block shape) ->
            # inv -> [.., nb, n] time blocks.  Exactly two minor-dim
            # reshapes (window split, output flatten) exist; none
            # between the kernels.
            bshape = self.fwd.plan.block_in_shape
            resh = lambda p: p.reshape(p.shape[:-1] + bshape)
            (fr,), (fi,) = self.fwd.blocks_planes(
                consts["fwd"], (resh(br),), (resh(bi),))
            if self.wide:
                pr, pi = wide_cmult(self._cplan, wide_from_i32(fr),
                                    wide_from_i32(fi),
                                    consts["hr"], consts["hi"])
            else:
                r_, i_ = cmult_exact(self._cplan, fr, fi,
                                     consts["hr"], consts["hi"])
                pr, pi = (r_,), (i_,)
            yr, yi = self.inv.blocks_planes(consts["inv"], pr, pi)
            flat = lambda p: p.reshape(p.shape[:-2] + (n,))
            return (_tmap(cut, _tmap(flat, yr)),
                    _tmap(cut, _tmap(flat, yi)))

        fr, fi = self.fwd.apply(consts["fwd"], br, bi)
        pr, pi = cmult_exact(self._cplan, fr, fi,
                             consts["hr"], consts["hi"])
        yr, yi = self.inv.apply(consts["inv"], pr, pi)
        yr, yi = (yr,), (yi,)
        return _tmap(cut, yr), _tmap(cut, yi)

    def _local_sharded(self, xr, xi, consts):
        """Per-shard program: halo from the left neighbor via ppermute."""
        m = self.spec.taps_len
        d = self.mesh.shape[self.axis]
        perm = [(i, i + 1) for i in range(d - 1)]  # device 0 receives zeros
        tr = jax.lax.ppermute(xr[..., -(m - 1):], self.axis, perm)
        ti = jax.lax.ppermute(xi[..., -(m - 1):], self.axis, perm)
        return self._blocks(xr, xi, tr, ti, consts)

    # --------------------------------------------------------------- public

    def __call__(self, x_re, x_im):
        spec = self.spec
        if self._jit is None:
            if self.mesh is None:
                def run(xr, xi, consts):
                    zh = jnp.zeros(xr.shape[:-1] + (spec.taps_len - 1,),
                                   jnp.int32)
                    return self._blocks(xr, xi, zh, zh, consts)
                self._jit = jax.jit(run)
            else:
                nb = jnp.ndim(x_re) - 1
                io = P(*(None,) * nb, self.axis)
                # P() is a spec-prefix replicating the consts subtree
                # check_vma off on the pallas engines: pallas_call's
                # out_shape carries no varying-mesh-axes annotation
                self._jit = jax.jit(jax.shard_map(
                    self._local_sharded, mesh=self.mesh,
                    in_specs=(io, io, P()), out_specs=(io, io),
                    check_vma=self.kernel != "pallas"))
        xr = jnp.asarray(x_re, jnp.int32)
        xi = jnp.asarray(x_im, jnp.int32)
        t = xr.shape[-1]
        blk = spec.payload * (self.mesh.shape[self.axis] if self.mesh else 1)
        if t % blk:
            raise ValueError(f"signal length {t} must be a multiple of "
                             f"payload*devices = {blk} (pad host-side)")
        yr, yi = self._jit(xr, xi, self.consts)
        if self.wide:
            from ..ops.wideint import wide_to_i64_np
            return wide_to_i64_np(yr), wide_to_i64_np(yi)
        return yr[0], yi[0]
