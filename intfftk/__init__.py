"""intfftk — a bit-exact integer FFT/IFFT framework for GPUs.

A from-scratch reimplementation of the capabilities of hukenovs/intfftk
(a streaming fixed-point radix-2 FFT core generator for Xilinx FPGAs) as an
idiomatic JAX / Pallas / pjit framework:

* radix-2 DIF forward / DIT inverse transforms, N = 8 .. 512K natively and
  beyond via the four-step decomposition,
* three numeric modes: unscaled (1 bit growth/stage), scaled-truncate,
  scaled-round-half-up — bit-faithful to the reference butterflies,
* configurable data (8..32 b) and twiddle (16..25/27 b) widths,
* quarter-wave + first-order-Taylor integer twiddle synthesis,
* batched/sharded execution over device meshes: channel-parallel
  batching, distributed four-step FFT with all-to-all corner turns,
  overlap-save streaming convolution with halo exchange.
"""

from .config import FFTConfig, snr_db

__version__ = "0.1.0"

__all__ = ["FFTConfig", "snr_db", "__version__"]
