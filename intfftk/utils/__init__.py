"""Utilities: reference-format stimulus IO, cost accounting, compile cache."""

from .dat_io import read_dat, write_dat
from .lanes import (bitrev_pair, bitrev_pair_indices, halves_to_interleave2,
                    interleave2_to_halves, merge_halves, split_halves)
from .roofline import KernelCost, fft_cost, roofline_fraction

__all__ = ["read_dat", "write_dat", "KernelCost", "fft_cost",
           "roofline_fraction", "bitrev_pair",
           "bitrev_pair_indices", "halves_to_interleave2",
           "interleave2_to_halves", "merge_halves", "split_halves"]
