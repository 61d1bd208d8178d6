"""Parity oracle: scalar transcriptions of the reference's build/blit loops.

The reference ships no tests (SURVEY.md §4); its own outputs are the only
oracle.  This package transcribes the relevant fisheye.c loops pixel by
pixel in slow, obviously-correct Python/NumPy float64 so the vectorized
builders and the remap kernels can be validated bit-exactly at small sizes.
"""

from blinky_tpu_torch.parity.oracle import (  # noqa: F401
    oracle_inverse_lensmap,
    oracle_remap,
)
