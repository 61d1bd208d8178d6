"""The card's peaks, and a kernel's share of its bound.

Each input byte is counted once and each output byte once, whatever the
kernel reads again; the counts are of what these inputs need, worked out
from the reference's tables, so they read the same work whatever
implements the kernel.

A kernel's count of bytes or operations is a function in a module of its
own under ``benchmark/``, beside the reader that uses it, so that a cell
for a new kernel joins by new files alone; this module keeps the peaks and
the shares.  K1's and K10's byte counts below predate that rule.
"""

# NVIDIA H100 SXM5 80 GB, data sheet: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
# the same data sheet's FP32 rate outside the tensor cores, 67 TFLOPS, which
# counts a fused multiply-add as two; the operation counts here count it as
# one (K6's 86 operations a pose and pixel)
FP32_OPS_PER_S = 33.5e12


def gather_bytes(rows: int, pixels: int, lanes: int, elem: int) -> int:
    """K1, the remap's row gather with its background select: the *rows*
    distinct source rows that valid pixels name, *lanes* texels of *elem*
    bytes each; the screens; the per-pixel tables (int32 index, bool
    valid, one background texel)."""
    return pixels * (4 + 1 + elem) + (rows + pixels) * lanes * elem


def equirect_gather_bytes(pano_rows: int, texels: int, lanes: int) -> int:
    """K10, bilinear, over a texel subset (compact mode's first stage): the
    *pano_rows* distinct pano rows its taps name, 4-byte texels; the
    *texels* output rows; per texel its four taps' int32 index and float32
    weight and an int32 plate mask."""
    return (pano_rows + texels) * lanes * 4 + texels * (8 * 4 + 4)


def _share(per_call: float, peak: float, calls: int, seconds: float):
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * per_call / peak / seconds


def share_of_bound(nbytes_per_call: float, calls: int, seconds: float):
    """Per cent of the byte bound reached by *calls* calls that took
    *seconds* of kernel time in all; None without a record."""
    return _share(nbytes_per_call, HBM_BYTES_PER_S, calls, seconds)


def share_of_op_bound(ops_per_call: float, calls: int, seconds: float):
    """Per cent of the FP32 operation bound reached by *calls* calls that
    took *seconds* of kernel time in all; None without a record."""
    return _share(ops_per_call, FP32_OPS_PER_S, calls, seconds)
