"""The bytes a kernel has to move, and the card's peak to set them against.

Each input byte is counted once and each output byte once, whatever the
kernel reads again; the counts are of what these inputs need, worked out
from the reference's tables, so they read the same work whatever
implements the kernel.
"""

# NVIDIA H100 SXM5 80 GB, data sheet: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12


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


def share_of_bound(nbytes_per_call: float, calls: int, seconds: float):
    """Per cent of the byte bound reached by *calls* calls that took
    *seconds* of kernel time in all; None without a record."""
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * nbytes_per_call / HBM_BYTES_PER_S / seconds
