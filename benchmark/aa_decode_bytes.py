"""The palette decode's bytes in ``render_aa``: each u8 palette index of
the frames read once and its packed-RGBA word (4 bytes) written once."""


def nbytes(planes: int, platesize: int, lanes: int) -> int:
    """The decode of *lanes* frames of *planes* ``platesize``-square
    planes."""
    return 5 * planes * platesize * platesize * lanes
