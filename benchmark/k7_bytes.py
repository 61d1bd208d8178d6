"""K7's bytes: the pose-major layout of ``render_posed``'s frames, each
byte of the frames ``[P, S, S, B]`` read once and each byte of the
pose-major copy ``[B, P * S * S]`` written once."""


def nbytes(planes: int, platesize: int, lanes: int) -> int:
    """K7 on *lanes* u8 frames of *planes* ``platesize``-square planes."""
    return 2 * planes * platesize * platesize * lanes
