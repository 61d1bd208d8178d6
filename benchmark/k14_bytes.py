"""K14's bytes: a script globe's plate resolver as one kernel
(``render_posed`` on a script globe whose resolver records as a tape),
run on the unit rays K13 writes.  The 12 bytes of each pose and ray's
float32 ``(x, y, z)`` are read once and its int8 plate written once."""


def nbytes(rays: int, poses: int) -> int:
    """K14 over *rays* rays of each of *poses* poses."""
    return 13 * rays * poses
