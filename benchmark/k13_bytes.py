"""K13's bytes: the rotate pre-pass of a script globe's posed path
(``render_posed``), which turns the ray table by each pose and writes the
unit rays the script evaluates.  The float32 table ``(x, y, z)`` is read
once, each pose's ``[3, 3]`` float32 basis once, and the 12 bytes of each
pose and ray written once."""


def nbytes(rays: int, poses: int) -> int:
    """K13 over a table of *rays* rays and *poses* poses."""
    return 12 * rays + 36 * poses + 12 * rays * poses
