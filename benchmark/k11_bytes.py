"""K11's bytes: the box filter of ``render_aa``, each byte of the
``factor`` x ``factor`` supersampled packed-RGBA screen read once and each
byte of the screen it is filtered to written once."""


def nbytes(width: int, height: int, factor: int, lanes: int) -> int:
    """K11 on *lanes* screens of *width* x *height* at *factor*."""
    return (factor * factor + 1) * width * height * lanes * 4
