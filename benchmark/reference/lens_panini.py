"""Panini, the cylindrical stereographic lens with d = 1
(``lenses/panini.lua``), in both directions.  *m* is ``torch`` for
tensors and ``math`` for the zoom solve's scalars."""

D = 1.0
MAX_FOV = 360


def inverse(x, y, m):
    """Lens plane (x, y) -> (lat, lon) in radians."""
    d = D
    k = x * x / ((d + 1) * (d + 1))
    dscr = k * k * d * d - (k + 1) * (k * d * d - 1)
    clon = (-k * d + m.sqrt(dscr)) / (k + 1)
    s = (d + 1) / (d + clon)
    return m.atan2(y, s), m.atan2(x, s * clon)


def forward_x(lat, lon, m):
    """(lat, lon) -> the lens plane's x."""
    return (D + 1) / (D + m.cos(lon)) * m.sin(lon)
