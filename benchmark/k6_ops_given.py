"""K6's operations in resolver mode 2, a script globe's posed path: the
plate of each pose and ray is given (the script's, evaluated before K6),
so the per-plate forward dots and their compares of :mod:`benchmark.k6_ops`
become the given plate's clip to the globe's plates (2 compares) and its
forward dot (3 products, 2 sums).  The rest is counted as there: the
rotation (15), the normalize (11), the right and up dots (10), u and v
(7), four range compares and the texel's truncation (4): 58 for one ray
and one pose, whatever the globe."""

PER_RAY = 15 + 11 + 2 + 5 + 10 + 7 + 4 + 4


def ops(rays: int, poses: int) -> int:
    """K6 in mode 2 over a table of *rays* rays and *poses* poses."""
    return PER_RAY * rays * poses
