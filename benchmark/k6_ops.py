"""K6's operations: the posed path's fused rotate, plate resolve and gather
(``render_posed``), counted as :mod:`benchmark.rooflines` states, each
product, sum, compare, division, square root and conversion once: the
kernel rounds each one on its own and issues no fused multiply-add.

For one ray of the table and one pose, on a globe whose plate is the first
largest forward dot: the rotation (9 products, 6 sums), the normalize (3
products, 2 sums, a square root, a compare, a reciprocal, 3 products),
per plate a forward dot (3 products, 2 sums) and a compare, less the first
compare, the chosen plate's right and up dots (10), u and v (a compare, 2
divisions, 2 products, 2 sums), four range compares and the texel's
truncation (2 products, 2 conversions): 86 on the six plates of the cube.
The gather reads and writes; it adds no operation.
"""


def per_ray(plates: int) -> int:
    """Operations for one ray and one pose on a globe of *plates* plates."""
    return 15 + 11 + (6 * plates - 1) + 10 + 7 + 4 + 4


def ops(rays: int, poses: int, plates: int) -> int:
    """K6 over a table of *rays* rays (the build grid's pixels) and *poses*
    poses."""
    return per_ray(plates) * rays * poses
