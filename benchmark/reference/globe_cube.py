"""The axis-aligned cube globe (``globes/cube.lua``): six 90-degree plates,
each ``(forward, up, fov_deg)``."""

PLATES = [
    ((0, 0, 1), (0, 1, 0), 90),  # front
    ((1, 0, 0), (0, 1, 0), 90),  # right
    ((-1, 0, 0), (0, 1, 0), 90),  # left
    ((0, 0, -1), (0, 1, 0), 90),  # back
    ((0, 1, 0), (0, 0, -1), 90),  # top
    ((0, -1, 0), (0, 0, 1), 90),  # bottom
]
