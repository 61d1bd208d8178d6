"""The benchmark's plain reference: the lensmap, the equirect resample and
the remap written again from their equations in plain PyTorch.

Nothing here imports ``blinky_tpu``, ``blinky_tpu_torch`` or JAX, and
nothing takes a table, a scale or a basis that the program made: every
run works them out again from the configuration and the traffic it drove.
The arithmetic follows the C engine's (``engine/NQ/fisheye.c``): lens math
in double, rays and plate frames stored as float (``vec_t``).  The
precisions are arguments, so the same code serves as the reference
(float64 and float32) and, one step down, as the control that the
benchmark's limits were set against.
"""
