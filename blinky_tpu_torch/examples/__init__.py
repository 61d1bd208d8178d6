"""The port's examples: the JAX package's ``examples/*.py`` on
blinky_tpu_torch, with the same file names and ``main()`` entry points.
Each runs on the card (``DEVICE = "cuda"``) unless asked for the CPU
(``main(outdir, device="cpu")``, or ``cpu`` as the second argument)::

    python blinky_tpu_torch/examples/pano_pan.py pano_pan_out cpu
"""
