"""Runnable examples of the port, the counterparts of the JAX package's
``examples/``: each runs as ``python -m
ogl_beamforming_tpu_torch.examples.<name>`` on the card (``--device cpu``
runs the plain twins) and prints what the JAX example prints.

  throughput      the reference's tests/throughput.c: a ``.zbp`` recording
                  beamformed frame after frame onto the 512 x 1024 grid
  decode_sweep    the reference's tests/decode.c: Hadamard decode at 17
                  orders
  point_scatterer a synthetic FORCES point target beamformed and saved as
                  a PNG
  live_streaming  a streaming session of an orbiting target with the
                  browser live view

Each ``main`` is split into functions that tests and ``chip_smoke.py``
call one frame or one order at a time; importing a module runs nothing.
"""
