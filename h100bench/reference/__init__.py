"""The plain reference that decides ``correct``.

Plain PyTorch, written from the published equations of the upstream
beamformer (rnpnr/ogl_beamforming: ``shaders/demod.glsl``,
``shaders/decode.glsl``, ``shaders/das.glsl`` and the filter design of
``math.c``).  It reads a configuration file of ``h100bench/configs`` and the
raw frame the benchmark made, and works out the filter taps, the Hadamard
matrix, the voxel grid and every delay again from them.  It imports nothing
of the program under test, nothing of ``jax`` and nothing of the JAX
package, and takes nothing the program has made.

``chain.beamform`` runs a configuration's pipeline on one raw frame in
float32 with TF32 off, the precision the configurations state, or, for the
control that the comparison must fail, with every stage's input and output
rounded to bfloat16.
"""
