"""The H100 benchmark of ``ogl_beamforming_tpu_torch``, driven by
``BENCHMARK.json`` at the repository's root.

``python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``).  A cell is a configuration
(``configs/<name>.json``: every ``Parameters`` field, the pipeline, the
filters, the channel mapping, the limits of the check) under a traffic mix
(``traffic/<mix>.json``, read by the generator of ``loop.py`` and the frame
pool of ``frames.py``).  Each metric is read by ``metrics/<name>.py``, each
stage's roofline counts come from ``work/<stage>.py`` and ``peaks.py``,
and ``correct`` is decided by ``check.py`` against the plain reference of
``reference/``.  Nothing here imports ``jax`` or the JAX package, and
``reference/`` imports nothing of the program.
"""
