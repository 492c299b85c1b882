"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

Run one cell from the root of a checkout on a machine with an NVIDIA GPU::

    python3 -m cambench.run --workload pgm.tune-w4 --seed 7 --seconds 40 --trace 0

``BENCHMARK.json`` at the root lists the cells, metrics and bounds; every
configuration, traffic mix, per-layer metric and correctness limit is a file
of its own under this folder, found by the name the cell gives:

* ``configs/<config>.json`` — a deployment (data, geometry, budget, family);
* ``traffic/<traffic>.json`` — a traffic mix; its ``driver`` names the
  module under ``drivers/`` that runs it;
* ``metrics/<metric>.py`` — the reader of one per-layer metric;
* ``limits/<workload>.json`` — the limit of each number the correctness
  check compares, with the readings it was set from.

``frozen/`` holds copies of the program's data generators, ``reference/``
the plain reference the check compares against, ``work.py`` the operation
and byte counts of the kernels and the table of peaks.  Nothing here
imports ``jax`` or the JAX package ``repro``.
"""
