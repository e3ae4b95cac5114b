"""qbench: the benchmark of aquery2_tpu_torch on NVIDIA H100 cards.

``run.py`` runs one cell of ``BENCHMARK.json``; ``harness.py`` finds a
cell's files by name (``configs/``, ``workloads/``, ``queries/``,
``generators/``, ``reference/``, ``metrics/``), drives the program and
decides ``correct`` with ``check.py`` against the plain reference;
``ranks.py`` runs a cell of more than one chip as ranks of a mesh
session, ``harness.py``'s run on each;
``trace.py`` and ``roofline.py`` hold the per-layer arithmetic;
``control.py`` runs the reference one precision lower. Nothing here but
``harness.py``'s program side and ``ranks.py``'s load of the kernel
library imports the program, and nothing imports JAX or the JAX
package.
"""
