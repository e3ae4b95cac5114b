"""qbench: the benchmark of aquery2_tpu_torch on NVIDIA H100 cards.

``run.py`` runs one cell of ``BENCHMARK.json``; ``harness.py`` finds a
cell's files by name (``configs/``, ``workloads/``, ``queries/``,
``generators/``, ``reference/``, ``metrics/``), drives the program and
decides ``correct`` with ``check.py`` against the plain reference;
``trace.py`` and ``roofline.py`` hold the per-layer arithmetic;
``control.py`` runs the reference one precision lower. Nothing here but
``harness.py``'s program side imports the program, and nothing imports
JAX or the JAX package.
"""
