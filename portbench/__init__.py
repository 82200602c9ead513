"""The benchmark of dampr_tpu_torch on one NVIDIA H100.

One command runs one cell once::

    python3 -m portbench.run --workload tfidf-20x --seed 7 --seconds 51 \
        --trace 0

Cells, configurations, traffic mixes and metrics are listed in the
repository's ``BENCHMARK.json`` and each lives in files of its own under
this folder, found by name (see :mod:`portbench.registry`), as does each
maker of a traffic mix's data.  Nothing here
imports ``jax`` or the JAX package, and the references under
``reference/`` import nothing of the port.
"""
