"""The benchmark of ``interpret_quality_tpu_torch`` on one NVIDIA H100.

``python3 iqbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(which names the driver in ``drivers/`` that runs it), the limits of its
check in ``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The yardstick (input generators, operation and
byte counts, peaks, the plain reference in ``reference/``) lives here and
imports nothing of the JAX package; ``reference/`` imports nothing of the
port either.
"""
