"""Benchmark of vapor_tpu_torch: events/s of its CLI on long-read call sets.

``python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that defines the yardstick lives in this folder:
the frozen input generator (``gen/``), the plain reference that decides
``correct`` (``reference/``), the configurations (``configs/``), the
traffic mixes (``traffic/``), the metric readers (``metrics/``) and the
table of peaks (``peaks.json``).  Nothing here imports jax or the JAX
package, and only the harness imports the port.
"""
