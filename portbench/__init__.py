"""The benchmark of ``optimization_tpu_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Every configuration, traffic mix and metric is a file of its own
that the harness finds by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run; its
  ``system`` names the adapter ``systems/<system>.py`` (how the program is
  driven and judged) and the plain reference ``reference/<system>.py``;
- ``traffic/<traffic>.json``: the parameters the one generator
  (``traffic.py``) reads;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)`` -> a number or
  ``None`` when it finds nothing to read.

Nothing here imports JAX or the JAX package ``optimization_tpu``.
"""
