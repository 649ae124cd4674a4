"""The benchmark of ``optimization_tpu_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Every configuration, traffic mix and metric is a file of its own
that the harness finds by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run; its
  ``system`` names the adapter ``systems/<system>.py`` (how the program is
  driven and judged) and the plain reference ``reference/<system>.py``;
- ``traffic/<traffic>.json``: a mix: the keys every mix has
  (``traffic.py``) and the keys of its system's input;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)`` -> a number or
  ``None`` when it finds nothing to read.

A configuration adds its system with new files alone.  The system module
owns the input of every solve: ``draw`` makes it from the seed, stream and
index, ``check_mix`` checks the mix's keys of the input, ``System`` drives
the program, ``judge`` holds sampled answers against the reference, and
``control`` puts the reference in the program's place one precision lower
(the whole contract: ``traffic.py``'s docstring; an example:
``systems/sphere_tnt.py``).  Then a configuration file naming the system,
a mix, the entries in ``BENCHMARK.json`` and a metric reader for each new
metric make the cell; ``control.py --workload <cell> --seeds ...`` gives the
readings its limits are set from.

Nothing here imports JAX or the JAX package ``optimization_tpu``.
"""
