"""The benchmark of ``repro_torch``'s CF system on one NVIDIA H100.

``python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
traffic kind or metric is a file of its own, found by name:

  configs/<config>.json   a deployment: shapes, cut, server settings
  mixes/<traffic>.json    a traffic mix: kind, rate, shares, limits
  drivers/<kind>.py       one per traffic kind: set-up, window, check
  metrics/<metric>.py     one reader per metric, over the run's records

The yardsticks (data generator, plain reference, peaks and cost
formulas, trace reduction) live here too and import nothing of the
program.  Only the drivers call ``repro_torch``, through its public
entry points.
"""
