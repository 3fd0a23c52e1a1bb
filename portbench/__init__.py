"""The benchmark of ``opticalflowcontainer_tpu_torch`` on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything a cell needs is found by name: ``configs/<config>.json``
(the system and its settings), ``traffic/<traffic>.json`` (the loop and its
parameters), ``cells/<cell>.json`` (the correctness limits and the readings
they were set from), ``metrics/<metric>.py`` (one reader per per-layer
metric).  ``reference/`` holds the plain references, ``counts/`` the
operations and bytes computed from shapes and the table of peaks.
"""
