"""``k3_roofline``, read in the cells that report
``frame_p95_ms`` (BENCHMARK.json)."""
from portbench.harness import reader

read = reader("k3_roofline")
