"""``device_idle_share``, read in the cells that report
``frame_p95_ms`` (BENCHMARK.json)."""
from portbench.harness import reader

read = reader("device_idle_share")
