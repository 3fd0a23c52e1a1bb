"""``device_idle_share``, read in the RAFT (large) cell (BENCHMARK.json)."""
from portbench.harness import reader

read = reader("device_idle_share")
