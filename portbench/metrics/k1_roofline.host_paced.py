"""``k1_roofline``, read in the cells that report
``fields_per_s.host_paced`` (BENCHMARK.json)."""
from portbench.harness import reader

read = reader("k1_roofline")
