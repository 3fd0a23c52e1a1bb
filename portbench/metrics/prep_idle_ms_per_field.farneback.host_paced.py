"""``prep_idle_ms_per_field.farneback``, read in the cells that report
``fields_per_s.host_paced`` (BENCHMARK.json)."""
from portbench.harness import reader

read = reader("prep_idle_ms_per_field.farneback")
