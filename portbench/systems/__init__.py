"""System adapters, one module per configuration's ``system``: the
program's entry points that a loop times, and the plain reference (and its
lower-precision control) that judges them.  Only here does the benchmark
call into the port."""
