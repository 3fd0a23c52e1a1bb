"""One module per kind of loop.  A loop draws its calls from the cell's
pool and schedule, makes one timed call (``call``: the program's work up
to its answer on the host or synchronised on the device), and after the
window judges a sample of the answers against the reference (``check``).
Each module's ``Loop`` takes ``(system, traffic, seed, device)``."""
