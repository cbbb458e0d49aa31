"""The benchmark of ``scgrhc_torch`` on one NVIDIA H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix's parameters, naming its driver;
* ``drivers/<driver>.py``: the code that drives the program under a mix;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``limits/<cell>.json``: the limits of the numbers that decide ``correct``.

``lib/`` is the yardstick (device checks, trace reading, operation and byte
counts, peaks, comparisons) and ``reference/`` the plain PyTorch and NumPy
reference the program is held to; neither imports anything of the program.
"""
