"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 -m cardbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line.  Everything a cell is made of is found by name:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the mix, read by ``generate.py``; its
  ``kind`` names the driver ``drivers/<kind>.py`` that builds the system
  under test from the port and drives one call of it;
* ``reference/<family>.py``: the plain reference that decides ``correct``
  (the configuration's ``family``); it imports nothing of the port;
* ``limits/<workload>.json``: each compared number's limit, with the
  readings it was set from;
* ``metrics/<metric>.py``: one reader a metric, end to end or per layer.
"""
