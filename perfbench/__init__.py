"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell (a model configuration under a traffic mix)::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json`` at the
root of the checkout: the configuration ``configs/<config>.json``, the
traffic mix ``traffic/<traffic>.json``, whose ``kind`` picks the driver
``drivers/<kind>.py``, each per-layer metric's manifest
``metrics/<metric>.json``, which names its reader ``readers/<reader>.py``,
the plain reference that the configuration names, ``reference/<name>.py``,
and the limits of the comparison that decides ``correct``,
``limits/<cell>.json``.  The yardstick (peaks, FLOP and byte counts, the
Zipf sampler) and the plain reference are frozen here and read nothing of
the program.
"""
