"""The benchmark of ``boltzmann_machines_tpu_torch`` on NVIDIA GPUs.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Every cell, configuration, traffic mix and per-layer metric is
a file of its own under this directory, found by its name:

* ``workloads/<cell>.json``: the configuration and traffic of a cell and
  the limits of its correctness check;
* ``configs/<config>.json``: a model configuration, its source, what was
  assumed and reduced, and the ``family`` whose adapter
  (``models/<family>.py``) and plain reference (``reference/<family>.py``)
  run it;
* ``traffic/<traffic>.json``: the parameters of a traffic mix;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``work/``: the card's published peaks and the operation and byte counts.

Nothing here imports JAX or the JAX package ``boltzmann_machines_tpu``.
"""
