"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix, operation or per-layer metric
sits in a file of its own that the harness finds by name:

* ``configs/<config>.json``: the deployment's sizes, its generator,
  source and assumptions;
* ``generators/<generator>.py``: triplets made on the device from the
  seed;
* ``traffic/<traffic>.json``: the mix (which operation, the pool);
* ``ops/<op>.py``: the operation a call of the window makes, the work a
  call counts for, and how its answer is brought to the host and judged;
* ``metrics/<metric>.py``: a reader of the traced run.

The yardstick (peaks, byte counts, the plain reference and the
comparison that decides ``correct``) lives here too and imports nothing
of the port.
"""
