"""portbench: the benchmark of the PyTorch and CUDA port, ``repro_torch``.

``run.py`` is the entry point that ``BENCHMARK.json``'s command runs. Every
cell, configuration, traffic mix and per-layer metric is a file of its own,
found by the name that ``BENCHMARK.json`` gives it:

  * ``workloads/<cell>.json``   the cell: configuration, traffic, chips;
  * ``configs/<config>.json``   the deployment: dataset, size, ε, minPts and
                                the guarantees the answer must keep;
  * ``traffic/<traffic>.json``  the parameters of the one closed-loop
                                generator in ``harness.py``, which names
                                the op each call drives;
  * ``ops/<op>.py``             an entry of the program that a call
                                drives (``cluster``, ``rerun``);
  * ``metrics/<metric>.py``     a reader of one per-layer metric;
  * ``data/<dataset>.py``       a frozen generator of a dataset's points;
  * ``reference/<name>.py``     the plain reference the answers are held to.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference
also imports nothing of ``repro_torch``.
"""
