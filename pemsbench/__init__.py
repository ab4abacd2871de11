"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of PEMS2.

``python3 pemsbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name the manifest gives it:

* ``configs/<config>.json``: a deployment (tier, P, v, k, driver, keys),
  each key that names an argument of the system's entry passed to it;
* ``traffic/<mix>.json``: the jobs' sizes and the keys' distribution;
* ``generators/<distribution>.py``: a distribution's keys, made on the card;
* ``metrics/<metric>.py``: a reader that takes the metric from a run's record;
* ``systems/<system>.py``: the system under test and how a run drives it.

The yardstick lives here and nowhere in the program: the jobs and their
keys (:mod:`pemsbench.keys`, ``generators/``), the least-bytes arithmetic
and the table of peaks (:mod:`pemsbench.yardstick`), the plain reference and
the comparison that decides ``correct`` (:mod:`pemsbench.reference`), and
the reduction of a profiler trace (:mod:`pemsbench.trace`).  Nothing here
imports JAX or the JAX package.
"""
