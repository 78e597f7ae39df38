"""The benchmark of ``parsec_tpu_torch`` on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` and prints one JSON line::

    python3 -m portbench --workload gemm16k.lowered --seed 7 --seconds 20 --trace 0

A cell names a configuration and a traffic mix; a metric is a reader.
Each is a file of its own that the harness finds by name:

- ``configs/<config>.json``: the sizes and precision, the ``kind`` that
  builds it (``kinds/<kind>.py``) and the limits of its comparison;
- ``traffic/<traffic>.json``: the loop (warm-up solves, results kept, the
  traced sub-window's length);
- ``metrics/<metric>.py``: ``UNIT``, ``BETTER``, ``MOVES`` and
  ``read(run) -> float | None``; a reader that finds nothing returns None.

The yardstick lives here and imports nothing of the program: the peaks and
roofline arithmetic (:mod:`.roofline`), the seeded inputs (:mod:`.inputs`)
and the plain float64 reference with its lower-precision controls
(:mod:`.reference`).  From the program the harness takes only the system
under test (``lower_taskpool`` of a PTG pool, its ``step_fn`` and stores)
and the names of its kernels in the profiler's trace.
"""
