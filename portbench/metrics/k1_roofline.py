"""Kernels (``ops/gemm.py`` -> ``csrc/gemm.cu``, K1): the least time of
K1's work in the traced solves over K1's device time there.  K1's work is
counted from the algorithm's tasks (the kind's ``k1_work``), and its least
time is the larger of its operations at the configuration's ``peak`` and
its bytes at 3.35 TB/s; K1's time is the profiler's, summed over the
device operations named for its entry."""

from portbench.roofline import least_time

UNIT = "%"
BETTER = "higher"
MOVES = "tflops"
K1_ENTRY = "gemm_update_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    ns = sum(v for n, v in t.device_ns.items() if K1_ENTRY in n)
    if not ns or not t.solves:
        return None
    flops, nbytes = run.kind.k1_work(run.cfg)
    least, _ = least_time(flops, nbytes, run.cfg["peak"])
    return 100.0 * least * t.solves / (ns / 1e9)
