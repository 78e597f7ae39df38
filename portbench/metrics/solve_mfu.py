"""Whole solve (``LoweredTaskpool.step_fn``): the measured window's
algorithm operations over its seconds times the card's published peak at
the configuration's precision (``peak``; bf16 989, TF32 495 TFLOP/s).  It
reads the same work whatever implements it."""

from portbench.roofline import PEAK_FLOPS

UNIT = "%"
BETTER = "higher"
MOVES = "tflops"


def read(run):
    w = run.window
    if not w.solves:
        return None
    rate = run.flops * w.solves / w.seconds
    return 100.0 * rate / PEAK_FLOPS[run.cfg["peak"]]
