"""The device: the share of the traced sub-window of whole solves in which
no kernel, copy or set ran on the card (the union of the profiler's device
intervals, :func:`portbench.roofline.device_busy`)."""

UNIT = "%"
BETTER = "lower"
MOVES = "tflops"


def read(run):
    t = run.trace
    if t is None or not t.device_events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
