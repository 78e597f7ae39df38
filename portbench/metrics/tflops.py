"""End to end: the algorithm's operations of every solve completed in the
measured window, over the window's seconds (host clock)."""

UNIT = "TFLOP/s"
BETTER = "higher"
MOVES = None


def read(run):
    w = run.window
    if not w.solves:
        return None
    return run.flops * w.solves / w.seconds / 1e12
