"""The lowering's host walk (``ptg/lowering.py``): the host seconds of the
``step_fn`` calls of the measured window, from each call to its return,
over the solves (the closed loop, where the walk is exposed)."""

UNIT = "ms"
BETTER = "lower"
MOVES = "solve_ms_p95"


def read(run):
    w = run.window
    if not w.solves:
        return None
    return 1e3 * sum(w.enqueue_s) / len(w.enqueue_s)
