"""End to end: the seconds from the process's start to the end of the
warm-up: imports, the card's context, the seeded inputs, the lowering,
the stores, the kernel library's load (or, in a fresh checkout, build) and
the warm-up solves."""

UNIT = "s"
BETTER = "lower"
MOVES = None


def read(run):
    return run.setup_s
