"""The EP pool: the dispatch benchmark's task graph.

``nt`` independent lanes of ``depth`` chained CTL-only tasks (the
reference's ``tests/runtime/scheduling/ep.jdf``), the shape that the JAX
package's ``microbench.py`` drains to measure per-task dispatch.  Every
task instance of the pool is enumerable and carries one host chore, so a
pool built from it runs on the compiled-DAG executor by default.
"""

from __future__ import annotations

from typing import Callable

from .. import ptg


def ep_pool(nt: int, depth: int,
            body: Callable[[int, int], None] | None = None) -> ptg.PTGBuilder:
    """The EP pool's builder: task ``EP(d, n)`` for ``d < depth`` and
    ``n < nt``, each after ``EP(d-1, n)``.  ``body(d, n)`` runs for each
    task; with no ``body`` the tasks are empty.  Call ``.build()`` for a
    fresh taskpool."""
    p = ptg.PTGBuilder("ep", NT=nt, DEPTH=depth)
    t = p.task("EP", d=ptg.span(0, lambda g, l: g.DEPTH - 1),
               n=ptg.span(0, lambda g, l: g.NT - 1))
    f = t.flow("ctl", ptg.CTL)
    f.input(pred=("EP", "ctl", lambda g, l: {"d": l.d - 1, "n": l.n}),
            guard=lambda g, l: l.d > 0)
    f.output(succ=("EP", "ctl", lambda g, l: {"d": l.d + 1, "n": l.n}),
             guard=lambda g, l: l.d < g.DEPTH - 1)
    if body is None:
        t.body(lambda es, task, g, l: None)
    else:
        t.body(lambda es, task, g, l: body(l.d, l.n))
    return p
