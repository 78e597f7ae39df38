"""Ex09: run-time task discovery: a tree whose shape the data decides.

Port of the JAX package's ``examples/Ex09_DTD_Tree.py`` (the reference's
``tests/apps/haar_tree/project_dyn.jdf``): the adaptive projection of a
Gaussian onto a Haar basis.  Each PROJECT(n, l) task measures its local
approximation error and, from its body, inserts its two children while
the error is still too large: the task graph is discovered as it runs
(DTD), not enumerated by any front-end.

Self-check: the discovered tree equals the sequential oracle's.
"""

from parsec_tpu_torch.dtd import DTDTaskpool
from parsec_tpu_torch.models.irregular import (haar_project_dtd,
                                               haar_project_reference)
from parsec_tpu_torch.runtime import Context

ALPHA, THRESH = 1.0, 1e-5


def main() -> int:
    with Context(nb_cores=4) as ctx:
        tp = DTDTaskpool("haar")
        ctx.add_taskpool(tp)
        tree = haar_project_dtd(tp, ALPHA, THRESH, min_depth=4, max_depth=22)
        tp.wait(timeout=120)

    want = haar_project_reference(ALPHA, THRESH, min_depth=4, max_depth=22)
    assert set(tree) == set(want)
    depth = max(n for n, _ in tree)
    print(f"discovered {len(tree)} interior nodes, depth {depth} "
          f"(matches the sequential oracle)")
    return len(tree)


if __name__ == "__main__":
    assert main() > 100
