"""Ex08: recursive task bodies: a task re-enters the runtime with a
nested taskpool over a finer tiling of its own tiles.

Port of the JAX package's ``examples/Ex08_Recursive.py`` (the
reference's ``parsec/recursive.h`` and ``PARSEC_DEV_RECURSIVE``): each
outer GEMM(m,n,k) views its tiles as a ``SubtileCollection``, spawns an
inner GEMM pool over the sub-tiles and detaches (``HOOK_RETURN_ASYNC``);
the runtime completes it, and releases its successors, when the nested
pool drains.  On the card every sub-GEMM is a K1 launch;
``main(device="cpu")`` runs the nested pools on the device module around
the host, with the kernel's plain version.

Self-check: C within the TF32 bound ``2e-3*(|A|@|B|)+1e-2`` of the
float64 product (K1 under the ``default`` precision).
"""

from typing import Any

import numpy as np

from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_recursive_ptg
from parsec_tpu_torch.runtime import Context

N, NB, SUB = 64, 32, 8   # outer 2x2 tiles of 32, inner 4x4 sub-tiles of 8


def main(device: Any = None) -> float:
    """Run the recursive GEMM with its nested pools on ``device`` (the
    card when None); returns ``max|C - A@B|``."""
    import parsec_tpu_torch.ops.gemm  # noqa: F401 (registers "gemm")
    dev = init_cuda_devices(device=device)[0]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    A = TiledMatrix.from_dense("A", a.copy(), NB, NB)
    B = TiledMatrix.from_dense("B", b.copy(), NB, NB)
    C = TiledMatrix.from_dense("C", np.zeros((N, N), np.float32), NB, NB)

    # each outer GEMM(m,n,k) recurses into a 4x4x4 inner GEMM of 8x8
    # sub-tiles
    tp = tiled_gemm_recursive_ptg(A, B, C, SUB, SUB)
    with Context(nb_cores=2) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
    dev.sync()

    want = a.astype(np.float64) @ b
    diff = np.abs(C.to_dense() - want)
    bound = 2e-3 * (np.abs(a).astype(np.float64) @ np.abs(b)) + 1e-2
    assert (diff <= bound).all(), float((diff - bound).max())
    err = float(diff.max())
    print(f"recursive tiled GEMM on {dev.name}: max|C - A@B| = {err:.2e}")
    return err


if __name__ == "__main__":
    main()
