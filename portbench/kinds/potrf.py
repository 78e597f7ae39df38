"""The tiled Cholesky factorization ``A = L·Lᵀ`` (``tiled_cholesky_ptg``)
over the lower symmetric distribution, lowered as a wavefront.

Configuration keys: ``N``, ``nb``, ``dtype`` (the tiles' storage),
``gemm_precision`` (the program's knob for its tile products), ``peak``
(the rate K1 runs at) and ``limits``.
"""

from __future__ import annotations

import time

import torch

from .. import inputs, reference
from ..problem import DTYPES, Problem, lowered_plan


def task_counts(nt: int) -> dict[str, int]:
    """Tasks of each class over ``nt x nt`` tiles."""
    return {"POTRF": nt, "TRSM": nt * (nt - 1) // 2,
            "SYRK": nt * (nt - 1) // 2,
            "GEMM": nt * (nt - 1) * (nt - 2) // 6}


def flops(cfg: dict) -> float:
    """``n³/3 + n²/2``, the factorization's operations."""
    n = cfg["N"]
    return n ** 3 / 3.0 + n ** 2 / 2.0


def k1_tasks(nt: int):
    """K1's tasks, each as ``(class, step k, tiles read, tile written)``
    in tile coordinates: TRSM ``(m, k)`` reads its tile and the inverse of
    the diagonal tile ``(k, k)``; SYRK ``(m, k)`` reads the panel tile
    ``(m, k)`` and its tile ``(m, m)``; GEMM ``(m, n, k)`` reads the panel
    tiles ``(m, k)``, ``(n, k)`` and its tile ``(m, n)``."""
    for k in range(nt):
        for m in range(k + 1, nt):
            yield "TRSM", k, ((m, k), (k, k)), (m, k)
            yield "SYRK", k, ((m, k), (m, m)), (m, m)
            for n in range(k + 1, m):
                yield "GEMM", k, ((m, k), (n, k), (m, n)), (m, n)


def k1_work(cfg: dict) -> tuple[float, float]:
    """K1's work in a solve, from the tasks it runs: TRSM ``nb³``, SYRK
    ``nb³`` and GEMM ``2 nb³`` operations.  Its bytes are the least that
    the tasks of one class at one step need together (the wavefront runs
    them as one launch): each distinct tile they read, read once, and
    each tile they write, written once."""
    nb = cfg["nb"]
    c = task_counts(cfg["N"] // nb)
    tile = nb * nb * DTYPES[cfg["dtype"]].itemsize
    ops = (c["TRSM"] + c["SYRK"] + 2 * c["GEMM"]) * nb ** 3
    reads: dict = {}
    writes: dict = {}
    for cls, k, read, wrote in k1_tasks(cfg["N"] // nb):
        reads.setdefault((cls, k), set()).update(read)
        writes.setdefault((cls, k), set()).add(wrote)
    tiles = sum(len(t) for t in reads.values()) \
        + sum(len(t) for t in writes.values())
    return float(ops), float(tiles * tile)


def lower_keys(nt: int) -> list[tuple[int, int]]:
    """The stored tiles of the lower distribution, in its key order
    (row-major), which is the order of a stacked store's rows."""
    return [(m, n) for m in range(nt) for n in range(m + 1)]


def build(cfg: dict, seed: int, device: torch.device) -> Problem:
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic
    from parsec_tpu_torch.models.cholesky import tiled_cholesky_ptg
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    n, nb = cfg["N"], cfg["nb"]
    params.set("gemm_precision", cfg["gemm_precision"])
    a = inputs.spd_matrix(n, seed, device, DTYPES[cfg["dtype"]])
    A = SymTwoDimBlockCyclic.from_dense("A", a, nb, nb)
    for key in lower_keys(A.mt):
        A.data_of(*key)
    t0 = time.perf_counter()
    low = lower_taskpool(tiled_cholesky_ptg(A), device=device)
    t1 = time.perf_counter()
    stores = low.initial_stores()
    low.warm()
    return Problem(step=low.step_fn, stores=stores, output="A",
                   inputs={"a": a}, lowered=low, lower_s=t1 - t0,
                   stores_s=time.perf_counter() - t1,
                   plan=lowered_plan(low))


def _tiles(cfg: dict, out: torch.Tensor) -> torch.Tensor:
    """A factor as ``[tiles, nb, nb]`` in :func:`lower_keys` order: a
    stacked store as it is, a dense one cut into its lower tiles."""
    nb = cfg["nb"]
    if out.dim() == 3:
        return out
    return reference.tile_grid(out, nb, lower_keys(cfg["N"] // nb))


def check(cfg: dict, problem: Problem, outs: list) -> dict[str, list]:
    """``factor_tile_rel_err`` and ``diag_tile_residual`` of each kept
    factor (:func:`portbench.reference.factor_errors`)."""
    nb = cfg["nb"]
    keys = lower_keys(cfg["N"] // nb)
    return reference.factor_errors(problem.inputs["a"], nb, keys,
                                   [_tiles(cfg, o) for o in outs])


def stand_in(cfg: dict, problem: Problem, name: str) -> torch.Tensor:
    """The reference's factor, computed as control or fault ``name``, to
    put in the program's place: ``"bf16_operands"`` rounds the operands
    of every tile product to bf16, ``"bf16_updates"`` only those of the
    trailing updates (SYRK and GEMM); ``"drop_gemm"`` leaves the last
    GEMM task, ``(nt-1, nt-2, nt-3)``, out of an fp32 factor."""
    nb, nt = cfg["nb"], cfg["N"] // cfg["nb"]
    a = problem.inputs["a"]
    if name == "drop_gemm":
        return reference.cholesky_control(a, nb, "none",
                                          drop=(nt - 1, nt - 2, nt - 3))
    rounded = {"bf16_operands": "all", "bf16_updates": "updates"}
    if name not in rounded:
        raise ValueError(f"unknown Cholesky control {name!r}")
    return reference.cholesky_control(a, nb, rounded[name], torch.bfloat16)


#: the reference one precision below the configuration's
CONTROLS = ("bf16_operands", "bf16_updates")
#: the reference with a fault planted
FAULTS = ("drop_gemm",)
