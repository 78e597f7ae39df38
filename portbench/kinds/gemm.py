"""The tiled GEMM ``C += A @ B`` (``tiled_gemm_ptg``), lowered whole.

Configuration keys: ``N`` (the matrices' order), ``nb`` (the tile),
``ab_dtype`` and ``c_dtype`` (the operands' and the result's types),
``peak`` (the tensor-core rate K1 runs at, a key of
:data:`portbench.roofline.PEAK_FLOPS`) and ``limits``.
"""

from __future__ import annotations

import time

import torch

from .. import inputs, reference
from ..problem import DTYPES, Problem, lowered_plan


def flops(cfg: dict) -> float:
    """``2 N³``: one multiply and one add a term."""
    return 2.0 * cfg["N"] ** 3


def k1_work(cfg: dict) -> tuple[float, float]:
    """K1's work in a solve: the whole product, reading A, B and C once
    and writing C once."""
    n = cfg["N"]
    ab = DTYPES[cfg["ab_dtype"]].itemsize
    c = DTYPES[cfg["c_dtype"]].itemsize
    return flops(cfg), 2 * n * n * ab + 2 * n * n * c


def build(cfg: dict, seed: int, device: torch.device) -> Problem:
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    n, nb = cfg["N"], cfg["nb"]
    a, b = inputs.gemm_operands(n, seed, device, DTYPES[cfg["ab_dtype"]])
    c = torch.zeros(n, n, dtype=DTYPES[cfg["c_dtype"]], device=device)
    A = TiledMatrix.from_dense("A", a, nb, nb)
    B = TiledMatrix.from_dense("B", b, nb, nb)
    C = TiledMatrix.from_dense("C", c, nb, nb)
    t0 = time.perf_counter()
    low = lower_taskpool(tiled_gemm_ptg(A, B, C), device=device)
    t1 = time.perf_counter()
    stores = low.initial_stores()
    low.warm()
    return Problem(step=low.step_fn, stores=stores, output="C",
                   inputs={"a": a, "b": b}, lowered=low, lower_s=t1 - t0,
                   stores_s=time.perf_counter() - t1,
                   plan=lowered_plan(low))


def check(cfg: dict, problem: Problem, outs: list) -> dict[str, list]:
    """``c_rel_err``: each kept product's ``max|C - A@B| / max|A@B|``
    against the float64 product."""
    x = problem.inputs
    errs = reference.gemm_errors(x["a"], x["b"], outs)
    return {"c_rel_err": errs}


def stand_in(cfg: dict, problem: Problem, name: str) -> torch.Tensor:
    """The reference's product, computed as control or fault ``name``
    (:data:`CONTROLS`, :data:`FAULTS`; see
    :func:`portbench.reference.gemm_control`), to put in the program's
    place."""
    x = problem.inputs
    return reference.gemm_control(x["a"], x["b"], name, cfg["nb"])


#: the reference one precision below the configuration's
CONTROLS = ("bf16_out", "fp8_in")
#: the reference with a fault planted
FAULTS = ("drop_task",)
