"""The route of the factorizations' diagonal-tile calls (``ops/factor.py``):
which tiles take the hand-written kernels of ``csrc/factor.cu`` and which
keep the library call, decided from the input alone.

The kernels run only on the card (``tests/test_torch_card.py`` holds them
against the library and float64); here a stand-in with a CUDA device and
a shape asks :func:`factor.hand_route`, and CPU tensors run the library
route end to end.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from parsec_tpu_torch.models import cholesky as chol
from parsec_tpu_torch.models import lu
from parsec_tpu_torch.ops import factor
from parsec_tpu_torch.ptg.lowering import find_traceable


def _tile(n, device="cuda", batch=()):
    return SimpleNamespace(device=torch.device(device), shape=(*batch, n, n))


@pytest.mark.parametrize("n,batch,want", [
    (32, (), True), (64, (), True), (96, (), True), (128, (3,), True),
    (256, (), True), (512, (), True), (512, (4,), True),
    (512, (2, 3), True), (16, (), False), (48, (), False),
    (520, (), False), (1024, (), False), (2048, (), False)])
def test_hand_route_takes_orders_32_to_512_in_steps_of_32(n, batch, want):
    assert factor.hand_route(_tile(n, batch=batch)) is want


@pytest.mark.parametrize("upper,unit", [(True, False), (False, True),
                                        (True, True)])
def test_upper_and_unit_inverses_keep_the_library(upper, unit):
    assert not factor.hand_route(_tile(512), upper, unit)
    assert factor.hand_route(_tile(512), False, False)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tiles_off_the_card_keep_the_library(device):
    assert not factor.hand_route(_tile(512, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
def test_every_dtype_is_read_as_fp32_on_either_route(dtype):
    """The route does not look at the dtype: both read the tile through
    ``.float()`` and return fp32."""
    t = torch.from_numpy(chol.make_spd_fast(64, 3)).to(dtype)
    assert factor.potrf(t).dtype == torch.float32
    assert factor.tri_inverse(factor.potrf(t), upper=False).dtype \
        == torch.float32
    assert factor.hand_route(SimpleNamespace(device=torch.device("cuda"),
                                             shape=t.shape))


def _counts():
    return dict(factor.launches_by_route)


def _delta(before):
    now = factor.launches_by_route
    return {k: now[k] - before.get(k, 0) for k in now
            if now[k] != before.get(k, 0)}


def test_cpu_tensors_count_library_launches():
    a = torch.from_numpy(np.stack([chol.make_spd_fast(64, s)
                                   for s in (4, 5)]))
    before = _counts()
    L = factor.potrf(a)
    factor.tri_inverse(L, upper=False)
    factor.tri_inverse(L[:1].expand(3, 64, 64), upper=False)
    factor.tri_inverse_tiles([L[0], L[1], L[0]], upper=False)
    factor.tri_inverse(L, upper=True)
    assert _delta(before) == {("potrf", "library"): 1,
                              ("trsm", "library"): 4}


def test_the_route_follows_the_input_with_no_knob(monkeypatch):
    """No parameter or environment variable enters the route: only the
    tile's device, order and the inverse's flags."""
    import inspect
    src = inspect.getsource(factor.hand_route)
    assert "params" not in src and "environ" not in src
    monkeypatch.setenv("PARSEC_MCA_gemm_precision", "highest")
    assert factor.hand_route(_tile(512))


def test_cholesky_traceables_name_the_factor_library():
    assert find_traceable("potrf").libs == ("factor",)
    assert set(find_traceable("trsm_rlt").libs) == {"gemm", "factor"}
    for name in ("syrk_ln", "gemm_nt"):
        assert find_traceable(name).libs == ("gemm",)


@pytest.mark.parametrize("name", ["lu_getrf", "lu_trsm_l", "lu_trsm_u",
                                  "lu_gemm"])
def test_lu_traceables_keep_the_library(name):
    assert "factor" not in find_traceable(name).libs


def test_lu_inverses_ask_for_upper_or_unit(monkeypatch):
    """The LU's TRSM bodies ask for unit-lower and upper inverses, which
    the route refuses on the card; the Cholesky's TRSM asks for a lower,
    non-unit one, which it takes."""
    asked = []
    real = factor.hand_route

    def spy(t, upper=False, unit=False):
        asked.append((upper, unit))
        return real(t, upper, unit)

    monkeypatch.setattr(factor, "hand_route", spy)
    nb = 64
    k = torch.from_numpy(lu.make_dd(nb, 3)).float()
    c = torch.randn(nb, nb, generator=torch.Generator().manual_seed(4))
    lu.trsm_l_tiles([k], [c])
    lu.trsm_u_tiles([k], [c])
    assert asked and all(up or unit for up, unit in asked)
    asked.clear()
    L = factor.potrf(torch.from_numpy(chol.make_spd_fast(nb, 5)))
    chol.trsm_tiles([L], [c])
    assert asked[-1] == (False, False)
    assert all(real(_tile(nb), up, unit) == (not up and not unit)
               for up, unit in [(False, False), (True, False),
                                (False, True)])
