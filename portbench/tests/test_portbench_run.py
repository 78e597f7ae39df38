"""Runs of every cell on the host at a small size: the result's keys,
the comparison, the faults it must catch, the import check and the
refusal without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, spec
from portbench.kinds import potrf

CPU = torch.device("cpu")
CELLS = ["gemm16k.lowered", "potrf16k.lowered"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(bench, small, cell, trace=False, break_step=None, seed=2**31 + 5):
    """A run of ``cell`` of ``bench`` at a small size on the host."""
    return harness.measure(bench, cell, seed, 0.3, trace, CPU,
                           time.perf_counter(), cfg=small(cell),
                           break_step=break_step)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_is_correct(bench, small, cell, trace):
    res, lines = _run(bench, small, cell, trace)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(bench, cell, group)}
    assert set(res["metrics"]) <= want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # the host records no device operation: nothing to read there
        assert "k1_roofline" not in res["metrics"]
    else:
        assert "setup_s" in res["metrics"] and "tflops" in res["metrics"]
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"]
        assert any(line.startswith(f"check {name} ") for line in lines)
    json.dumps(res)


def _unchanged(problem):
    return lambda st: st


def _altered(problem):
    step, name = problem.step, problem.output

    def broken(st):
        out = step(st)
        bad = out[name].clone()
        bad.view(-1)[bad.numel() // 3] += 1.0
        return {**out, name: bad}
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _altered])
def test_a_broken_step_is_not_correct(bench, small, cell, fault):
    res, lines = _run(bench, small, cell, break_step=fault)
    assert res["correct"] is False and res["failed"] >= 1
    assert any(line.endswith("FAILED") for line in lines)


def test_factor_rows_are_the_collections_key_order(small):
    """The stacked factor's rows, read in ``lower_keys`` order, are the
    tiles ``execute()`` writes back to the collection."""
    from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic
    from parsec_tpu_torch.models.cholesky import tiled_cholesky_ptg
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    cfg = small("potrf16k.lowered")
    problem = potrf.build(cfg, 3, CPU)
    got = problem.result(problem.step(problem.stores))
    A = SymTwoDimBlockCyclic.from_dense("A", problem.inputs["a"], cfg["nb"],
                                        cfg["nb"])
    lower_taskpool(tiled_cholesky_ptg(A), device="cpu").execute()
    for row, key in enumerate(potrf.lower_keys(cfg["N"] // cfg["nb"])):
        want = A.data_of(*key).newest_copy().value
        assert torch.equal(got[row], want), key


def test_import_check_compares_whole_names():
    assert harness.forbidden_modules(["parsec_tpu_torch",
                                      "parsec_tpu_torch.ops.gemm"]) == []
    assert harness.forbidden_modules(["parsec_tpu.ops"]) == ["parsec_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib"]
    assert harness.forbidden_modules(["flax.linen"]) == ["flax"]


def test_a_run_of_the_port_loads_nothing_forbidden(tmp_path):
    """A small run in a fresh process loads the port and no JAX."""
    code = (
        "import time, torch\n"
        "from portbench import harness, spec\n"
        "b = spec.load()\n"
        "cfg = {**spec.config(b, 'potrf_n16384_nb512'), 'N': 128, 'nb': 64}\n"
        "harness.measure(b, 'potrf16k.lowered', 1, 0.1, False,\n"
        "                torch.device('cpu'), time.perf_counter(), cfg=cfg)\n"
        "import sys\n"
        "assert 'parsec_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Where torch sees too few cards the command prints nothing on its
    standard output and exits with another code than 0."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without")
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "gemm16k.lowered",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_outside_a_checkout_no_result(tmp_path):
    """In a folder with only BENCHMARK.json and the benchmark's files the
    program is missing: no result, and another code than 0."""
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "gemm16k.lowered",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
