"""The port's perf ledger (``parsec_tpu_torch/prof/perfdb.py``) against
the JAX package's (``parsec_tpu/prof/perfdb.py``).

The EWMA sentinel's verdicts and z-scores on the same seeded series (both
packages round z to two decimals; the unrounded fold is compared within
1e-12), the metric-direction heuristic on the same names, the key layout,
a ledger one package writes read by the other (the backend column keeps
their keys apart), the torn-tail rule, ``note_result``'s walk, the
self-test and the CLI, and the perf-smoke sentinel gate
(``tests/test_perf_smoke.py``'s perfdb case) on the port.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from parsec_tpu.prof import perfdb as jdb
from parsec_tpu_torch.prof import perfdb as pdb

REPO = Path(__file__).resolve().parent.parent
BE = ["t", "c", ""]


def _series(seed: int, n: int, mean: float, rel: float) -> list[float]:
    rng = np.random.default_rng(seed)
    return [float(v) for v in mean * (1.0 + rel * rng.standard_normal(n))]


@pytest.mark.parametrize("metric", ["dispatch_us", "tokens_per_s",
                                    "wall_s", "gflops", "tile_err"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_check_gives_the_jax_verdict_and_z(tmp_path, metric, seed):
    """Same history, same probes: same verdict, same z, same EWMA."""
    hist = _series(seed, 12, 100.0, 0.03)
    probes = [100.0, 104.0, 70.0, 130.0, 10.0, 1000.0, 100.0 * (1 + seed)]
    jd = jdb.PerfDB(str(tmp_path / "j.jsonl"))
    pd = pdb.PerfDB(str(tmp_path / "p.jsonl"))
    jk = jdb.make_key("w", metric, backend=BE)
    pk = pdb.make_key("w", metric, backend=BE)
    assert jk == pk
    for v in hist:
        jd.append(jk, v)
        pd.append(pk, v)
    for x in probes:
        jv, pv = jd.check(jk, x), pd.check(pk, x)
        assert pv["verdict"] == jv["verdict"], (x, jv, pv)
        assert abs(pv["z"] - jv["z"]) <= 1e-12 and pv["n"] == jv["n"]
        assert abs(pv["ewma"] - jv["ewma"]) <= 1e-12
    jm, js, jn = jdb.PerfDB._ewma(hist)
    pm, ps, pn = pdb.PerfDB._ewma(hist)
    assert pn == jn and abs(pm - jm) <= 1e-12 and abs(ps - js) <= 1e-12


def test_warming_below_min_history(tmp_path):
    pd = pdb.PerfDB(str(tmp_path / "p.jsonl"))
    k = pdb.make_key("w", "x_s", backend=BE)
    for i in range(pdb.MIN_HISTORY - 1):
        pd.append(k, 1.0)
        assert pd.check(k, 50.0)["verdict"] == "warming"
    pd.append(k, 1.0)
    assert pd.check(k, 50.0)["verdict"] == "regressed"


@pytest.mark.parametrize("name", [
    "tokens_per_s", "dispatch_us", "ttft_ms_p99", "wall_s", "gflops",
    "prefix_hits", "comm_agree_8r_err", "bytes_relerr", "speedup",
    "tile_error", "compile_s", "tune_speedup", "queue_wait_ms", "label"])
def test_better_of_is_the_jax_heuristic(name):
    assert pdb.better_of(name) == jdb.better_of(name)


def test_constants_are_the_jax_constants():
    assert (pdb.ALPHA, pdb.Z_THRESHOLD, pdb.REL_FLOOR, pdb.MIN_HISTORY) \
        == (jdb.ALPHA, jdb.Z_THRESHOLD, jdb.REL_FLOOR, jdb.MIN_HISTORY)


def test_a_ledger_one_package_wrote_parses_in_the_other(tmp_path):
    """One file, both writers: each reads every record, and the
    histories stay apart by the backend column."""
    path = str(tmp_path / "perfdb.jsonl")
    jd, pd = jdb.PerfDB(path), pdb.PerfDB(path)
    jd.note_trial("tune.wl:x", "wall_s", 1.5, knobs={"nb": 256})
    pd.note_trial("tune.wl:x", "wall_s", 0.5, knobs={"nb": 256})
    jd.note_result("stage", {"gflops": 3.0})
    pd.note_result("stage", {"gflops": 4.0})
    for db in (jdb.PerfDB(path), pdb.PerfDB(path)):
        recs = db.records()
        assert len(recs) == 4
        assert {tuple(json.loads(r["key"])["backend"])[1:2]
                for r in recs} >= {("cpu",)}
    jk = jdb.make_key("tune.wl:x", "wall_s", knobs={"nb": 256})
    pk = pdb.make_key("tune.wl:x", "wall_s", knobs={"nb": 256})
    assert jk != pk                     # the backend column differs
    assert json.loads(pk)["backend"][0] != json.loads(jk)["backend"][0]
    assert pdb.PerfDB(path).history(pk) == [0.5]
    assert jdb.PerfDB(path).history(jk) == [1.5]
    # the same key layout: a JAX key with the port's backend is the
    # port's key
    assert jdb.make_key("tune.wl:x", "wall_s", knobs={"nb": 256},
                        backend=pdb.backend_signature()) == pk


def test_backend_signature_names_torch():
    import torch
    be = pdb.backend_signature()
    assert be[0] == torch.__version__
    assert be[1] == ("cuda" if torch.cuda.is_available() else "cpu")


def test_torn_tail_is_skipped(tmp_path):
    path = tmp_path / "perfdb.jsonl"
    pd = pdb.PerfDB(str(path))
    k = pdb.make_key("w", "x_s", backend=BE)
    pd.append(k, 1.0)
    with open(path, "a") as f:
        f.write('{"key": "torn half-li')
    assert pdb.PerfDB(str(path)).history(k) == [1.0]
    assert jdb.PerfDB(str(path)).history(k) == [1.0]


def test_note_result_walks_scalars_like_the_jax_package(tmp_path):
    res = {"gflops": 3.0, "runtime_report": {"x": 1},
           "partial": {"compile_s": 2.0}, "label": "str-skipped",
           "flag": True, "nan": float("nan"), "_private": 1.0}
    j = jdb.PerfDB(str(tmp_path / "j.jsonl")).note_result(
        "s", res, backend=BE)
    p = pdb.PerfDB(str(tmp_path / "p.jsonl")).note_result(
        "s", res, backend=BE)
    assert [(e["metric"], e["key"], e["verdict"]) for e in p] \
        == [(e["metric"], e["key"], e["verdict"]) for e in j]
    assert {e["metric"] for e in p} == {"gflops", "partial.compile_s"}


def test_sentinel_roundtrips_a_synthetic_regression(tmp_path):
    """The perf-smoke gate on the port: 5% noise stays quiet, a 10x
    cliff is flagged in both metric directions."""
    db = pdb.PerfDB(path=str(tmp_path / "perfdb.jsonl"))
    kd = pdb.make_key("smoke", "dispatch_us", backend=["cpu"])
    kt = pdb.make_key("smoke", "tokens_per_s", backend=["cpu"])
    for i in range(16):
        db.append(kd, 100.0 + (i % 2))
        db.append(kt, 1000.0 - (i % 3))
    assert db.check(kd, 105.0)["verdict"] == "ok"
    hi = db.check(kd, 1000.0)
    assert hi["verdict"] == "regressed" and hi["z"] > 0, hi
    assert db.check(kt, 100.0)["verdict"] == "regressed"
    assert db.check(kt, 10000.0)["verdict"] == "improved"


def test_params_default_path(tmp_path, monkeypatch):
    from parsec_tpu_torch.core.params import params
    assert params.get("perfdb") is True
    monkeypatch.setenv("PARSEC_TPU_ARTIFACT_DIR", str(tmp_path))
    prev = params.get("perfdb_path")
    params.set("perfdb_path", "")
    try:
        assert pdb.default_path() == str(tmp_path / "perfdb.jsonl")
        params.set("perfdb_path", str(tmp_path / "x.jsonl"))
        assert pdb.PerfDB().path == str(tmp_path / "x.jsonl")
    finally:
        params.set("perfdb_path", prev)


def test_self_test_and_cli(tmp_path):
    assert pdb.self_test() == 0
    path = tmp_path / "perfdb.jsonl"
    pd = pdb.PerfDB(str(path))
    for v in (1.0, 2.0, 3.0):
        pd.append(pdb.make_key("tune.wl:y", "wall_s", backend=BE), v)
    r = subprocess.run(
        [sys.executable, "-m", "parsec_tpu_torch.prof.perfdb", "-o",
         str(path), "--history", "tune.wl:y"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("tune.wl:y/wall_s: n=3 "), r.stdout


def test_ingest_backfills_a_bench_artifact(tmp_path):
    art = tmp_path / "BENCH_rX.json"
    art.write_text(json.dumps({"parsed": {
        "metric": "gemm_gflops", "value": 10.0, "unit": "GFLOPS",
        "extra": {"n": 64, "nb": 16, "device_kind": "cardX",
                  "dispatch_us": 2.0, "serve": {"p50_ms": 3.0}}}}))
    db = pdb.PerfDB(str(tmp_path / "perfdb.jsonl"))
    out = pdb.ingest([str(art)], db)
    assert out["files"] == 1 and out["records"] == 5
    kinds = {json.loads(r["key"])["backend"][2] for r in db.records()}
    assert kinds == {"cardX"}
