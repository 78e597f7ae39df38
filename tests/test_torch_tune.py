"""The port's autotuner (``parsec_tpu_torch/tune``) and knob layer
(``parsec_tpu_torch/core/params.py``) against the JAX package's.

Mirrors ``tests/test_tune.py``: knob declarations and scoped overrides
(the port's ``knob_space()`` equals the JAX package's, less
``lowering_region_max_tasks``, whose regions are not ported), workload
signatures equal to the JAX package's, the tuning DB (a file one package
writes parses in the other; ``best`` misses across them only because the
backend column differs), the ambient consults, the search (the same trial
sequence and winner as the JAX ``search`` with the same seed, space and
budget on a deterministic objective; perfdb pruning; reseeding from a
persisted winner), the adaptive controller (the same value trajectory as
the JAX controller on the same observations, with an explicit
``stagger``), and the closed loop: a seeded-bad ``llm_steps_per_pool=1``
on a served decode backlog, scored by tokens per pool submit (a
deterministic count, never wall time), recovered by ``search``, persisted
and picked up by a fresh ``Context``; with ``tune_adaptive`` on, every
stream keeps the JAX oracle's tokens.  Exact equality throughout: the
objectives are deterministic.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import parsec_tpu.comm.engine  # noqa: F401 — declares the comm knobs
import parsec_tpu.comm.remote_dep  # noqa: F401
import parsec_tpu.llm.batcher  # noqa: F401 — declares llm_steps_per_pool
import parsec_tpu.runtime.context  # noqa: F401
import parsec_tpu.runtime.deps  # noqa: F401
from parsec_tpu.core.params import KnobSpec as JKnobSpec
from parsec_tpu.core.params import params as jparams
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as j_gemm
from parsec_tpu.tune import TuneDB as JTuneDB
from parsec_tpu.tune import adaptive as jadaptive
from parsec_tpu.tune import ambient_signature as j_ambient
from parsec_tpu.tune import db as jtunedb
from parsec_tpu.tune import workload_signature as j_signature
from parsec_tpu.tune.search import search as j_search
import parsec_tpu_torch.comm.engine  # noqa: F401 — declares the comm knobs
import parsec_tpu_torch.comm.remote_dep  # noqa: F401
import parsec_tpu_torch.llm.batcher  # noqa: F401
from parsec_tpu_torch.core.params import KnobSpec
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.prof import perfdb as pperfdb
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.serve import RuntimeServer
from parsec_tpu_torch.tune import (TuneDB, ambient_signature,
                                   apply_ambient, consult_ambient,
                                   workload_signature)
from parsec_tpu_torch.tune import adaptive
from parsec_tpu_torch.tune import db as tunedb
from parsec_tpu_torch.tune.adaptive import GARBAGE_LIMIT, KnobController
from parsec_tpu_torch.tune.search import declared_space, search

REPO = Path(__file__).resolve().parent.parent
JMODEL = JToyLM()


@pytest.fixture
def port_param():
    """Scoped override of the port's params, restored at test exit."""
    saved = {}

    def set_(name, value):
        saved.setdefault(name, params.get(name))
        params.set(name, value)

    yield set_
    for name, value in saved.items():
        params.set(name, value)


@pytest.fixture
def cpu_cuda_device():
    """The port's CUDA device module around the host CPU."""
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


# ---------------------------------------------------------------------------
# the knob layer (core/params.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,cur", [
    (dict(lo=1, hi=8, scale="log2"), 2), (dict(lo=1, hi=8, scale="log2"), 8),
    (dict(lo=1, hi=8, scale="log2"), 1),
    (dict(values=("a", "b", "c")), "b"), (dict(values=("a", "b", "c")), "a"),
    (dict(values=("a", "b", "c")), "zz"),
    (dict(lo=0, hi=10, step=2.0), 4), (dict(lo=0, hi=10, step=2.0), 10),
    (dict(lo=128, hi=4096, scale="log2"), 128),
    (dict(lo=0.5, hi=4.0, scale="log2"), 1.0)])
def test_knobspec_moves_and_samples_as_the_jax_package(spec, cur):
    import random
    j, p = JKnobSpec(name="k", **spec), KnobSpec(name="k", **spec)
    assert p.neighbors(cur) == j.neighbors(cur)
    for v in (cur, 0, 9, "b", 4096):
        try:
            want = j.contains(v)
        except TypeError:
            continue
        assert p.contains(v) == want
    rj, rp = random.Random(3), random.Random(3)
    assert [p.sample(rp) for _ in range(8)] == [j.sample(rj)
                                               for _ in range(8)]


def test_declare_knob_idempotent_and_declared_space():
    params.register("tune_t_knob", 4, "test knob")
    s1 = params.declare_knob("tune_t_knob", lo=1, hi=16, scale="log2")
    s2 = params.declare_knob("tune_t_knob", lo=2, hi=999)
    assert s1 is s2 and s2.hi == 16         # first declaration wins
    assert params.knob_spec("tune_t_knob") is s1
    assert "tune_t_knob" in declared_space(["tune_t_knob"])
    with pytest.raises(KeyError):
        declared_space(["definitely_not_declared"])


def test_overrides_scoped_and_atomic():
    params.register("tune_t_ov", 3, "test")
    with params.overrides({"tune_t_ov": 7}):
        assert params.get("tune_t_ov") == 7
        assert params.lookup("tune_t_ov").source == "set"
    assert params.get("tune_t_ov") == 3
    assert params.lookup("tune_t_ov").source == "default"
    with pytest.raises(KeyError):
        with params.overrides({"tune_t_ov": 9, "tune_t_missing": 1}):
            pass
    assert params.get("tune_t_ov") == 3
    assert params.lookup("tune_t_missing") is None


def test_snapshot_is_every_scalar_param_sorted():
    params.register("tune_t_snap", 1.5, "test")
    snap = params.snapshot()
    assert list(snap) == sorted(snap)
    assert snap["tune_t_snap"] == 1.5
    assert all(isinstance(v, (bool, int, float, str)) for v in snap.values())


def _production(space: dict) -> dict:
    # test files declare tune_* knobs of their own in either registry
    return {n: (s.values, s.lo, s.hi, s.scale, s.step)
            for n, s in space.items() if not n.startswith("tune_")}


def test_knob_space_equals_the_jax_package_less_regions():
    jspace = _production(jparams.knob_space())
    pspace = _production(params.knob_space())
    jspace.pop("lowering_region_max_tasks", None)
    assert pspace == jspace
    assert set(pspace) == {"sched", "deps_storage", "llm_steps_per_pool",
                           "comm_get_frag_bytes", "comm_get_window",
                           "comm_bcast_tree"}


def test_runtime_report_carries_knob_vector(port_param):
    from parsec_tpu_torch.prof.flight_recorder import runtime_report
    params.register("tune_t_rep", 5, "test")
    params.declare_knob("tune_t_rep", lo=1, hi=8)
    port_param("tune_t_rep", 6)
    kn = runtime_report()["knobs"]
    assert kn["tune_t_rep"] == 6            # non-default value resolved
    snap = params.snapshot()
    for name in params.knob_space():        # every declared knob rides
        if name in snap:
            assert name in kn, name
    for name, v in kn.items():              # and nothing at its default
        p = params.lookup(name)             # that is not a knob
        assert name in params.knob_space() or p.source != "default", name


# ---------------------------------------------------------------------------
# structural signatures
# ---------------------------------------------------------------------------

def _gemm(pkg, n=12, nb=4, seed=0, tag="x"):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    z = np.zeros((n, n), np.float32)
    if pkg == "jax":
        return j_gemm(JTiledMatrix.from_dense(f"A{tag}", a, nb, nb),
                      JTiledMatrix.from_dense(f"B{tag}", a.T.copy(), nb, nb),
                      JTiledMatrix.from_dense(f"C{tag}", z, nb, nb))
    return tiled_gemm_ptg(TiledMatrix.from_dense(f"A{tag}", a, nb, nb),
                          TiledMatrix.from_dense(f"B{tag}", a.T.copy(), nb,
                                                 nb),
                          TiledMatrix.from_dense(f"C{tag}", z, nb, nb))


def test_equal_structure_equal_signature_equal_db_key():
    s1 = workload_signature(_gemm("port", seed=0, tag="p"))
    s2 = workload_signature(_gemm("port", seed=9, tag="q"))
    assert s1 == s2
    be = ["2.x", "cpu", ""]
    assert tunedb.make_key(s1, backend=be) == tunedb.make_key(s2, backend=be)


def test_signature_is_the_jax_signature():
    for n, nb, hint in ((12, 4, None), (16, 4, None), (12, 4, 8192)):
        assert workload_signature(_gemm("port", n, nb), size_hint=hint) \
            == j_signature(_gemm("jax", n, nb), size_hint=hint)
    # 27 tasks: bucket 4, the first class's name as the readable head
    assert workload_signature(_gemm("port")).startswith("wl:GEMM:b4:")


def test_backend_change_different_key_same_signature():
    s = workload_signature(_gemm("port"))
    k_cpu = tunedb.make_key(s, backend=["2.x", "cpu", ""])
    k_gpu = tunedb.make_key(s, backend=["2.x", "cuda", "H100"])
    assert k_cpu != k_gpu
    assert json.loads(k_cpu)["sig"] == json.loads(k_gpu)["sig"]
    # the key layout is the JAX package's
    assert k_cpu == jtunedb.make_key(s, backend=["2.x", "cpu", ""])


def test_different_structure_different_signature():
    assert workload_signature(_gemm("port", n=12, nb=4)) != \
        workload_signature(_gemm("port", n=16, nb=4))
    tp = _gemm("port")
    assert workload_signature(tp, size_hint=512) != \
        workload_signature(tp, size_hint=8192)


# ---------------------------------------------------------------------------
# the tuning DB
# ---------------------------------------------------------------------------

def test_tunedb_best_direction_per_objective(tmp_path):
    db = TuneDB(str(tmp_path / "t.jsonl"))
    be = ["j", "cpu", ""]
    db.note("s", {"k": 1}, 10.0, objective="tokens_per_s", backend=be)
    db.note("s", {"k": 2}, 90.0, objective="tokens_per_s", backend=be)
    db.note("s", {"k": 3}, 5.0, objective="tok_latency_ms", backend=be)
    db.note("s", {"k": 4}, 1.0, objective="tok_latency_ms", backend=be)
    assert db.best("s", objective="tokens_per_s",
                   backend=be)["knobs"] == {"k": 2}
    assert db.best("s", objective="tok_latency_ms",
                   backend=be)["knobs"] == {"k": 4}
    assert db.best("s", objective="wall_s", backend=be) is None
    with pytest.raises(ValueError):
        db.note("s", {"k": 5}, float("nan"))


def test_a_tunedb_one_package_wrote_parses_in_the_other(tmp_path):
    """Both packages append to one file.  Each parses every record; each
    finds its own winner; a JAX record never answers the port's
    ``best`` (nor the reverse), and only because the backend column
    differs: with the other's backend named, it is found."""
    path = str(tmp_path / "tunedb.jsonl")
    JTuneDB(path).note("wl:x", {"nb": 128}, 1.25, objective="wall_s")
    TuneDB(path).note("wl:x", {"nb": 512}, 2.5, objective="wall_s")
    jrecs, precs = JTuneDB(path).records(), TuneDB(path).records()
    assert len(jrecs) == len(precs) == 2
    assert [r["knobs"] for r in jrecs] == [r["knobs"] for r in precs]
    assert TuneDB(path).best("wl:x")["knobs"] == {"nb": 512}
    assert JTuneDB(path).best("wl:x")["knobs"] == {"nb": 128}
    jbe = json.loads(jrecs[0]["key"])["backend"]
    pbe = json.loads(precs[1]["key"])["backend"]
    assert jbe != pbe and pbe == pperfdb.backend_signature()
    assert TuneDB(path).best("wl:x", backend=jbe)["knobs"] == {"nb": 128}
    assert JTuneDB(path).best("wl:x", backend=pbe)["knobs"] == {"nb": 512}


def test_tunedb_cross_process_roundtrip(tmp_path):
    """A vector noted here is ``best`` in a fresh interpreter, and a
    vector the child appends reaches the parent's cached consult."""
    path = str(tmp_path / "tunedb.jsonl")
    be = ["j", "cpu", ""]
    TuneDB(path).note("wl:x", {"nb": 128, "sched": "spq"}, 1.25,
                      objective="wall_s", backend=be)
    code = (
        "import json\n"
        "from parsec_tpu_torch.tune.db import TuneDB\n"
        f"db = TuneDB({path!r})\n"
        f"rec = db.best('wl:x', objective='wall_s', backend={be!r})\n"
        "print(json.dumps(rec['knobs']))\n"
        f"db.note('wl:x', {{'nb': 256}}, 0.5, objective='wall_s',"
        f" backend={be!r})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip()) == {"nb": 128, "sched": "spq"}
    rec = tunedb.cached_db(path).best("wl:x", objective="wall_s",
                                      backend=be)
    assert rec["knobs"] == {"nb": 256}


def test_tunedb_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "t.jsonl")
    TuneDB(path).note("s", {"k": 1}, 1.0, backend=["j", "cpu", ""])
    with open(path, "a") as f:
        f.write('{"key": "torn half-line')
    rec = TuneDB(path).best("s", backend=["j", "cpu", ""])
    assert rec is not None and rec["knobs"] == {"k": 1}


def test_default_path_is_the_artifact_dir_else_the_temp_dir(
        tmp_path, port_param, monkeypatch):
    import tempfile
    monkeypatch.delenv("PARSEC_TPU_ARTIFACT_DIR", raising=False)
    port_param("tune_db_path", "")
    assert tunedb.default_path() == os.path.join(tempfile.gettempdir(),
                                                 "tunedb.jsonl")
    monkeypatch.setenv("PARSEC_TPU_ARTIFACT_DIR", str(tmp_path))
    assert tunedb.default_path() == str(tmp_path / "tunedb.jsonl")


# ---------------------------------------------------------------------------
# ambient consult and apply
# ---------------------------------------------------------------------------

def test_consult_ambient_filters_to_declared_domain(tmp_path, port_param):
    path = str(tmp_path / "tunedb.jsonl")
    port_param("tune_db_path", path)
    params.register("tune_t_consult", 2, "test")
    params.declare_knob("tune_t_consult", lo=1, hi=8)
    TuneDB(path).note(ambient_signature("t_gate"),
                      {"tune_t_consult": 4, "undeclared_thing": 9}, 1.0)
    TuneDB(path).note(ambient_signature("t_oob"),
                      {"tune_t_consult": 99}, 1.0)
    assert consult_ambient("t_gate") == {"tune_t_consult": 4}
    assert consult_ambient("t_oob") is None     # out-of-domain dropped
    port_param("tune_db", False)
    assert consult_ambient("t_gate") is None    # the gate


def test_apply_ambient_respects_operator_pins(tmp_path, port_param):
    path = str(tmp_path / "tunedb.jsonl")
    port_param("tune_db_path", path)
    params.register("tune_t_apply", 2, "test")
    params.declare_knob("tune_t_apply", lo=1, hi=8)
    TuneDB(path).note(ambient_signature("t_apply"),
                      {"tune_t_apply": 8}, 1.0)
    p = params.lookup("tune_t_apply")
    src = p.source
    p.source = "env"                    # an operator's env pin
    try:
        assert apply_ambient("t_apply") is None
        assert params.get("tune_t_apply") == 2
    finally:
        p.source = src
    assert apply_ambient("t_apply") == {"tune_t_apply": 8}
    assert params.get("tune_t_apply") == 8
    params.set("tune_t_apply", 2)


def test_a_jax_ambient_vector_never_applies_to_the_port(tmp_path,
                                                        port_param):
    """The file is shared: a JAX record under ``ambient:context`` or
    ``ambient:tenant:<t>`` carries the JAX backend in its key, so a port
    ``Context`` start applies nothing from it and the port's tenant
    consult misses; the same vector noted by the port applies."""
    path = str(tmp_path / "tunedb.jsonl")
    port_param("tune_db_path", path)
    port_param("sched", "lfq")
    port_param("llm_steps_per_pool", 4)
    JTuneDB(path).note(j_ambient("context"), {"sched": "ip"}, 0.5)
    JTuneDB(path).note(j_ambient("tenant:t0"),
                       {"llm_steps_per_pool": 16}, 1.0,
                       objective="tok_latency_ms")
    ctx = Context(nb_cores=0)
    try:
        assert ctx.tuned_knobs is None
        assert params.get("sched") == "lfq"
    finally:
        ctx.fini()
    assert consult_ambient("tenant:t0") is None
    assert consult_ambient("tenant:t0", objective="tok_latency_ms") is None
    TuneDB(path).note(ambient_signature("context"), {"sched": "spq"}, 2.0)
    ctx = Context(nb_cores=0)
    try:
        assert ctx.tuned_knobs == {"sched": "spq"}
    finally:
        ctx.fini()


def test_a_failing_db_never_fails_a_context_start(tmp_path, port_param):
    bad = tmp_path / "dir_not_file"
    bad.mkdir()
    port_param("tune_db_path", str(bad))
    ctx = Context(nb_cores=0)
    try:
        assert ctx.tuned_knobs is None
    finally:
        ctx.fini()


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _cost(k: dict) -> float:
    return ((math.log2(k["tsx"]) - 3.0) ** 2
            + {"a": 0.0, "b": 1.0, "c": 2.5}[k["tsm"]]
            + 0.1 * (k["tsy"] - 5) ** 2)


def _space(cls):
    return {"tsx": cls(name="tsx", lo=1, hi=64, scale="log2"),
            "tsm": cls(name="tsm", values=("c", "b", "a")),
            "tsy": cls(name="tsy", lo=0, hi=9, step=1.0)}


@pytest.mark.parametrize("seed,budget,restarts,start", [
    (0, 12, 1, {"tsx": 64, "tsm": "c", "tsy": 0}),
    (7, 20, 3, None), (3, 9, 2, None), (11, 30, 4, {"tsx": 1})])
def test_search_walks_the_jax_trajectory(tmp_path, port_param, seed,
                                         budget, restarts, start):
    port_param("perfdb", False)
    prev = jparams.get("perfdb")
    jparams.set("perfdb", False)
    try:
        j = j_search(_cost, signature="t:parity", space=_space(JKnobSpec),
                     budget=budget, restarts=restarts, objective="cost_s",
                     seed=seed, start=start,
                     db=JTuneDB(str(tmp_path / "j.jsonl")))
    finally:
        jparams.set("perfdb", prev)
    p = search(_cost, signature="t:parity", space=_space(KnobSpec),
               budget=budget, restarts=restarts, objective="cost_s",
               seed=seed, start=start, db=TuneDB(str(tmp_path / "p.jsonl")))
    assert [t["knobs"] for t in p["trials"]] == \
        [t["knobs"] for t in j["trials"]]
    assert [t["score"] for t in p["trials"]] == \
        [t["score"] for t in j["trials"]]
    assert (p["best"], p["best_score"], p["evals"], p["pruned"]) == \
        (j["best"], j["best_score"], j["evals"], j["pruned"])


def test_search_prunes_known_bad_points_from_ledger(tmp_path, port_param):
    port_param("perfdb", True)
    port_param("perfdb_path", str(tmp_path / "perfdb.jsonl"))
    perf = pperfdb.PerfDB()
    space = {"x": KnobSpec(name="x", lo=1, hi=4, step=1.0)}
    sig = "t:prune"
    bad_key = pperfdb.make_key(f"tune.{sig}", "cost_s", knobs={"x": 2})
    for _ in range(4):
        perf.append(bad_key, 1000.0, run="tune")
    ran: list = []

    def fn(knobs):
        ran.append(dict(knobs))
        return 1.0

    out = search(fn, signature=sig, space=space, budget=8, restarts=1,
                 objective="cost_s", start={"x": 1},
                 db=TuneDB(str(tmp_path / "t.jsonl")), persist=False)
    assert out["pruned"] >= 1, out
    assert {"x": 2} not in ran              # never re-measured
    assert out["best"] == {"x": 1}
    # the executed trial reached the ledger under its knob vector
    assert pperfdb.PerfDB().history(pperfdb.make_key(
        f"tune.{sig}", "cost_s", knobs={"x": 1})) == [1.0]


def test_search_persists_winner_and_reseeds_from_it(tmp_path, port_param):
    port_param("perfdb", False)
    db = TuneDB(str(tmp_path / "t.jsonl"))
    space = {"x": KnobSpec(name="x", lo=1, hi=16, scale="log2")}
    cost = {1: 9.0, 2: 5.0, 4: 2.0, 8: 1.0, 16: 3.0}
    out = search(lambda k: cost[k["x"]], signature="t:seed", space=space,
                 budget=10, restarts=1, objective="cost_s",
                 start={"x": 1}, db=db, ambient_tag="t_seed")
    assert out["best"] == {"x": 8} and out["best_score"] == 1.0
    assert db.best("t:seed", objective="cost_s")["knobs"] == {"x": 8}
    assert db.best(ambient_signature("t_seed"),
                   objective="cost_s")["knobs"] == {"x": 8}
    out2 = search(lambda k: cost[k["x"]], signature="t:seed",
                  space=space, budget=1, restarts=1, objective="cost_s",
                  db=db)
    assert out2["trials"][0]["knobs"] == {"x": 8}


def test_a_failed_trial_is_a_non_move(tmp_path, port_param):
    port_param("perfdb", False)
    space = {"x": KnobSpec(name="x", lo=1, hi=8, scale="log2")}

    def fn(k):
        if k["x"] == 4:
            raise RuntimeError("trial failed")
        return float(k["x"])

    out = search(fn, signature="t:fail", space=space, budget=6,
                 restarts=1, objective="cost_s", start={"x": 2},
                 db=TuneDB(str(tmp_path / "t.jsonl")), persist=False)
    assert out["best"] == {"x": 1}
    assert {"x": 4} not in [t["knobs"] for t in out["trials"]]
    assert [f["knobs"] for f in out["failed"]] == [{"x": 4}]
    assert "trial failed" in out["failed"][0]["error"]


def test_trials_run_under_scoped_overrides(tmp_path, port_param):
    """A declared, registered knob is applied for the trial and
    restored after it."""
    port_param("perfdb", False)
    params.register("tune_t_trial", 2, "test")
    params.declare_knob("tune_t_trial", lo=1, hi=16, scale="log2")
    seen = []

    def fn(_k):
        seen.append(params.get("tune_t_trial"))
        return abs(params.get("tune_t_trial") - 8)

    out = search(fn, signature="t:scoped",
                 space=declared_space(["tune_t_trial"]), budget=6,
                 restarts=1, objective="cost_s",
                 db=TuneDB(str(tmp_path / "t.jsonl")), persist=False)
    assert seen[0] == 2 and out["best"] == {"tune_t_trial": 8}
    assert params.get("tune_t_trial") == 2


# ---------------------------------------------------------------------------
# the adaptive controller
# ---------------------------------------------------------------------------

def _trajectory(c, xs):
    return [c.observe(x) for x in xs] + [c.stats()]


@pytest.mark.parametrize("stagger", [0, 3, 61])
def test_controller_follows_the_jax_trajectory(stagger):
    rng = np.random.default_rng(stagger)
    cost = {1: 40.0, 2: 20.0, 4: 10.0, 8: 5.0, 16: 6.0, 32: 9.0}
    noise = rng.uniform(0.9, 1.1, 600)

    def run(cls):
        c = cls("llm_steps_per_pool", 4, 1, 32, probe_every=8,
                probe_len=3, stagger=stagger)
        out = []
        for i in range(600):
            x = cost[c.value] * noise[i]
            if i % 97 == 50:
                x = float("nan")            # a garbage sample now and then
            out.append(c.observe(x))
        return out, c.stats(), c.take_writeback(), c.converged

    assert run(KnobController) == run(jadaptive.KnobController)


def test_steps_controller_is_the_jax_controller():
    p = adaptive.steps_controller("acme", 8)
    j = jadaptive.steps_controller("acme", 8)
    assert (p.name, p.default, p.lo, p.hi, p.better, p._since_probe) == \
        (j.name, j.default, j.lo, j.hi, j.better, j._since_probe)


def _drive(c: KnobController, cost: dict, n: int) -> None:
    for _ in range(n):
        c.observe(cost[c.value])
    while c._probing is not None:
        c.observe(cost[c.value])


def test_controller_probes_and_adopts_better_value():
    c = KnobController("k", default=4, lo=1, hi=16, probe_every=4,
                       probe_len=2)
    cost = {1: 40.0, 2: 20.0, 4: 10.0, 8: 5.0, 16: 2.0}
    _drive(c, cost, 200)
    assert c._incumbent == 16 and c.adoptions >= 2, c.stats()
    assert c.take_writeback() == 16
    assert c.take_writeback() is None       # exactly once per adoption


def test_controller_hysteresis_rejects_noise():
    c = KnobController("k", default=4, lo=1, hi=16, probe_every=4,
                       probe_len=2)
    for i in range(300):
        c.observe(10.0 + 0.5 * (i % 2))
    while c._probing is not None:
        c.observe(10.0)
    assert c.adoptions == 0 and c._incumbent == 4, c.stats()


def test_controller_garbage_objective_falls_back_bounded():
    c = KnobController("k", default=8, lo=1, hi=32, probe_every=4,
                       probe_len=2)
    c.observe(5.0)
    seen = 0
    for x in [float("nan"), float("inf"), -1.0, 0.0] * 4:
        c.observe(x)
        seen += 1
        if c.dead:
            break
    assert c.dead and seen <= GARBAGE_LIMIT, (seen, c.stats())
    assert c.value == 8 and c.observe(123.0) == 8 and c.converged


def test_adaptive_writeback_persists_tenant_vector(tmp_path, port_param):
    path = str(tmp_path / "t.jsonl")
    port_param("tune_db_path", path)
    adaptive.writeback("acme", 16, 3.2)
    rec = TuneDB(path).best(ambient_signature("tenant:acme"),
                            objective="tok_latency_ms")
    assert rec["knobs"] == {"llm_steps_per_pool": 16}
    assert rec["source"] == "adaptive"
    # the JAX package reads the record, under the port's backend
    jrec = JTuneDB(path).best(j_ambient("tenant:acme"),
                              objective="tok_latency_ms",
                              backend=pperfdb.backend_signature())
    assert jrec["knobs"] == {"llm_steps_per_pool": 16}


# ---------------------------------------------------------------------------
# the closed loop (acceptance)
# ---------------------------------------------------------------------------

PROMPTS = [[3, 7, 11], [5, 9, 2, 40]]


def test_closed_loop_decode_search_persist_context_pickup(
        tmp_path, port_param, cpu_cuda_device):
    """Seeded-bad ``llm_steps_per_pool=1`` on a served backlog: the
    search, scored by tokens per pool submit (higher is better, and a
    count, so the trajectory is the same on any load), recovers a deeper
    superpool within 5 trials; the winner lands under the workload's
    signature and the ambient context tag, and a fresh ``Context``
    applies it."""
    path = str(tmp_path / "tunedb.jsonl")
    port_param("tune_db_path", path)
    port_param("perfdb", False)
    port_param("llm_steps_per_pool", 1)     # the seeded-bad vector
    db = TuneDB(path)
    toks = []

    def decode(_knobs):
        with RuntimeServer(nb_cores=2) as srv:
            # a tenant a stream: one pool a tenant an iteration, so the
            # count does not depend on when a stream joins
            ts = [srv.submit_stream(p, max_new_tokens=12, tenant=f"t{i}")
                  for i, p in enumerate(PROMPTS)]
            toks.append([t.result(timeout=120)["tokens"] for t in ts])
            s = srv._llm.stats()
        return {"tokens_per_submit":
                s["tokens_generated"] / s["decode_submits"]}

    out = search(decode, signature="wl:test:decode",
                 space=declared_space(["llm_steps_per_pool"]), budget=5,
                 restarts=1, objective="tokens_per_submit",
                 start={"llm_steps_per_pool": 1}, db=db,
                 ambient_tag="context")
    assert out["evals"] <= 5
    assert out["best"]["llm_steps_per_pool"] >= 2, out
    assert [t["knobs"]["llm_steps_per_pool"] for t in out["trials"]] == \
        [1, 2, 4, 8, 16]
    assert db.best("wl:test:decode", objective="tokens_per_submit") \
        is not None
    # every trial's tokens are the oracle's, whatever its depth
    want = [JMODEL.reference_generate(p, 12) for p in PROMPTS]
    assert all(t == want for t in toks)
    assert params.get("llm_steps_per_pool") == 1   # the override scoped
    ctx = Context(nb_cores=0)
    try:
        assert ctx.tuned_knobs is not None
        assert ctx.tuned_knobs["llm_steps_per_pool"] \
            == out["best"]["llm_steps_per_pool"]
        assert params.get("llm_steps_per_pool") == \
            ctx.tuned_knobs["llm_steps_per_pool"]
    finally:
        ctx.fini()


def test_an_operator_env_value_wins_over_a_stored_one(
        tmp_path, port_param, monkeypatch):
    path = str(tmp_path / "tunedb.jsonl")
    port_param("tune_db_path", path)
    TuneDB(path).note(ambient_signature("context"),
                      {"llm_steps_per_pool": 4}, 1.0)
    p = params.lookup("llm_steps_per_pool")
    saved = (p.value, p.source)
    p.value, p.source = 2, "env"
    try:
        ctx = Context(nb_cores=0)
        ctx.fini()
        assert ctx.tuned_knobs is None
        assert params.get("llm_steps_per_pool") == 2
    finally:
        p.value, p.source = saved


def test_adaptive_oracle_equal_and_server_pickup(tmp_path, port_param,
                                                 cpu_cuda_device):
    """Live adaptation moves batching, never tokens: with the controller
    on, every stream equals the JAX oracle, and the tenant's controller
    starts from the vector the DB held for it."""
    path = str(tmp_path / "tunedb.jsonl")
    port_param("tune_db_path", path)
    prompts = [[3, 7, 11, 5], [1, 40, 8]]

    def run():
        with RuntimeServer(nb_cores=2) as srv:
            ts = [srv.submit_stream(p, max_new_tokens=16, tenant="acme")
                  for p in prompts]
            toks = [t.result(timeout=120)["tokens"] for t in ts]
            return toks, (srv._llm._k_seed.get("acme"),
                          srv._llm._k_ctl.get("acme"), srv._llm.stats())

    port_param("tune_adaptive", False)
    off, (seed0, ctl0, _s) = run()
    assert seed0 is None and ctl0 is None
    TuneDB(path).note(ambient_signature("tenant:acme"),
                      {"llm_steps_per_pool": 2}, 1.0,
                      objective="tok_latency_ms", source="adaptive")
    port_param("tune_adaptive", True)
    on, (seed, ctl, stats) = run()
    assert seed == 2                        # DB -> server -> batcher
    assert ctl is not None and ctl.default == 2 and ctl.value >= 1
    assert stats["adaptive_k"]["acme"]["incumbent"] == ctl._incumbent
    want = [JMODEL.reference_generate(p, 16) for p in prompts]
    assert on == off == want


def test_self_test_cli():
    env = dict(os.environ)
    r = subprocess.run([sys.executable, "-m", "parsec_tpu_torch.tune",
                        "--self-test"], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("tune self-test: ok"), r.stdout


def test_tensor_results_do_not_leak_into_a_score(port_param):
    """A workload returning a tensor scalar is not a score: the search
    falls back to wall seconds (as the JAX search does for arrays)."""
    port_param("perfdb", False)
    out = search(lambda k: torch.tensor(1.0), signature="t:tensor",
                 space={"x": KnobSpec(name="x", lo=1, hi=2)}, budget=1,
                 restarts=1, objective="wall_s", persist=False)
    assert out["evals"] == 1 and out["best_score"] >= 0.0
