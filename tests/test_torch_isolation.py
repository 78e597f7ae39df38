"""The port stands alone: it imports neither ``jax`` nor ``parsec_tpu``.

Checked two ways: fresh interpreters import ``parsec_tpu_torch`` and run
a 2x2x2-tile GEMM, a served LLM stream, speculative and prefix-cached
streams, a lowered stencil and GEMM, a
tiled Cholesky (dynamic and lowered), a 2-rank Cholesky over the comm
layer, a chain across 2 rank processes of ``run_multiproc`` (each rank
reports its own), the graphcheck CLI with a GEMM under the enqueue
gate and the task profiler, and the tuner's and the perf ledger's
self-tests with two cached lowerings, a sharded two-rank serving plane
and an adaptive stream, the port's ``stencil_1D.jdf`` copy on two rank
threads with a JDF graph check and two rungs of the examples ladder, a
recursive GEMM on the device module around the host and a ring
attention across two gloo rank processes, then inspect ``sys.modules``
(subprocesses, because this test process already holds jax through
``conftest.py``); and an AST scan of every module of the package finds
no such import (the JDF copy's prologue is scanned the same way).
Names match exactly or by dotted prefix: ``parsec_tpu_torch`` itself
starts with the string ``parsec_tpu``.
"""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "parsec_tpu_torch"
FORBIDDEN = ("jax", "parsec_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_name_matching():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("parsec_tpu") and _forbidden("parsec_tpu.ops.gemm")
    assert not _forbidden("parsec_tpu_torch")
    assert not _forbidden("parsec_tpu_torch.ops") and not _forbidden("jaxlib2")


def test_running_a_gemm_loads_no_jax_and_no_parsec_tpu():
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        from parsec_tpu_torch.data_dist.matrix import TiledMatrix
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
        from parsec_tpu_torch.runtime import Context
        dev = init_cuda_devices(device="cpu")[0]
        rng = np.random.default_rng(0)
        a = rng.standard_normal((16, 16), np.float32)
        b = rng.standard_normal((16, 16), np.float32)
        A = TiledMatrix.from_dense("A", a, 8, 8)
        B = TiledMatrix.from_dense("B", b, 8, 8)
        C = TiledMatrix("C", 16, 16, 8, 8)
        ctx = Context(nb_cores=0)
        ctx.add_taskpool(tiled_gemm_ptg(A, B, C))
        ctx.wait(timeout=60)
        ctx.fini(timeout=30)
        ok = bool(np.allclose(C.to_dense(), a @ b, rtol=1e-5, atol=1e-4))
        print(json.dumps({"ok": ok, "tasks": dev.executed_tasks,
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["tasks"] == 8
    assert "parsec_tpu_torch.ops.gemm" in out["modules"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


PORT_FILES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))


def test_the_package_has_the_slice_modules():
    for rel in ("core/params.py", "core/hash_table.py", "core/hbbuffer.py",
                "data/datatype.py", "data/data.py", "data/datarepo.py",
                "data_dist/collection.py", "data_dist/matrix.py",
                "runtime/task.py", "runtime/taskpool.py",
                "runtime/termdet.py", "runtime/deps.py",
                "runtime/scheduling.py", "sched/api.py", "sched/modules.py",
                "runtime/context.py", "ptg/dsl.py", "ptg/lowering.py",
                "device/device.py", "device/kernels.py", "device/hooks.py",
                "device/cuda.py", "ops/gemm.py", "ops/_build.py",
                "models/tiled_gemm.py", "core/future.py",
                "data_dist/paged_kv.py", "ops/ragged_attention.py",
                "llm/model.py", "llm/decode.py", "llm/batcher.py",
                "serve/admission.py", "serve/fair.py", "serve/server.py",
                "ops/stencil.py", "models/stencil.py",
                "models/stencil2d.py", "ops/factor.py", "models/cholesky.py",
                "models/lu.py", "native/__init__.py", "runtime/dagrun.py",
                "dtd/__init__.py", "dtd/insert.py", "dtd/from_ptg.py",
                "core/topology.py", "core/backoff.py", "models/ep.py",
                "comm/__init__.py", "comm/engine.py",
                "comm/device_fabric.py", "comm/remote_dep.py",
                "comm/termdet_fourcounter.py", "comm/multirank.py",
                "comm/collectives.py", "comm/codec.py",
                "comm/socket_fabric.py", "comm/device_socket.py",
                "comm/multiproc.py", "comm/mp_bodies.py",
                "dtd/multirank_check.py", "llm/prefix_tree.py",
                "data_dist/kv_tiers.py", "core/mca.py",
                "analysis/__init__.py", "analysis/graphcheck.py",
                "analysis/__main__.py", "prof/__init__.py", "prof/pins.py",
                "prof/counters.py", "prof/profiling.py",
                "prof/task_profiler.py", "prof/iterators_checker.py",
                "prof/histogram.py", "prof/spans.py", "prof/tracemerge.py",
                "prof/flight_recorder.py", "prof/critpath.py",
                "prof/info.py", "prof/grapher.py", "prof/dotmerge.py",
                "prof/debug_marks.py", "prof/perf_modules.py",
                "prof/dashboard.py", "core/output.py", "prof/perfdb.py",
                "tune/__init__.py", "tune/__main__.py", "tune/signature.py",
                "tune/db.py", "tune/search.py", "tune/adaptive.py",
                "serve/sharded.py", "runtime/recursive.py",
                "models/reduction.py", "models/pingpong.py",
                "models/irregular.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/train.py", "parallel/ring.py",
                "parallel/alltoall.py", "parallel/pipeline.py",
                "parallel/expert.py", "parallel/bodies.py"):
        assert f"parsec_tpu_torch/{rel}" in PORT_FILES, rel
    for src in ("gemm.cu", "ragged_attn.cu", "stencil.cu",
                "native_core.cpp"):
        assert (PORT / "csrc" / src).is_file(), src


def test_serving_a_stream_loads_no_jax_and_no_parsec_tpu():
    code = textwrap.dedent("""
        import json, sys
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.llm import ToyLM
        from parsec_tpu_torch.serve import RuntimeServer
        init_cuda_devices(device="cpu")
        with RuntimeServer(nb_cores=2) as server:
            tk = server.submit_stream([3, 7, 11, 5], max_new_tokens=4)
            toks = tk.result(timeout=60)["tokens"]
        ok = toks == ToyLM().reference_generate([3, 7, 11, 5], 4)
        print(json.dumps({"ok": ok, "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"]
    assert "parsec_tpu_torch.ops.ragged_attention" in out["modules"]
    assert "parsec_tpu_torch.llm.batcher" in out["modules"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_spec_and_prefix_streams_load_no_jax_and_no_parsec_tpu():
    """Speculative decode and the prefix cache: a donor stream, then a
    drafted stream that adopts its prefix, on the device module around the
    host; the tier map rides every batcher."""
    code = textwrap.dedent("""
        import json, sys
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.llm import ToyLM
        from parsec_tpu_torch.serve import RuntimeServer
        init_cuda_devices(device="cpu")
        params.set("llm_spec_k", 4)
        params.set("llm_prefix_cache", True)
        prompt = [5, 9, 13] * 8
        with RuntimeServer(nb_cores=2) as server:
            first = server.submit_stream(prompt, max_new_tokens=3)
            a = first.result(timeout=60)["tokens"]
            b = server.submit_stream(prompt, max_new_tokens=9).result(
                timeout=60)["tokens"]
            llm = server.stats()["llm"]
        m = ToyLM()
        ok = (a == m.reference_generate(prompt, 3)
              and b == m.reference_generate(prompt, 9)
              and llm["spec_submits"] > 0
              and llm["kv"]["prefix_hits"] == 1)
        print(json.dumps({"ok": ok, "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"]
    for mod in ("llm.prefix_tree", "data_dist.kv_tiers", "llm.batcher"):
        assert f"parsec_tpu_torch.{mod}" in out["modules"], mod
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_lowering_loads_no_jax_and_no_parsec_tpu():
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        import torch
        from parsec_tpu_torch.data_dist.matrix import (TiledMatrix,
                                                       VectorTwoDimCyclic)
        from parsec_tpu_torch.models.stencil import (stencil_1d_ptg,
                                                     stencil_reference)
        from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
        from parsec_tpu_torch.ptg.lowering import lower_taskpool
        base = np.random.default_rng(0).standard_normal(64).astype(
            np.float32)
        V = VectorTwoDimCyclic("V", 64, 16,
                               init_fn=lambda m, s: base[m * 16:m * 16 + s])
        w = np.array([0.25, 0.5, 0.25])
        low = lower_taskpool(stencil_1d_ptg(V, w, 3), device="cpu")
        low.execute()
        got = torch.cat([V.data_of(i).newest_copy().value
                         for i in range(4)])
        ok_st = bool(torch.allclose(got.double(),
                                    stencil_reference(base, w, 3),
                                    atol=1e-5))
        a = np.random.default_rng(1).standard_normal((16, 16), np.float32)
        A = TiledMatrix.from_dense("A", a, 8, 8)
        B = TiledMatrix.from_dense("B", a.T.copy(), 8, 8)
        C = TiledMatrix("C", 16, 16, 8, 8)
        glow = lower_taskpool(tiled_gemm_ptg(A, B, C), device="cpu")
        glow.execute()
        ok_mm = bool(np.allclose(C.to_dense(), a @ a.T, atol=1e-4))
        print(json.dumps({"ok": ok_st and ok_mm,
                          "modes": [low.mode, glow.mode],
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["modes"] == ["wavefront", "chain-collapse"]
    assert "parsec_tpu_torch.ops.stencil" in out["modules"]
    assert "parsec_tpu_torch.ptg.lowering" in out["modules"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_a_cholesky_loads_no_jax_and_no_parsec_tpu():
    """A fresh interpreter builds and runs a port Cholesky (the dynamic
    pool on the device module around the host, then the lowered pool)
    with ``jax`` and ``parsec_tpu`` absent from ``sys.modules``."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.models.cholesky import (make_spd,
                                                      tiled_cholesky_ptg)
        from parsec_tpu_torch.ptg.lowering import lower_taskpool
        from parsec_tpu_torch.runtime import Context
        dev = init_cuda_devices(device="cpu")[0]
        a = make_spd(64, seed=0)
        ref = np.linalg.cholesky(a.astype(np.float64))
        A = SymTwoDimBlockCyclic.from_dense("A", a, 16, 16)
        ctx = Context(nb_cores=2)
        ctx.add_taskpool(tiled_cholesky_ptg(A))
        ctx.wait(timeout=60)
        ctx.fini(timeout=30)
        ok = bool(np.allclose(np.tril(A.to_dense()), ref, atol=1e-4))
        B = SymTwoDimBlockCyclic.from_dense("B", a, 16, 16)
        low = lower_taskpool(tiled_cholesky_ptg(B), device="cpu")
        low.execute()
        ok = ok and bool(np.allclose(np.tril(B.to_dense()), ref, atol=1e-4))
        print(json.dumps({"ok": ok, "tasks": dev.executed_tasks,
                          "mode": low.mode, "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["tasks"] == 20 and out["mode"] == "wavefront"
    assert "parsec_tpu_torch.models.cholesky" in out["modules"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_dtd_and_the_compiled_dag_load_no_jax_and_no_parsec_tpu():
    """A fresh interpreter runs a DTD GEMM on the device module around
    the host and drains a compiled EP pool under each of the eleven
    schedulers, with ``jax`` and ``parsec_tpu`` absent from
    ``sys.modules``; the native library it loaded is the port's own
    build from ``parsec_tpu_torch/csrc``."""
    code = textwrap.dedent("""
        import json, sys
        import torch
        from parsec_tpu_torch import native
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.dtd import DTDTaskpool
        from parsec_tpu_torch.models.ep import ep_pool
        from parsec_tpu_torch.models.tiled_gemm import insert_dtd_gemm
        from parsec_tpu_torch.runtime import Context
        dev = init_cuda_devices(device="cpu")[0]
        g = torch.Generator().manual_seed(0)
        A, B = ([[torch.randn(8, 8, generator=g) for _ in range(2)]
                 for _ in range(2)] for _ in range(2))
        C = [[torch.zeros(8, 8) for _ in range(2)] for _ in range(2)]
        ctx = Context(nb_cores=0)
        tp = DTDTaskpool()
        ctx.add_taskpool(tp)
        insert_dtd_gemm(tp, A, B, C)
        tp.data_flush_all()
        tp.wait(timeout=60)
        ctx.fini(timeout=30)
        ok = all(bool(torch.allclose(C[m][n], A[m][0] @ B[0][n]
                                     + A[m][1] @ B[1][n], atol=1e-4))
                 for m in range(2) for n in range(2))
        kinds = []
        for name in ("lfq", "ap", "spq", "ip", "gd", "rnd", "ll", "llp",
                     "pbq", "ltq", "lhq"):
            pool = ep_pool(4, 3).build()
            ctx = Context(nb_cores=2, scheduler=name)
            ctx.add_taskpool(pool)
            kinds.append(type(pool._compiled_dag).__name__)
            ctx.wait(timeout=60)
            ctx.fini(timeout=30)
        print(json.dumps({"ok": ok, "tasks": dev.executed_tasks,
                          "kinds": kinds, "lib": native.loaded_path(),
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["tasks"] == 8
    assert out["kinds"] == ["VecCompiledDag"] * 11
    lib = Path(out["lib"]).resolve().relative_to(REPO)
    assert lib.parts[:3] == ("parsec_tpu_torch", "csrc", "build"), lib
    assert lib.parts[0] != "parsec_tpu"
    assert "parsec_tpu_torch.dtd.insert" in out["modules"]
    assert "parsec_tpu_torch.runtime.dagrun" in out["modules"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_a_multirank_cholesky_loads_no_jax_and_no_parsec_tpu():
    """A fresh interpreter factors a matrix over 2 ranks of the port's
    ``run_multirank`` (device fabric over two CPU devices, the device
    module around the host serving both ranks, every tile by rendezvous
    GET, the four-counter detector), with ``jax`` and ``parsec_tpu`` absent from
    ``sys.modules``."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        from parsec_tpu_torch.comm import run_multirank
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.models.cholesky import (make_spd,
                                                      tiled_cholesky_ptg)
        dev = init_cuda_devices(device="cpu")[0]
        a = make_spd(64, seed=0)
        params.set("termdet", "fourcounter")
        params.set("comm_short_limit", 0)     # every tile by GET

        def body(ctx, rank, nranks):
            A = SymTwoDimBlockCyclic.from_dense("A", a, 16, 16, P=1, Q=2,
                                                myrank=rank)
            ctx.add_taskpool(tiled_cholesky_ptg(A))
            ctx.wait(timeout=60)
            return (A.to_dense(), ctx.comm_engine.ce.bytes_got)

        res = run_multirank(2, body, transport="device",
                            devices=["cpu", "cpu"])
        got = np.tril(sum(r[0] for r in res))
        ok = bool(np.allclose(got, np.linalg.cholesky(
            a.astype(np.float64)), atol=1e-4))
        print(json.dumps({"ok": ok, "tasks": dev.executed_tasks,
                          "moved": all(r[1] > 0 for r in res),
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["tasks"] == 20 and out["moved"]
    assert "parsec_tpu_torch.comm.remote_dep" in out["modules"]
    assert "parsec_tpu_torch.comm.termdet_fourcounter" in out["modules"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_rank_processes_load_no_jax_and_no_parsec_tpu():
    """Every rank process of ``run_multiproc`` runs the chain and reports
    the ``jax`` and ``parsec_tpu`` modules it holds: none."""
    from parsec_tpu_torch.comm import run_multiproc
    res = run_multiproc(2, "parsec_tpu_torch.comm.mp_bodies:isolation_body",
                        timeout=60)
    assert res == [[], []]


def test_the_ast_scan_covers_the_comm_layer():
    comm = [f for f in PORT_FILES if f.startswith("parsec_tpu_torch/comm/")]
    assert len(comm) == 12, comm
    for rel in ("codec", "socket_fabric", "device_socket", "multiproc",
                "mp_bodies"):
        assert f"parsec_tpu_torch/comm/{rel}.py" in comm, rel


def test_the_ast_scan_covers_analysis_and_prof():
    for pkg, n in (("analysis", 6), ("prof", 18), ("tune", 6),
                   ("serve", 5)):
        mods = [f for f in PORT_FILES
                if f.startswith(f"parsec_tpu_torch/{pkg}/")]
        assert len(mods) == n, mods


def test_graphcheck_and_the_task_profiler_load_no_jax_and_no_parsec_tpu():
    """A fresh interpreter imports ``parsec_tpu_torch.analysis`` and
    ``parsec_tpu_torch.prof``, runs the graphcheck CLI and a GEMM under
    the enqueue gate with the task profiler and the SDE module on, and
    writes and reads its trace file."""
    code = textwrap.dedent("""
        import contextlib, io, json, os, sys, tempfile
        import numpy as np
        os.environ["PARSEC_MCA_pins"] = "task_profiler,sde"
        os.environ["PARSEC_MCA_analysis_check"] = "1"
        import parsec_tpu_torch.analysis as an
        import parsec_tpu_torch.prof as prof
        from parsec_tpu_torch.analysis.__main__ import main
        from parsec_tpu_torch.data_dist.matrix import TiledMatrix
        from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
        from parsec_tpu_torch.runtime import Context
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = main(["--nt", "3"])
        a = np.ones((16, 16), np.float32)
        C = TiledMatrix("C", 16, 16, 8, 8)
        ctx = Context(nb_cores=0)
        ctx.add_taskpool(tiled_gemm_ptg(TiledMatrix.from_dense("A", a, 8, 8),
                                        TiledMatrix.from_dense("B", a, 8, 8),
                                        C, devices="cpu"))
        ctx.wait(timeout=60)
        ctx.fini()
        path = os.path.join(tempfile.mkdtemp(), "t.ptpb")
        prof.trace_state.dump(path)
        recs = prof.Profiling.load(path).to_records()
        print(json.dumps({
            "rc": rc, "ok_lines": out.getvalue().count(": OK"),
            "execs": sum(r["name"] == "task_exec" for r in recs),
            "ok": bool(np.allclose(C.to_dense(), a @ a)),
            "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    # 16 graphcheck lines (llm_decode among them), then the self-lint's
    assert out["rc"] == 0 and out["ok_lines"] == 17
    assert out["execs"] == 8 and out["ok"]
    assert "parsec_tpu_torch.analysis.graphcheck" in out["modules"]
    assert "parsec_tpu_torch.prof.task_profiler" in out["modules"]
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


@pytest.mark.parametrize("rel", PORT_FILES)
def test_module_imports_neither_jax_nor_parsec_tpu(rel):
    bad = [n for n in _imports(REPO / rel) if _forbidden(n)]
    assert bad == [], f"{rel} imports {bad}"


def test_chip_smoke_imports_neither_jax_nor_parsec_tpu():
    bad = [n for n in _imports(REPO / "chip_smoke.py") if _forbidden(n)]
    assert bad == [], bad


def test_the_observability_plane_loads_no_jax_and_no_parsec_tpu():
    """A fresh interpreter imports ``parsec_tpu_torch.prof`` whole (every
    submodule by name), runs the tracemerge and critpath self-tests,
    serves two pools with spans on and reads ``metrics()``,
    ``runtime_report()`` and a stall report."""
    code = textwrap.dedent("""
        import contextlib, importlib, io, json, os, pkgutil, sys
        os.environ["PARSEC_MCA_prof_spans"] = "1"
        import parsec_tpu_torch.prof as prof
        names = sorted(m.name for m in pkgutil.iter_modules(prof.__path__))
        for n in names:
            importlib.import_module(f"parsec_tpu_torch.prof.{n}")
        from parsec_tpu_torch import ptg
        from parsec_tpu_torch.prof import critpath, tracemerge
        from parsec_tpu_torch.serve import RuntimeServer
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tracemerge.self_test() + critpath.self_test()
        server = RuntimeServer(nb_cores=1)
        for i in range(2):
            p = ptg.PTGBuilder("iso", N=4)
            t = p.task("T", i=ptg.span(0, lambda g, l: g.N - 1))
            t.body(lambda es, task, g, l: None)
            server.submit(p.build(), tenant=f"t{i}").result(timeout=60)
        m = server.metrics()
        rep = prof.runtime_report()
        stall = prof.flight_recorder.build_stall_report(server.context, "x")
        server.drain(timeout=60)
        print(json.dumps({
            "names": names, "rc": rc,
            "tenants": sorted(m["tenants"]), "critpath": "critpath" in m,
            "blocks": sorted(rep), "sections": len(stall["sections"]),
            "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and len(out["names"]) == 17
    assert out["tenants"] == ["t0", "t1"] and out["critpath"]
    assert {"serve", "slo", "critpath", "knobs"} <= set(out["blocks"])
    assert out["sections"] == 1
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_the_tuner_and_the_sharded_server_load_no_jax_and_no_parsec_tpu():
    """A fresh interpreter imports ``parsec_tpu_torch.tune`` (and its
    lazy halves), runs the tuner's and the perf ledger's self-tests,
    lowers a GEMM twice through the cache, serves two streams across two
    rank threads with the sharded server and one stream with adaptive k,
    all on the host."""
    code = textwrap.dedent("""
        import contextlib, io, json, os, sys, tempfile, threading
        import numpy as np
        d = tempfile.mkdtemp()
        os.environ["PARSEC_MCA_tune_db_path"] = os.path.join(d, "t.jsonl")
        os.environ["PARSEC_MCA_perfdb_path"] = os.path.join(d, "p.jsonl")
        import parsec_tpu_torch.tune as tune
        from parsec_tpu_torch.tune.__main__ import self_test
        from parsec_tpu_torch.prof import perfdb
        from parsec_tpu_torch.comm.multirank import run_multirank
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.data_dist.matrix import TiledMatrix
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
        from parsec_tpu_torch.ptg.lowering import lower_taskpool
        from parsec_tpu_torch.serve import RuntimeServer, ShardedRuntimeServer
        with contextlib.redirect_stdout(io.StringIO()):
            rc = self_test() + perfdb.self_test()
        assert tune.search and tune.KnobController
        a = np.ones((16, 16), np.float32)
        def pool():
            return tiled_gemm_ptg(TiledMatrix.from_dense("A", a, 8, 8),
                                  TiledMatrix.from_dense("B", a, 8, 8),
                                  TiledMatrix("C", 16, 16, 8, 8))
        same = (lower_taskpool(pool(), device="cpu").step_fn
                is lower_taskpool(pool(), device="cpu").step_fn)
        init_cuda_devices(device="cpu")
        bar = threading.Barrier(2)
        def body(ctx, rank, nranks):
            srv = ShardedRuntimeServer(ctx)
            bar.wait()
            if rank == 0:
                try:
                    hs = [srv.submit_stream(p, max_new_tokens=4)
                          for p in ([3, 7, 11], [1, 40])]
                    srv.wait(hs, timeout=60)
                    return [h.result(timeout=1)["tokens"] for h in hs]
                finally:
                    srv.shutdown()
            srv.serve_forever(idle_timeout=60)
            srv.close()
        toks = run_multirank(2, body, nb_cores=1, timeout=120)[0]
        params.set("tune_adaptive", True)
        with RuntimeServer(nb_cores=1) as srv:
            adapted = srv.submit_stream([3, 7, 11],
                                        max_new_tokens=4).result(
                                            timeout=60)["tokens"]
        print(json.dumps({"rc": rc, "same": same, "toks": toks,
                          "adapted": adapted,
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["same"]
    assert len(out["toks"]) == 2 and all(len(t) == 4 for t in out["toks"])
    assert out["adapted"] == out["toks"][0]
    for m in ("parsec_tpu_torch.tune.search", "parsec_tpu_torch.tune.adaptive",
              "parsec_tpu_torch.serve.sharded", "parsec_tpu_torch.prof.perfdb"):
        assert m in out["modules"], m
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_regions_commcheck_and_the_lint_load_no_jax_and_no_parsec_tpu():
    """A fresh interpreter region-lowers and runs a Cholesky, serves one
    stream through region-lowered superpools, warms a workload through
    the CLI entry, runs commcheck's self-test and the ``--comm`` sweep,
    and lints the port's own source, all on the host."""
    code = textwrap.dedent("""
        import contextlib, io, json, sys
        import numpy as np
        from parsec_tpu_torch.analysis import lint_self
        from parsec_tpu_torch.analysis.__main__ import main
        from parsec_tpu_torch.analysis.commcheck import self_test
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.data_dist.matrix import SymTwoDimBlockCyclic
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.models.cholesky import (make_spd,
                                                      tiled_cholesky_ptg)
        from parsec_tpu_torch.ptg import lowering
        from parsec_tpu_torch.serve import RuntimeServer
        a = make_spd(64)
        A = SymTwoDimBlockCyclic.from_dense("A", a.copy(), 16, 16)
        plan = lowering.lower_regions(tiled_cholesky_ptg(A), max_tasks=6,
                                      device="cpu")
        plan.execute()
        err = float(np.abs(np.tril(A.to_dense())
                           - np.linalg.cholesky(a.astype(np.float64))).max())
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = lowering._main(["--warm", "cholesky", "--n", "64", "--nb",
                                 "16", "--modes", "region", "--device",
                                 "cpu"])
            rc += self_test() + main(["--comm", "--nt", "3"])
        init_cuda_devices(device="cpu")
        params.set("llm_lower_regions", True)
        with RuntimeServer(nb_cores=1) as srv:
            toks = srv.submit_stream([3, 7, 11], max_new_tokens=4).result(
                timeout=60)["tokens"]
            regions = srv.stats()["llm"]["regions"]["pools"]
        print(json.dumps({"rc": rc, "err": err, "lint": lint_self().ok,
                          "nreg": len(plan.regions), "toks": toks,
                          "region_pools": regions,
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["lint"] and out["nreg"] > 1
    assert out["err"] < 1e-4 and len(out["toks"]) == 4
    assert out["region_pools"] >= 1
    for m in ("parsec_tpu_torch.analysis.regions",
              "parsec_tpu_torch.analysis.commcheck",
              "parsec_tpu_torch.analysis.runtimelint"):
        assert m in out["modules"], m
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_the_ast_scan_covers_the_jdf_front_ends_reshape_and_examples():
    for rel in ("ptg/jdf.py", "ptg/jdf_c.py", "data/reshape.py",
                "analysis/__main__.py"):
        assert f"parsec_tpu_torch/{rel}" in PORT_FILES, rel
    ladder = sorted(Path(f).stem.split("_")[0] for f in PORT_FILES
                    if f.startswith("parsec_tpu_torch/examples/Ex"))
    assert ladder == [f"Ex{i:02d}" for i in range(13)]


def test_the_port_stencil_jdf_prologue_imports_no_jax_package():
    """The prologue of the port's ``stencil_1D.jdf`` copy is Python the
    JDF front-end executes: its imports are scanned like a module's."""
    import re
    text = (PORT / "examples" / "jdf" / "stencil_1D.jdf").read_text()
    prologues = re.findall(r"%\{(.*?)%\}", text, flags=re.S)
    assert prologues
    names = set()
    for src in prologues:
        for node in ast.walk(ast.parse(textwrap.dedent(src))):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module)
    assert "parsec_tpu_torch.data.datatype" in names
    bad = [n for n in names if _forbidden(n)]
    assert bad == [], bad


def test_the_jdf_stencil_and_the_ladder_load_no_jax_and_no_parsec_tpu():
    """A fresh interpreter loads the port's ``stencil_1D.jdf`` copy, runs
    it on two rank threads, checks a JDF with graphcheck's JDF prong and
    runs Ex02 and Ex04 of the ladder."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        from parsec_tpu_torch import ptg
        from parsec_tpu_torch.analysis import check_jdf
        from parsec_tpu_torch.comm import run_multirank
        from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic
        from parsec_tpu_torch.examples import Ex02_Chain, Ex04_ChainData
        JDF = "parsec_tpu_torch/examples/jdf/stencil_1D.jdf"
        def body(ctx, rank, nranks):
            init = lambda m, n, s: np.ones(s, np.float32) * (m == 0)
            d = TwoDimBlockCyclic("descA", lm=4, ln=32, mb=2, nb=8, P=1,
                                  Q=nranks, myrank=rank, init_fn=init)
            tp = ptg.load_jdf(JDF).build(descA=d, iter=2, R=1,
                                         W=np.array([0.25, 0.5, 0.25]),
                                         LMT=2, LNT=4)
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
            ctx.comm_barrier()
            return tp.nb_local_tasks()
        ntasks = run_multirank(2, body)
        from parsec_tpu_torch.data_dist.collection import DictCollection
        rep = check_jdf(Ex04_ChainData.JDF, NB=3, A=DictCollection("A"))
        print(json.dumps({"ntasks": ntasks, "chain": Ex02_Chain.main(),
                          "data": Ex04_ChainData.main(),
                          "checked": rep.ntasks,
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ntasks"] == [6, 6] and out["chain"] == 10.0
    assert out["data"] == 15.0 and out["checked"] == 3
    for m in ("parsec_tpu_torch.ptg.jdf", "parsec_tpu_torch.data.reshape",
              "parsec_tpu_torch.examples.Ex02_Chain"):
        assert m in out["modules"], m
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_the_recursive_gemm_and_a_gloo_ring_load_no_jax_and_no_parsec_tpu():
    """A fresh interpreter runs the recursive GEMM (nested pools on the
    device module around the host) and ring attention over two gloo rank
    processes; neither it nor the ranks (``isolation_body``) hold jax."""
    code = textwrap.dedent("""
        import json, os, sys
        import numpy as np
        from parsec_tpu_torch.comm import run_multiproc
        from parsec_tpu_torch.data_dist.matrix import TiledMatrix
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.models.tiled_gemm import (
            tiled_gemm_recursive_ptg)
        from parsec_tpu_torch.runtime import Context
        dev = init_cuda_devices(device="cpu")[0]
        rng = np.random.default_rng(0)
        a, b = (rng.standard_normal((16, 16)).astype(np.float32)
                for _ in range(2))
        A, B = (TiledMatrix.from_dense(n, x.copy(), 8, 8)
                for n, x in (("A", a), ("B", b)))
        C = TiledMatrix("C", 16, 16, 8, 8)
        with Context(nb_cores=0) as ctx:
            ctx.add_taskpool(tiled_gemm_recursive_ptg(A, B, C, 4, 4))
            ctx.wait(timeout=60)
        err = float(np.abs(C.to_dense() - a @ b).max())
        os.environ["PARSEC_PAR_SPEC"] = json.dumps([
            {"kind": "ring", "mesh": {"sp": 2}, "shape": [1, 2, 8, 4],
             "causal": True, "seed": 0, "check": 1}])
        ring = run_multiproc(2, "parsec_tpu_torch.parallel.bodies:"
                             "mesh_body", timeout=60, transport="device",
                             distributed=True, device="cpu")
        ranks = run_multiproc(2, "parsec_tpu_torch.comm.mp_bodies:"
                              "isolation_body", timeout=60)
        print(json.dumps({"err": err, "sub": dev.tasks_by_class["GEMM"],
                          "ring": [r[0]["err"] for r in ring],
                          "ranks": ranks, "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["err"] < 1e-4 and out["sub"] == 8 * 8
    assert all(e < 1e-5 for e in out["ring"]) and out["ranks"] == [[], []]
    for m in ("parsec_tpu_torch.runtime.recursive",
              "parsec_tpu_torch.data_dist.matrix"):
        assert m in out["modules"], m
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded


def test_the_ast_scan_covers_the_data_layer_and_the_runtime_round_out():
    for rel in ("data/arena.py", "data/checkpoint.py",
                "data_dist/redistribute.py", "data_dist/operators.py",
                "runtime/vpmap.py", "runtime/taskpool.py", "core/future.py",
                "core/output.py", "llm/decode.py", "data_dist/paged_kv.py"):
        assert f"parsec_tpu_torch/{rel}" in PORT_FILES, rel


def test_checkpoint_redistribute_and_compose_load_no_jax_and_no_parsec_tpu():
    """A redistribution composed with a GEMM on the device module around
    the host, two virtual processes, the operators, a checkpoint saved
    and restored, a one-step decode, an ``"auto"`` upper Cholesky and the
    arenas, with ``jax`` and ``parsec_tpu`` absent from ``sys.modules``."""
    code = textwrap.dedent("""
        import json, os, sys, tempfile
        import numpy as np
        import torch
        os.environ["PARSEC_MCA_runtime_nb_vp"] = "2"
        from parsec_tpu_torch.data.arena import wire_pool
        from parsec_tpu_torch.data.checkpoint import (restore_collections,
                                                      save_collections)
        from parsec_tpu_torch.data_dist.matrix import (
            HashDataDist, SymTwoDimBlockCyclic, TiledMatrix,
            TwoDimBlockCyclic)
        from parsec_tpu_torch.data_dist.operators import (map_taskpool,
                                                          reduce_taskpool)
        from parsec_tpu_torch.data_dist.redistribute import (
            redistribute_taskpool)
        from parsec_tpu_torch.device.cuda import init_cuda_devices
        from parsec_tpu_torch.llm import ToyLM, generate_by_steps
        from parsec_tpu_torch.data.datatype import TileType
        from parsec_tpu_torch.data_dist.collection import DictCollection
        from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
        from parsec_tpu_torch.models import cholesky
        from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
        from parsec_tpu_torch.runtime import Context, compose
        dev = init_cuda_devices(device="cpu")[0]
        rng = np.random.default_rng(0)
        a = rng.standard_normal((16, 16), np.float32)
        b = rng.standard_normal((16, 16), np.float32)
        S = TiledMatrix.from_dense("S", a, 8, 8)
        A = TwoDimBlockCyclic("A", 16, 16, 4, 4)
        B = TiledMatrix.from_dense("B", b, 4, 4)
        C = TiledMatrix("C", 16, 16, 4, 4)
        ctx = Context(nb_cores=2)
        ctx.add_taskpool(compose(redistribute_taskpool(S, A),
                                 tiled_gemm_ptg(A, B, C)))
        ctx.wait(timeout=60)
        out = {}
        ctx.add_taskpool(map_taskpool(C, lambda k, t: t * 2.0))
        ctx.add_taskpool(reduce_taskpool(C, lambda x, y: x + y, out=out,
                                         transform=torch.sum))
        ctx.wait(timeout=60)
        dev.flush_cache()
        vp = ctx.vp_stats()
        ok = bool(np.allclose(C.to_dense(), 2 * (a @ b), rtol=1e-4,
                              atol=1e-4))
        ok = ok and abs(float(out["value"]) - float((2 * (a @ b)).sum())) \\
            < 1e-2
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "ck.npz")
            save_collections(p, C)
            D = TiledMatrix("C", 16, 16, 4, 4)
            restore_collections(p, D)
            ok = ok and bool(np.array_equal(D.to_dense(), C.to_dense()))
        m = ToyLM()
        kv = PagedKVCollection("KV", page_size=4, num_heads=4, head_dim=8)
        Q = DictCollection("Q", dtt=TileType((3, 4, 8)))
        O = DictCollection("O", dtt=TileType((4, 8)))
        def run(tp):
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
        toks = generate_by_steps(m, kv, Q, O, {"s": [3, 7, 11]}, 3, run)
        ok = ok and toks["s"] == m.reference_generate([3, 7, 11], 3)
        spd = cholesky.make_spd(16, seed=1)
        U = SymTwoDimBlockCyclic.from_dense("U", spd, 8, 8, uplo=1)
        ctx.add_taskpool(cholesky.tiled_cholesky_ptg(U, devices="auto"))
        ctx.wait(timeout=60)
        dev.flush_cache()
        ctx.fini(timeout=30)
        want = np.linalg.cholesky(spd.astype(np.float64)).T
        ok = ok and bool(np.allclose(np.triu(U.to_dense()), want,
                                     atol=1e-4))
        HashDataDist("H").register((0,), np.zeros(2))
        print(json.dumps({"ok": ok, "vp": vp, "pool": wire_pool.stats(),
                          "modules": sorted(sys.modules)}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"], out
    assert out["vp"]["nb_vp"] == 2 and out["vp"]["cross_vp"] == 0
    for mod in ("parsec_tpu_torch.data.checkpoint",
                "parsec_tpu_torch.data_dist.redistribute",
                "parsec_tpu_torch.data_dist.operators",
                "parsec_tpu_torch.runtime.vpmap",
                "parsec_tpu_torch.data.arena"):
        assert mod in out["modules"], mod
    loaded = [m for m in out["modules"] if _forbidden(m)]
    assert loaded == [], loaded
