"""The port stands alone: it imports neither ``jax`` nor ``parsec_tpu``.

Checked two ways: fresh interpreters import ``parsec_tpu_torch`` and run
a 2x2x2-tile GEMM, a served LLM stream, a lowered stencil and GEMM, a
tiled Cholesky (dynamic and lowered), a 2-rank Cholesky over the comm
layer and a chain across 2 rank processes of ``run_multiproc`` (each rank
reports its own), then inspect ``sys.modules``
(subprocesses, because this test process already holds jax through
``conftest.py``); and an AST scan of every module of the package finds
no such import.
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
                "dtd/multirank_check.py"):
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


@pytest.mark.parametrize("rel", PORT_FILES)
def test_module_imports_neither_jax_nor_parsec_tpu(rel):
    bad = [n for n in _imports(REPO / rel) if _forbidden(n)]
    assert bad == [], f"{rel} imports {bad}"


def test_chip_smoke_imports_neither_jax_nor_parsec_tpu():
    bad = [n for n in _imports(REPO / "chip_smoke.py") if _forbidden(n)]
    assert bad == [], bad
