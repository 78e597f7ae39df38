"""The port stands alone: it imports neither ``jax`` nor ``parsec_tpu``.

Checked two ways: a fresh interpreter imports ``parsec_tpu_torch`` and
runs a 2x2x2-tile GEMM, then inspects ``sys.modules`` (a subprocess,
because this test process already holds jax through ``conftest.py``);
and an AST scan of every module of the package finds no such import.
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
                "models/tiled_gemm.py"):
        assert f"parsec_tpu_torch/{rel}" in PORT_FILES, rel
    assert (PORT / "csrc" / "gemm.cu").is_file()


@pytest.mark.parametrize("rel", PORT_FILES)
def test_module_imports_neither_jax_nor_parsec_tpu(rel):
    bad = [n for n in _imports(REPO / rel) if _forbidden(n)]
    assert bad == [], f"{rel} imports {bad}"


def test_chip_smoke_imports_neither_jax_nor_parsec_tpu():
    bad = [n for n in _imports(REPO / "chip_smoke.py") if _forbidden(n)]
    assert bad == [], bad
