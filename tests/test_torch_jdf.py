"""The port's JDF front-end against the JAX package's, on every JDF text
of ``tests/test_jdf.py``.

The texts are read out of that file's source (every string literal that
holds a ``BODY``), so a case added there is held here too.  For each:
both packages' ``parse_jdf`` either raise the same ``JDFError`` message
or parse, and ``unparse_jdf`` gives the same text; ``build`` with the
same bindings either raises the same message or builds; the built pools
give graphcheck the same task and edge counts and findings, and run to
the same tiles, sinks and counters (``rtol=atol=1e-5``).  The inputs are
numpy arrays made from a seed, handed to each package's collections.

A GEMM JDF with a ``BODY [type = cuda dyld = gemm]`` ahead of its Python
body runs through ``init_cuda_devices(device="cpu")``'s device module:
the device counts every task and the Python chore runs none; without a
``cuda`` device the same text falls through to the Python body.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from parsec_tpu import ptg as jptg
from parsec_tpu.analysis import check_ptg as j_check_ptg
from parsec_tpu.data.data import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiled
from parsec_tpu.data_dist.matrix import VectorTwoDimCyclic as JVector
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch import ptg
from parsec_tpu_torch.analysis import check_ptg
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.matrix import TiledMatrix, VectorTwoDimCyclic
from parsec_tpu_torch.runtime import Context

SRC = pathlib.Path(__file__).resolve().parent / "test_jdf.py"


def _texts():
    tree = ast.parse(SRC.read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "BODY" in node.value and "\n" in node.value:
            out.append(node.value)
    return out


TEXTS = _texts()

_INTS = {"NT": 4, "DEPTH": 3, "N": 8, "NB": 3, "BODY_SIZE": 1}
_GEMM_N, _GEMM_NB = 48, 16


def _gemm_inputs():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((_GEMM_N, _GEMM_N)).astype(np.float32)
    b = rng.standard_normal((_GEMM_N, _GEMM_N)).astype(np.float32)
    return a, b


def _bindings(jdf, port):
    """The same bindings for both packages: each package's collections
    over the same numpy values."""
    gemm = "GEMM" in jdf.tasks
    out = {}
    for name, props in jdf.globals_decl.items():
        if "default" in props:
            continue
        kind = props.get("type")
        if gemm and name in "ABC":
            a, b = _gemm_inputs()
            dense = {"A": a, "B": b,
                     "C": np.zeros((_GEMM_N, _GEMM_N), np.float32)}[name]
            out[name] = (TiledMatrix if port else JTiled).from_dense(
                name, dense, _GEMM_NB, _GEMM_NB)
        elif gemm and name in ("MT", "NT", "KT"):
            out[name] = _GEMM_N // _GEMM_NB
        elif kind == "data" and name == "A":
            out[name] = (DictCollection if port else JDict)(
                "A", dtt=(TileType((1,), torch.float32) if port
                          else JTileType((1,), np.float32)),
                init_fn=lambda *k: np.zeros(1, np.float32))
        elif kind == "data":
            out[name] = (VectorTwoDimCyclic if port else JVector)(
                name, lm=8, mb=2, init_fn=lambda m, size: np.zeros(size))
        elif name == "SINK":
            out[name] = []
        elif name == "T1":
            out[name] = (TileType((1,), torch.float32) if port
                         else JTileType((1,), np.float32))
        else:
            out[name] = _INTS.get(name, 4)
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:     # the message is the comparison
        return (type(e).__name__, str(e))


def _snapshot(bind):
    """Every tile of every collection, and every sink."""
    snap = {}
    for name, v in bind.items():
        if isinstance(v, list):
            snap[name] = list(v)
        elif hasattr(v, "to_dense"):
            snap[name] = np.asarray(v.to_dense(), np.float64)
        elif hasattr(v, "mt"):
            snap[name] = np.concatenate([
                np.asarray(v.data_of(i).newest_copy().value, np.float64)
                for i in range(v.mt)])
        elif hasattr(v, "data_of"):
            snap[name] = np.asarray(v.data_of(0).newest_copy().value,
                                    np.float64)
    return snap


def _findings(report):
    return sorted((f.code, f.severity, f.task_class or "", f.flow or "")
                  for f in report.findings)


@pytest.mark.parametrize("text", TEXTS,
                         ids=[f"jdf{i}" for i in range(len(TEXTS))])
def test_jdf_text_matches_the_jax_package(text):
    p = _outcome(lambda: ptg.parse_jdf(text, "t"))
    j = _outcome(lambda: jptg.parse_jdf(text, "t"))
    assert p[0] == j[0]
    if p[0] != "ok":
        assert p == j and p[0] == "JDFError"
        return
    pj, jj = p[1], j[1]
    # (a text with a parameter lacking its range unparses to neither)
    assert _outcome(lambda: ptg.unparse_jdf(pj)) == \
        _outcome(lambda: jptg.unparse_jdf(jj))
    pbind, jbind = _bindings(pj, True), _bindings(jj, False)
    pb = _outcome(lambda: pj.build(**pbind))
    jb = _outcome(lambda: jj.build(**jbind))
    assert pb[0] == jb[0]
    if pb[0] != "ok":
        assert pb == jb and pb[0] == "JDFError"
        return
    tp, jtp = pb[1], jb[1]
    rep, jrep = check_ptg(tp), j_check_ptg(jtp)
    assert (rep.ntasks, rep.nedges) == (jrep.ntasks, jrep.nedges)
    assert _findings(rep) == _findings(jrep)
    tp.counter = jtp.counter = 0
    for ctx_cls, pool in ((Context, tp), (JContext, jtp)):
        ctx = ctx_cls(nb_cores=0)
        try:
            ctx.add_taskpool(pool)
            ctx.wait(timeout=60)
        finally:
            ctx.fini()
    assert tp.counter == jtp.counter
    got, want = _snapshot(pbind), _snapshot(jbind)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], list):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_every_text_was_found():
    """The harvest covers the file's module texts and its inline ones."""
    assert len(TEXTS) >= 20
    names = {t.split("(")[0].split()[-1] for t in TEXTS if "(" in t}
    assert {"GEMM", "EP", "T", "Task"} <= names


def _gemm_cuda_text():
    import test_jdf
    return test_jdf.GEMM_JDF.replace(
        "BODY\n", "BODY [type = cuda dyld = gemm]\nEND\nBODY\n", 1)


def _gemm_pool(text, port):
    a, b = _gemm_inputs()
    cls = TiledMatrix if port else JTiled
    dA = cls.from_dense("A", a, _GEMM_NB, _GEMM_NB)
    dB = cls.from_dense("B", b, _GEMM_NB, _GEMM_NB)
    dC = cls.from_dense("C", np.zeros_like(a), _GEMM_NB, _GEMM_NB)
    nt = _GEMM_N // _GEMM_NB
    tp = (ptg if port else jptg).parse_jdf(text, "gemm").build(
        A=dA, B=dB, C=dC, MT=nt, NT=nt, KT=nt)
    return tp, dC, a @ b


def _count_cpu_chore(tp):
    ran = []
    tc = tp.task_class("GEMM")
    ch = next(c for c in tc.chores if c.device_type == "cpu")
    inner = ch.hook

    def hook(es, task):
        ran.append(task.key)
        return inner(es, task)
    ch.hook = hook
    return ran


@pytest.fixture
def cpu_cuda_device():
    """The device module around the host, registered for the test and
    unregistered after (other files count its tasks from zero)."""
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    snapshot = list(registry.devices)
    yield init_cuda_devices(device="cpu")[0]
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def test_cuda_body_runs_every_task_on_the_device_module(cpu_cuda_device):
    import parsec_tpu_torch.ops.gemm  # noqa: F401 (registers "gemm")
    text = _gemm_cuda_text()
    jdf = ptg.parse_jdf(text, "gemm")
    assert [p.get("type", "python") for p, _ in jdf.tasks["GEMM"].bodies] \
        == ["cuda", "python"]
    tp, dC, want = _gemm_pool(text, True)
    assert [c.device_type for c in tp.task_class("GEMM").chores] == \
        ["cuda", "cpu"]
    ran = _count_cpu_chore(tp)
    dev = cpu_cuda_device
    before = dev.executed_tasks
    ctx = Context(nb_cores=2)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        dev.sync()
        dev.flush_cache()
    finally:
        ctx.fini()
    ntasks = (_GEMM_N // _GEMM_NB) ** 3
    assert dev.executed_tasks - before == ntasks and not ran
    np.testing.assert_allclose(dC.to_dense(), want, rtol=1e-4, atol=1e-4)
    jtp, jdC, _ = _gemm_pool(text.replace("type = cuda", "type = tpu"),
                             False)
    with JContext(nb_cores=2) as jctx:
        jctx.add_taskpool(jtp)
        jctx.wait(timeout=60)
    np.testing.assert_allclose(dC.to_dense(), jdC.to_dense(), rtol=1e-5,
                               atol=1e-5)


def test_a_device_type_with_no_device_falls_through_to_python():
    """A chore whose device type has no registered device passes the task
    on (the reference's incarnation rule): every task runs the Python
    body, visibly in its count."""
    text = _gemm_cuda_text().replace("type = cuda", "type = tpu")
    tp, dC, want = _gemm_pool(text, True)
    ran = _count_cpu_chore(tp)
    with Context(nb_cores=2) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    assert len(ran) == (_GEMM_N // _GEMM_NB) ** 3
    np.testing.assert_allclose(dC.to_dense(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("binds", [["NT=4", "DEPTH=3", "V=0"],
                                   ["NT=2", "DEPTH=5", "V=0"]])
def test_the_cli_checks_a_jdf_file_like_the_jax_cli(tmp_path, binds,
                                                    capsys):
    """``python -m parsec_tpu_torch.analysis --graph x.jdf --bind
    NAME=INT``: the same summary line and exit code as the JAX CLI."""
    import test_jdf
    from parsec_tpu.analysis.__main__ import main as jmain
    from parsec_tpu_torch.analysis.__main__ import main
    path = tmp_path / "ep.jdf"
    path.write_text(test_jdf.EP_JDF.replace("  : V(n)\n", ""))
    argv = ["--graph", str(path)] + [a for b in binds for a in ("--bind", b)]
    rc = main(argv)
    out = capsys.readouterr().out
    jrc = jmain(argv)
    jout = capsys.readouterr().out
    assert (rc, out) == (jrc, jout)
    assert rc == 0 and ": OK" in out
    from parsec_tpu_torch.analysis import check_jdf
    rep = check_jdf(str(path), **{k: int(v) for k, v in
                                  (b.split("=") for b in binds)})
    nt, depth = int(binds[0][3:]), int(binds[1][6:])
    assert rep.ntasks == nt * depth and rep.nedges == nt * (depth - 1)


def test_chip_smoke_runs_this_gemm_text():
    """``chip_smoke.py``'s ``jdf_gemm`` phase builds its pool from
    ``GEMM_JDF`` with the CUDA body ahead of the Python one."""
    import ast as ast_
    src = (SRC.parent.parent / "chip_smoke.py").read_text()
    text = next(n.value.value for n in ast_.parse(src).body
                if isinstance(n, ast_.Assign)
                and getattr(n.targets[0], "id", None) == "JDF_GEMM")
    assert text == _gemm_cuda_text()
