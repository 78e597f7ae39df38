"""The port's PP and EP recipes against the JAX package's
(``tests/test_parallel_pp_ep.py``): the pipeline chain PTG across ranks
and the expert routing PTG over ``TwoDimTabular``, on rank threads (in
process, and over the device fabric with CPU devices, as the card runs
them), then the mesh halves, the GPipe rotation and the dense MoE
dispatch, in ONE 4-process gloo launch on the CPU whose results the
cases read.

Tolerances: the pipeline bit for bit (the stages are exact in fp32 on
both sides), the MoE within ``rtol=atol=1e-5`` of ``reference_moe`` and
of the JAX run, the mesh pipeline within ``1e-5`` of the sequential
stages, as in the JAX tests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from parsec_tpu.comm import run_multirank as j_run_multirank
from parsec_tpu.data_dist.matrix import TwoDimBlockCyclic as JTwoDim
from parsec_tpu.data_dist.matrix import TwoDimTabular as JTabular
from parsec_tpu.parallel.expert import make_moe_step as j_make_moe_step
from parsec_tpu.parallel.expert import moe_ptg as j_moe_ptg
from parsec_tpu.parallel.expert import reference_moe as j_reference_moe
from parsec_tpu.parallel.pipeline import make_pipeline_step as j_make_pp
from parsec_tpu.parallel.pipeline import pipeline_ptg as j_pipeline_ptg
from parsec_tpu_torch.comm import run_multiproc, run_multirank
from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic, TwoDimTabular
from parsec_tpu_torch.parallel.expert import moe_ptg, reference_moe
from parsec_tpu_torch.parallel.pipeline import pipeline_ptg

PKG = {"port": (TwoDimBlockCyclic, TwoDimTabular, pipeline_ptg, moe_ptg,
                run_multirank),
       "jax": (JTwoDim, JTabular, j_pipeline_ptg, j_moe_ptg,
               j_run_multirank)}
FABRICS = {"inproc": {}, "device": {"transport": "device"}}


def _value(copy):
    v = copy.value
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _run(pkg, nranks, body, fabric="inproc"):
    kw = dict(FABRICS[fabric])
    if kw:
        kw["devices"] = [torch.device("cpu")] * nranks
    return PKG[pkg][4](nranks, body, timeout=120, **kw)


# ---------------------------------------------------------------------------
# PP: the dataflow core
# ---------------------------------------------------------------------------

def _stage_fns(S):
    """Distinct, non-commuting stages, so an ordering fault shows."""
    return [lambda x, s=s: x * (s + 2) + s for s in range(S)]


def _pp_body(pkg):
    def body(ctx, rank, nranks):
        S, M, nb = 4, 6, 8
        X = PKG[pkg][0]("Xpp", lm=M * nb, ln=1, mb=nb, nb=1, P=1, Q=1,
                        myrank=rank, nodes=nranks,
                        init_fn=lambda m, n, sh:
                        np.full(sh, float(m + 1), np.float32))
        tp = PKG[pkg][2](X, _stage_fns(S), nranks)
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        out = np.stack([_value(X.data_of(m, 0).newest_copy())
                        for m in range(M)]) if rank == 0 else None
        return out, ntasks
    return body


@pytest.mark.parametrize("nranks,fabric", [(1, "inproc"), (4, "inproc"),
                                           (4, "device")])
def test_the_pipeline_ptg_equals_the_jax_pipeline(nranks, fabric):
    port = _run("port", nranks, _pp_body("port"), fabric)
    jax_ = _run("jax", nranks, _pp_body("jax"))
    fns = _stage_fns(4)
    for m in range(6):
        want = np.full((8, 1), float(m + 1), np.float32)
        for f in fns:
            want = f(want)
        np.testing.assert_array_equal(port[0][0][m], want)
    np.testing.assert_array_equal(port[0][0], jax_[0][0])
    assert [r[1] for r in port] == [r[1] for r in jax_]


def test_stage_s_runs_on_rank_s_mod_nranks():
    seen = {}

    def body(ctx, rank, nranks):
        S, M, nb = 4, 2, 4
        fns = [lambda x, s=s: (seen.setdefault((s, rank), True), x)[1]
               for s in range(S)]
        X = TwoDimBlockCyclic("Xsp", lm=M * nb, ln=1, mb=nb, nb=1, P=1,
                              Q=1, myrank=rank, nodes=nranks,
                              init_fn=lambda m, n, sh: np.zeros(sh,
                                                                np.float32))
        ctx.add_taskpool(pipeline_ptg(X, fns, nranks))
        ctx.wait(timeout=120)
        ctx.comm_barrier()

    run_multirank(4, body)
    assert set(seen) == {(s, s % 4) for s in range(4)}


# ---------------------------------------------------------------------------
# EP: the dataflow core over TwoDimTabular
# ---------------------------------------------------------------------------

def _ep_setup(seed=0, B=2, E=4, ntok=16, d=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(B * ntok, d).astype(np.float32)
    wg = rng.randn(d, E).astype(np.float32)
    we = rng.randn(E, d, d).astype(np.float32)
    return x, wg, we


def _ep_body(pkg, B=2, E=4, ntok=16, d=8, table=None, seen=None):
    def body(ctx, rank, nranks):
        x, wg, we = _ep_setup(B=B, E=E, ntok=ntok, d=d)
        Two, Tab = PKG[pkg][0], PKG[pkg][1]
        X = Two.from_dense("Xep", x, ntok, d, P=1, Q=1, myrank=rank,
                           nodes=nranks)
        W = Tab("Wep", lm=E * d, ln=d, mb=d, nb=d,
                rank_table=table or (lambda m, n: m % nranks),
                nodes=nranks, myrank=rank, init_fn=lambda m, n, sh: we[m])
        tp = PKG[pkg][3](X, W, wg, E)
        if seen is not None:
            tc = tp.task_class("EXPERT")
            orig = tc.chores[0].hook

            def spy(es, task):
                seen[(task.locals["e"], rank)] = True
                return orig(es, task)
            tc.chores[0].hook = spy
        ctx.add_taskpool(tp)
        ntasks = tp.nb_local_tasks()
        ctx.wait(timeout=120)
        ctx.comm_barrier()
        out = np.concatenate([_value(X.data_of(b, 0).newest_copy())
                              for b in range(B)]) if rank == 0 else None
        return out, ntasks
    return body


@pytest.mark.parametrize("nranks,fabric", [(1, "inproc"), (4, "inproc"),
                                           (4, "device")])
def test_the_moe_ptg_equals_the_jax_moe(nranks, fabric):
    x, wg, we = _ep_setup()
    port = _run("port", nranks, _ep_body("port"), fabric)
    jax_ = _run("jax", nranks, _ep_body("jax"))
    want = np.concatenate([j_reference_moe(x[b * 16:(b + 1) * 16], wg, we)
                           for b in range(2)])
    np.testing.assert_allclose(
        reference_moe(torch.from_numpy(x), torch.from_numpy(wg),
                      torch.from_numpy(we)).numpy(), want, rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(port[0][0], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port[0][0], jax_[0][0], rtol=1e-5, atol=1e-5)
    assert [r[1] for r in port] == [r[1] for r in jax_]


def test_expert_e_runs_on_its_table_rank():
    seen = {}
    run_multirank(4, _ep_body("port", B=2, E=4, ntok=8, d=4,
                              table=lambda m, n: (m * 2 + 1) % 4,
                              seen=seen))
    assert set(seen) == {(e, (e * 2 + 1) % 4) for e in range(4)}


# ---------------------------------------------------------------------------
# the mesh halves: one 4-process launch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    S, M, nb, d = 4, 6, 2, 8
    rng = np.random.RandomState(0)
    w = rng.randn(S, d, d).astype(np.float32) * 0.3
    xs = rng.randn(M, nb, d).astype(np.float32)
    x, wg, we = _ep_setup(B=1, E=4, ntok=32, d=8)
    path = tmp_path_factory.mktemp("ppep") / "inputs.npz"
    np.savez(path, w=w, xs=xs, x=x, wg=wg, we=we)
    jobs = [{"kind": "pipeline", "mesh": {"pp": 4}, "stages": S,
             "micro": M, "nb": nb, "d": d, "inputs": str(path), "ret": 1},
            {"kind": "moe", "mesh": {"ep": 4}, "tokens": 32, "d": 8,
             "experts": 4, "inputs": str(path), "ret": 1}]
    saved = os.environ.get("PARSEC_PAR_SPEC")
    os.environ["PARSEC_PAR_SPEC"] = json.dumps(jobs)
    try:
        res = run_multiproc(4, "parsec_tpu_torch.parallel.bodies:mesh_body",
                            timeout=240, transport="device",
                            distributed=True, device="cpu")
    finally:
        if saved is None:
            os.environ.pop("PARSEC_PAR_SPEC", None)
        else:
            os.environ["PARSEC_PAR_SPEC"] = saved
    return res, (w, xs, x, wg, we)


def test_the_mesh_pipeline_matches_the_jax_rotation(mesh_runs):
    res, (w, xs, *_rest) = mesh_runs
    run = j_make_pp(JMesh(np.array(jax.devices()[:4]), ("pp",)),
                    lambda wl, x: jnp.tanh(x @ wl), 4, 6)
    jys = np.asarray(run(w, xs))
    want = xs.copy()
    for s in range(4):
        want = np.tanh(want @ w[s])
    for r in res:
        np.testing.assert_allclose(r[0]["out"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[0]["out"], jys, rtol=1e-5, atol=1e-5)


def test_the_mesh_moe_matches_the_jax_dispatch(mesh_runs):
    res, (*_w, x, wg, we) = mesh_runs
    jstep = j_make_moe_step(JMesh(np.array(jax.devices()[:4]), ("ep",)))
    jy = np.asarray(jstep(x, wg, we))
    want = j_reference_moe(x, wg, we)
    for r in res:
        np.testing.assert_allclose(r[1]["out"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[1]["out"], jy, rtol=1e-5, atol=1e-5)
