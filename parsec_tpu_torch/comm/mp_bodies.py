"""Rank bodies for :func:`~parsec_tpu_torch.comm.multiproc.run_multiproc`.

Port of the bodies of ``tests/mp_bodies.py``, kept in the package so a
rank process imports them as ``"parsec_tpu_torch.comm.mp_bodies:fn"``
(a rank must never import a test file: those import ``jax``).  The port's
tests and ``chip_smoke.py`` share them, as the JAX package's tests and
its multichip dry run share ``dtd/multirank_check.py``.

Each body has the ``fn(ctx, rank, nranks)`` signature and returns host
values.  Sizes and choices reach :func:`pool_body` through the
environment, which every rank inherits from the launcher
(``PARSEC_MP_KINDS``, ``PARSEC_MP_N``, ``PARSEC_MP_NB``,
``PARSEC_MP_SEED``, ``PARSEC_MP_CHORES``, ``PARSEC_MP_WARMUP``,
``PARSEC_MP_TRACE_DIR``).  With ``PARSEC_MP_TRACE_DIR`` set (and the
span recorder on, ``prof_spans``, which ``run_multiproc`` forwards), the
timed run of each kind carries one trace on every rank, and each rank
writes its spans as a Chrome trace, ``trace-<kind>-rank<r>.json``, to
that directory for :mod:`parsec_tpu_torch.prof.tracemerge`.
"""

from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np


def foreign_modules() -> list[str]:
    """The names in ``sys.modules`` of ``jax`` and of the JAX package
    (each exactly, or as a dotted prefix): the port's ranks hold none."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "parsec_tpu")
                  or m.startswith(("jax.", "parsec_tpu.")))


def isolation_body(ctx, rank, nranks):
    """The chain, then this rank's :func:`foreign_modules`."""
    chain_body(ctx, rank, nranks)
    return foreign_modules()


def hang_body(ctx, rank, nranks):
    """Never returns (the launcher's deadline must end it)."""
    while True:
        time.sleep(1.0)


def _grid(nranks: int) -> tuple[int, int]:
    P = 2 if nranks % 2 == 0 else 1
    return P, nranks // P


def chain_body(ctx, rank, nranks):
    """A tile hops rank to rank across processes: task ``i`` runs on rank
    ``i % nranks`` and increments it; rank 0 returns the final value."""
    from .. import ptg
    from ..data_dist.matrix import VectorTwoDimCyclic

    NB = 2 * nranks
    V = VectorTwoDimCyclic("V", lm=NB, mb=4, P=nranks, myrank=rank,
                           init_fn=lambda m, size: np.zeros(size, np.float32))
    p = ptg.PTGBuilder("chain", V=V, NB=NB)
    t = p.task("T", i=ptg.span(0, lambda g, l: g.NB - 1))
    t.affinity("V", lambda g, l: (l.i,))
    f = t.flow("A", ptg.RW)
    f.input(data=("V", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "A", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "A", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.NB - 1)
    f.output(data=("V", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.NB - 1)

    @t.body
    def body(es, task, g, l):
        a = task.flow_data("A")
        a.value = a.value + 1

    ctx.add_taskpool(p.build())
    ctx.wait(timeout=60)
    ctx.comm_barrier()
    if rank == 0:
        return float(V.data_of(0).newest_copy().value[0])
    return None


def traced_chain_body(ctx, rank, nranks):
    """:func:`chain_body` on the dynamic scheduler with the task profiler
    and the grapher on: each rank writes its own binary trace
    ``rank<r>.prof`` and DOT fragment ``rank<r>.dot`` to
    ``PARSEC_MP_TRACE_DIR`` (the per-rank inputs of ``prof.info`` and
    ``prof.dotmerge``)."""
    from ..core.mca import repository
    from ..core.params import params
    from ..prof.profiling import profiling

    out_dir = os.environ["PARSEC_MP_TRACE_DIR"]
    old = params.get("runtime_dag_compile")
    params.set("runtime_dag_compile", False)
    profiling.init()
    prof_comp = repository.find("pins", "task_profiler")
    prof_mod = prof_comp.open()
    graph_comp = repository.find("pins", "grapher")
    graph_mod = graph_comp.open()
    try:
        chain_body(ctx, rank, nranks)
    finally:
        params.set("runtime_dag_compile", old)
        graph_mod.write_dot(os.path.join(out_dir, f"rank{rank}.dot"))
        graph_comp.close(graph_mod)
        profiling.dump(os.path.join(out_dir, f"rank{rank}.prof"))
        prof_comp.close(prof_mod)
        profiling.fini()
    return True


def _small_gemm(ctx, rank, nranks) -> np.ndarray:
    """The 2-D block-cyclic GEMM of the JAX package's bodies (n=64,
    nb=16, seed 23) on host chores; this rank's tiles of C."""
    from ..data_dist.matrix import TwoDimBlockCyclic
    from ..models.tiled_gemm import tiled_gemm_ptg

    n, nb = 64, 16
    rng = np.random.RandomState(23)
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    P, Q = _grid(nranks)
    A = TwoDimBlockCyclic.from_dense("A", a, nb, nb, P=P, Q=Q, myrank=rank)
    B = TwoDimBlockCyclic.from_dense("B", b, nb, nb, P=P, Q=Q, myrank=rank)
    C = TwoDimBlockCyclic("C", n, n, nb, nb, P=P, Q=Q, myrank=rank)
    ctx.add_taskpool(tiled_gemm_ptg(A, B, C, devices="cpu"))
    ctx.wait(timeout=120)
    ctx.comm_barrier()
    return C.to_dense()


def gemm_body(ctx, rank, nranks):
    """Block-cyclic GEMM with remote deps over the socket fabric."""
    return _small_gemm(ctx, rank, nranks)


def device_bcast_gemm_body(ctx, rank, nranks):
    """Over the device socket tier: a broadcast of a 4096-float tile (past
    the short limit, so a rendezvous GET) from rank 0 to every rank, then
    the block-cyclic GEMM; returns the broadcast sum, this rank's C tiles
    and its bytes by tier."""
    import torch

    from .. import ptg
    from ..data.data import data_create
    from ..data_dist.matrix import VectorTwoDimCyclic
    from .device_socket import DeviceSocketCommEngine

    ce = ctx.comm_engine.ce
    if not isinstance(ce, DeviceSocketCommEngine):
        raise TypeError(f"rank {rank} runs {type(ce).__name__}, not the "
                        f"device socket engine")
    V = VectorTwoDimCyclic("V", lm=nranks, mb=1, P=nranks, myrank=rank,
                           init_fn=lambda m, size: np.zeros(size))
    p = ptg.PTGBuilder("bcast", V=V, NR=nranks)
    w = p.task("W", z=ptg.span(0, 0))
    w.affinity("V", lambda g, l: (0,))
    fw = w.flow("A", ptg.WRITE)
    for r in range(nranks):
        fw.output(succ=("R", "X", lambda g, l, r=r: {"r": r}))

    def wbody(es, task, g, l):
        arr = torch.arange(4096, dtype=torch.float32)   # > comm_short_limit
        task.set_flow_data("A", data_create(arr, key=("w", 0)).get_copy(0))

    w.body(wbody)
    t = p.task("R", r=ptg.span(0, lambda g, l: g.NR - 1))
    t.affinity("V", lambda g, l: (l.r,))
    fx = t.flow("X", ptg.READ)
    fx.input(pred=("W", "A", lambda g, l: {"z": 0}))
    fy = t.flow("Y", ptg.RW)
    fy.input(data=("V", lambda g, l: (l.r,)))
    fy.output(data=("V", lambda g, l: (l.r,)))

    def rbody(es, task, g, l):
        y = task.flow_data("Y")
        x = task.flow_data("X").value
        y.value = y.value.new_full(y.value.shape, float(x.sum()))

    t.body(rbody)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=90)
    ctx.comm_barrier()
    bsum = float(V.data_of(rank).newest_copy().value[0])
    return {"bsum": bsum, "C": _small_gemm(ctx, rank, nranks),
            "tiers": ce.tier_bytes()}


def _check_group(rank: int, nranks: int) -> None:
    """The process group this rank joined spans the ranks, in order."""
    import torch.distributed as dist
    got = (dist.get_rank(), dist.get_world_size()) \
        if dist.is_initialized() else None
    if got != (rank, nranks):
        raise RuntimeError(f"rank {rank}: process group (rank, size) "
                           f"{got}, expected {(rank, nranks)}")


def distributed_bootstrap_body(ctx, rank, nranks):
    """The process-group bootstrap exercised: the launcher set the
    coordinator, so the rank joined a gloo group before its runtime
    started; the group must span the ranks.  Then the device-tier
    broadcast and GEMM ride on top."""
    import torch.distributed as dist
    _check_group(rank, nranks)
    out = device_bcast_gemm_body(ctx, rank, nranks)
    out["world_size"] = dist.get_world_size()
    return out


# ---------------------------------------------------------------------------
# GEMM, Cholesky and LU at a size the environment gives
# ---------------------------------------------------------------------------

def gemm_tile(seed: int, tag: int, m: int, k: int,
              shape: tuple) -> np.ndarray:
    """Tile (m, k) of GEMM operand ``tag`` (1: A, 2: B), from its own
    seed, so any rank makes the tiles it reads alone."""
    rng = np.random.default_rng((seed, tag, m, k))
    return rng.standard_normal(shape, dtype=np.float32)


def gemm_dense(n: int, nb: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The whole A and B of :func:`gemm_tile`."""
    nt = n // nb
    return tuple(np.block([[gemm_tile(seed, tag, i, j, (nb, nb))
                            for j in range(nt)] for i in range(nt)])
                 for tag in (1, 2))


def factor_input(kind: str, n: int) -> np.ndarray:
    """The factorizations' input: ``make_spd_fast(n)`` for Cholesky,
    ``make_dd(n, seed=1)`` for LU."""
    from ..models.cholesky import make_spd_fast
    from ..models.lu import make_dd
    return make_spd_fast(n) if kind == "cholesky" else make_dd(n, seed=1)


def _rank_matrices(kind: str, n: int, nb: int, seed: int, rank: int,
                   nranks: int) -> tuple:
    """This rank's collections of ``kind`` with the tiles it touches made
    (set-up, off the clock)."""
    from ..data_dist.collection import enumerate_keys
    from ..data_dist.matrix import SymTwoDimBlockCyclic, TwoDimBlockCyclic
    P, Q = _grid(nranks)
    kw = dict(P=P, Q=Q, myrank=rank)
    nt = n // nb
    if kind == "gemm":
        A, B = (TwoDimBlockCyclic(
            x, n, n, nb, nb,
            init_fn=lambda m, k, shape, tag=tag: gemm_tile(seed, tag, m, k,
                                                           shape), **kw)
            for x, tag in (("A", 1), ("B", 2)))
        C = TwoDimBlockCyclic("C", n, n, nb, nb, **kw)
        for i in range(nt):
            for j in range(nt):
                if C.is_local(i, j):
                    C.data_of(i, j)
                    for k in range(nt):
                        A.data_of(i, k)
                        B.data_of(k, j)
        return A, B, C
    cls = SymTwoDimBlockCyclic if kind == "cholesky" else TwoDimBlockCyclic
    A = cls.from_dense("A", factor_input(kind, n), nb, nb, **kw)
    for key in enumerate_keys(A):
        if A.is_local(*key):
            A.data_of(*key)
    return (A,)


_KINDS = ("gemm", "cholesky", "lu")


def _pool(kind: str, mats: tuple, chores: str):
    from ..models.cholesky import tiled_cholesky_ptg
    from ..models.lu import tiled_lu_ptg
    from ..models.tiled_gemm import tiled_gemm_ptg
    build = {"gemm": tiled_gemm_ptg, "cholesky": tiled_cholesky_ptg,
             "lu": tiled_lu_ptg}[kind]
    return build(*mats, devices=chores)


def _k1_zero() -> None:
    """Zero this rank's K1 launch counts: what follows is a path's own."""
    from ..ops import gemm as tg
    tg.gemm_update.launches = 0
    tg.gemm_update.launches_by_variant = dict.fromkeys(tg.K1_VARIANTS, 0)
    tg.gemm_update.launches_by_form = {}


def _k1_counts() -> dict:
    """This rank's K1 launch counts since :func:`_k1_zero` (variants that
    did not launch left out)."""
    from ..ops import gemm as tg
    g = tg.gemm_update
    return dict(k1=g.launches,
                k1_by_variant={k: v for k, v in g.launches_by_variant.items()
                               if v},
                k1_by_form=dict(g.launches_by_form))


def _counters(ctx, dev) -> dict:
    """The counters a run is measured by (K1's aside), as they stand."""
    from ..device import registry
    eng = ctx.comm_engine
    ce = eng.ce
    out = dict(gets=ce.gets, frags_in=ce.frags_in,
               payload_bytes_received=eng.payload_bytes_received,
               cpu_tasks=registry.get(0).executed_tasks)
    if hasattr(ce, "tier_bytes"):
        out["tiers"] = ce.tier_bytes()
        out["tier_s"] = ce.tier_seconds()
    if dev is not None:
        out["dev"] = dev.stats()
    return out


def _diff(after: dict, before: dict) -> dict:
    """``after - before`` key by key (nested dicts too; zeros dropped from
    the per-key tallies)."""
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, dict):
            d = _diff(v, b or {})
            out[k] = {x: y for x, y in d.items() if y} \
                if k.endswith(("by_variant", "by_form", "by_class")) else d
        elif isinstance(v, (int, float)):
            out[k] = v - (b or 0)
    return out


# the trace every rank's traced pool of a kind carries (rank-agreed by
# construction, as a served request's is by the wire)
_TRACE_BASE = 0xC0DE0000


def _run_kind(ctx, rank: int, nranks: int, kind: str, n: int, nb: int,
              seed: int, chores: str, dev, trace_dir: str | None = None
              ) -> dict:
    """One run of ``kind``'s pool: the ranks meet at a barrier, stamp
    ``time.monotonic()`` (one clock for every process on a host) before
    ``add_taskpool`` and after ``wait`` (the card synchronized), and
    report their counters' change, the K1 launches counted from 0 at
    ``add_taskpool`` to ``wait``'s return, and their own tiles of the
    result.  With ``trace_dir`` the pool is traced, the recorder's
    earlier spans are dropped at the barrier, and the run's spans are
    written after the closing barrier (their count by name in
    ``spans``)."""
    from ..core.params import params
    from ..data_dist.collection import enumerate_keys
    from ..prof import spans
    params.set("termdet", "fourcounter" if kind == "cholesky" else "")
    try:
        mats = _rank_matrices(kind, n, nb, seed, rank, nranks)
        tp = _pool(kind, mats, chores)
        if trace_dir is not None:
            if spans.recorder is None:
                raise RuntimeError("PARSEC_MP_TRACE_DIR is set but the span "
                                   "recorder is off (prof_spans)")
            tp._trace = spans.TraceContext(
                _TRACE_BASE + _KINDS.index(kind))
        before = _counters(ctx, dev)
        ctx.comm_barrier()
        if trace_dir is not None:
            del spans.recorder.spans[:]
        _k1_zero()
        t_add = time.monotonic()
        ctx.add_taskpool(tp)
        ctx.wait(timeout=float(os.environ.get("PARSEC_MP_TIMEOUT", 600)))
        if dev is not None and dev.is_cuda:
            import torch
            torch.cuda.synchronize()
        t_wait = time.monotonic()
        k1 = _k1_counts()
        ctx.comm_barrier()
        if dev is not None:
            dev.flush_cache()
        rec = _diff(_counters(ctx, dev), before)
        rec.update(k1)
        out = mats[-1]
        if trace_dir is not None:
            spans.export_chrome(os.path.join(
                trace_dir, f"trace-{kind}-rank{rank}.json"), rank=rank)
            names: dict[str, int] = {}
            for sp in spans.recorder.spans:
                names[sp[0]] = names.get(sp[0], 0) + 1
            rec["spans"] = names
            rec["spans_dropped"] = spans.recorder.dropped
        rec.update(tasks=tp.nb_local_tasks(), termdet=tp.tdm.name,
                   t_add=t_add, t_wait=t_wait,
                   tiles={k: out.data_of(*k).newest_copy().value.cpu()
                          .numpy() for k in enumerate_keys(out)
                          if out.is_local(*k)})
        return rec
    finally:
        params.set("termdet", "")


def _run_dtd(ctx, rank: int, nranks: int, n: int, nb: int, seed: int,
             chores: str, dev) -> dict:
    """The DTD GEMM of :mod:`parsec_tpu_torch.dtd.multirank_check` on
    :func:`gemm_dense`'s operands (on K1 with device chores): this rank's
    counters' change, its tasks, the pushes it received and its C
    (``to_dense``), with the K1 launches counted from 0 at the barrier
    before the insertions."""
    from ..dtd.multirank_check import dtd_gemm_rank_body
    a, b = gemm_dense(n, nb, seed)
    before = _counters(ctx, dev)
    ctx.comm_barrier()
    _k1_zero()
    out = dtd_gemm_rank_body(
        a, b, nb, *_grid(nranks),
        cuda_kernel="gemm" if chores == "cuda" else None)(ctx, rank, nranks)
    rec = _diff(_counters(ctx, dev), before)
    rec.update(_k1_counts())
    rec.update(tasks=out["tasks"], pushes=out["pushes"],
               push_bytes=out["push_bytes"], C=out["C"])
    return rec


def pool_body(ctx, rank, nranks):
    """GEMM, Cholesky, LU and/or the DTD GEMM (``PARSEC_MP_KINDS``:
    ``gemm``, ``cholesky``, ``lu``, ``dtd``, comma-separated) at
    ``PARSEC_MP_N`` x ``PARSEC_MP_N`` in tiles of ``PARSEC_MP_NB`` on a
    2-D block-cyclic grid (each traced under ``PARSEC_MP_TRACE_DIR``, the
    DTD GEMM apart), with host chores or the device module's
    (``PARSEC_MP_CHORES``: ``cpu`` or ``cuda``; the module wraps the
    rank's device, the host stand-in when the launcher was given
    ``device="cpu"``), each after a 2 x 2-tile run off the clock when
    ``PARSEC_MP_WARMUP`` is 1.  GEMM takes :func:`gemm_tile`'s operands
    (``PARSEC_MP_SEED``), the factorizations :func:`factor_input`;
    Cholesky runs under the four-counter detector, GEMM and LU under the
    local one.  Returns, by kind, this rank's record of
    :func:`_run_kind`, beside the rank's foreign modules, whether its
    comm thread ran (``comm_thread``) and its process group's size (None
    without one)."""
    import torch.distributed as dist
    if dist.is_initialized():
        _check_group(rank, nranks)
    env = os.environ
    n, nb = int(env["PARSEC_MP_N"]), int(env["PARSEC_MP_NB"])
    seed = int(env.get("PARSEC_MP_SEED", "0"))
    chores = env.get("PARSEC_MP_CHORES", "cpu")
    dev = None
    if chores == "cuda":
        # the module wraps the device the rank's engine bound
        from ..device.cuda import init_cuda_devices
        dev = init_cuda_devices(
            device=getattr(ctx.comm_engine.ce, "device", None))[0]
    kinds = {}
    for kind in env["PARSEC_MP_KINDS"].split(","):
        run = _run_dtd if kind == "dtd" else functools.partial(_run_kind,
                                                                kind=kind)
        if env.get("PARSEC_MP_WARMUP") == "1":
            run(ctx, rank, nranks, n=2 * nb, nb=nb, seed=seed + 1,
                chores=chores, dev=dev)
            if dev is not None:
                dev.flush_cache()
        traced = {} if kind == "dtd" or not env.get("PARSEC_MP_TRACE_DIR") \
            else {"trace_dir": env["PARSEC_MP_TRACE_DIR"]}
        kinds[kind] = run(ctx, rank, nranks, n=n, nb=nb, seed=seed,
                          chores=chores, dev=dev, **traced)
    return {"kinds": kinds, "modules": foreign_modules(),
            "comm_thread": ctx.comm_engine.debug_state()["comm_thread"],
            "world_size": dist.get_world_size()
            if dist.is_initialized() else None}
