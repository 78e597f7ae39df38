"""Spans and byte counters inside the lowered step
(``parsec_tpu_torch/ptg/lowering.py``, ``ops/gemm.py``, ``ops/factor.py``).

With the span recorder installed, each call of a lowered step is one
trace: one ``lowered.step`` span, under it (wavefront pass) one
``lowered.level`` a level, one ``lowered.gather`` and one
``lowered.call`` a group, one ``lowered.scatter`` a level and the
``lowered.clone`` of the stores the step writes, and under a call the
library's tile calls (``lib.*``) and K1's ``k1.prep``/``k1.launch`` (on
the card).  The tests hold, on the host:

- the counts to the plan's (``LoweredTaskpool.levels``, ``.groups``) and
  the nesting of every span in its level and step;
- the bytes the gather, scatter and clone spans carry to
  ``LoweredTaskpool.bytes_moved`` and both to an independent count, the
  ``numel x itemsize`` of every aten op of the step that indexes, writes
  or clones a store (a dispatch mode);
- the recorder off: nothing recorded, and the same results bit for bit;
- the clock: a span on the wall clock (``SpanRecorder.to_wall``) holds
  the ``aten::index``/``aten::index_put_`` events ``torch.profiler``
  records inside it.

The pools: the tiled Cholesky at nt=4 (wavefront, as ``"auto"`` picks)
and the tiled GEMM forced onto the wavefront pass; the GEMM's other
passes get their ``lowered.step`` only.  On the card, K1's spans count
its launches.
"""

import collections
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                               TiledMatrix)
from parsec_tpu_torch.models.cholesky import make_spd, tiled_cholesky_ptg
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.ops import gemm as gemm_ops
from parsec_tpu_torch.prof import spans
from parsec_tpu_torch.ptg.lowering import lower_taskpool

N, NB = 64, 16                          # nt = 4
POOLS = ["cholesky", "gemm"]
MOVERS = {"lowered.gather": "gather", "lowered.scatter": "scatter",
          "lowered.clone": "clone"}
UNDER_CALL = ("lib.potrf", "lib.trsm", "lib.getrf", "k1.prep", "k1.launch")


@pytest.fixture
def installed():
    """The recorder on for the test, off (and the process's earlier one,
    if any, back) after."""
    prev = spans.recorder
    spans.uninstall()
    rec = spans.install()
    yield rec
    spans.uninstall()
    if prev is not None:
        spans.install(recorder_obj=prev)


def _lowered(pool: str, passes: str = "auto", device: str = "cpu"):
    """The pool lowered on ``device``, and its stores there."""
    if pool == "cholesky":
        a = torch.tensor(make_spd(N, 1))
        A = SymTwoDimBlockCyclic.from_dense("A", a, NB, NB)
        low = lower_taskpool(tiled_cholesky_ptg(A), device=device,
                             passes=passes)
    else:
        rng = np.random.default_rng(3)
        mats = [TiledMatrix.from_dense(
            name, torch.tensor(rng.standard_normal((N, N), np.float32)),
            NB, NB) for name in "ABC"]
        low = lower_taskpool(tiled_gemm_ptg(*mats), device=device,
                             passes="wavefront" if passes == "auto"
                             else passes)
    return low, low.initial_stores()


def _by_name(rec, trace_id=None) -> collections.Counter:
    return collections.Counter(s[0] for s in rec.spans
                               if trace_id is None or s[1] == trace_id)


def _args(span) -> dict:
    return spans.args_dict(span[5])


def _inside(inner, outer) -> bool:
    return outer[2] <= inner[2] and inner[3] <= outer[3]


@pytest.mark.parametrize("pool", POOLS)
def test_one_step_span_and_one_trace_per_call(installed, pool):
    low, st = _lowered(pool)
    low.step_fn(st)
    low.step_fn(st)
    steps = [s for s in installed.spans if s[0] == "lowered.step"]
    assert len(steps) == 2
    assert [_args(s) for s in steps] == [{"mode": "wavefront"}] * 2
    tids = {s[1] for s in steps}
    assert len(tids) == 2 and 0 not in tids
    # every span of the lowering belongs to one of the two calls' traces
    assert {s[1] for s in installed.spans} == tids
    assert spans.active_trace() == 0


@pytest.mark.parametrize("pool", POOLS)
def test_span_counts_are_the_plans(installed, pool):
    low, st = _lowered(pool)
    low.step_fn(st)
    names = _by_name(installed)
    assert low.mode == "wavefront"
    assert names["lowered.step"] == 1
    assert names["lowered.level"] == low.levels
    assert names["lowered.scatter"] == low.levels
    assert names["lowered.call"] == low.groups
    assert names["lowered.gather"] == low.groups
    assert names["lowered.clone"] == 1
    levels = sorted(_args(s)["level"] for s in installed.spans
                    if s[0] == "lowered.level")
    assert levels == list(range(low.levels))
    assert sum(_args(s)["groups"] for s in installed.spans
               if s[0] == "lowered.level") == low.groups


@pytest.mark.parametrize("pool", POOLS)
def test_spans_nest_in_their_level_and_step(installed, pool):
    low, st = _lowered(pool)
    low.step_fn(st)
    by = collections.defaultdict(list)
    for s in installed.spans:
        by[s[0]].append(s)
    (step,) = by["lowered.step"]
    for lv in by["lowered.level"]:
        assert _inside(lv, step)
    for name in ("lowered.gather", "lowered.call", "lowered.scatter"):
        for s in by[name]:
            assert sum(_inside(s, lv) for lv in by["lowered.level"]) == 1, s
    for s in by["lowered.clone"]:
        assert _inside(s, step)
        assert not any(_inside(s, lv) for lv in by["lowered.level"])
    # the library's tile calls run inside a group's kernel call
    for name in UNDER_CALL:
        for s in by[name]:
            assert any(_inside(s, c) for c in by["lowered.call"]), s
    # gathers, call and scatters of a level follow one another
    for lv in by["lowered.level"]:
        mine = sorted((s for name in ("lowered.gather", "lowered.call",
                                      "lowered.scatter")
                       for s in by[name] if _inside(s, lv)),
                      key=lambda s: s[2])
        assert mine[-1][0] == "lowered.scatter"
        assert all(a[3] <= b[2] for a, b in zip(mine, mine[1:]))


def test_library_spans_count_the_tile_calls(installed):
    low, st = _lowered("cholesky")
    low.step_fn(st)
    names = _by_name(installed)
    nt = N // NB
    assert names["lib.potrf"] == nt         # one POTRF a level, G = 1
    trsm = [s for s in installed.spans
            if s[0] == "lowered.call" and _args(s)["task"] == "TRSM"]
    assert names["lib.trsm"] == len(trsm) == nt - 1
    assert all(_args(s) == {"batch": 1, "nb": NB, "route": "library"}
               for s in installed.spans if s[0] == "lib.potrf")
    assert "k1.launch" not in names         # the host launches no K1


class _StoreOps(TorchDispatchMode):
    """Every aten op of a region with its arguments and result."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func.overloadpacket), args, out))
        return out


def _independent_bytes(ops, stores) -> int:
    """The bytes of every index gather, indexed write, slab write and
    clone whose source (gathers, clones) or target (writes) lies in one
    of ``stores``, each as ``numel x itemsize`` of what it copies."""
    ptrs = {t.untyped_storage().data_ptr() for t in stores}
    total = 0
    for op, args, out in ops:
        a0 = args[0] if args else None
        if not isinstance(a0, torch.Tensor) \
                or a0.untyped_storage().data_ptr() not in ptrs:
            continue
        if op in ("aten.index", "aten.clone"):
            total += out.numel() * out.element_size()
        elif op == "aten.index_put_":
            total += args[1][0].numel() * a0[0].numel() * a0.element_size()
        elif op == "aten.copy_":
            total += a0.numel() * a0.element_size()
    return total


@pytest.mark.parametrize("pool", POOLS)
def test_bytes_carried_equal_the_plan_and_an_independent_count(installed,
                                                               pool):
    low, st = _lowered(pool)
    low.step_fn(st)
    carried = collections.Counter()
    for s in installed.spans:
        if s[0] in MOVERS:
            carried[MOVERS[s[0]]] += _args(s)["bytes"]
    assert dict(carried) == low.bytes_moved
    if pool == "cholesky":
        # TRSM, SYRK and GEMM read their tiles where they lie, and SYRK and
        # GEMM write theirs back: nothing is gathered, POTRF's and TRSM's
        # results (one row a task) are scattered, and every SYRK and GEMM
        # row is written in place
        nt = N // NB
        written = nt * (nt - 1) * (nt + 1) // 6
        assert low.bytes_moved["gather"] == 0
        assert low.bytes_moved["scatter"] == nt * (nt + 1) // 2 * NB * NB * 4
        assert low.rows_moved["in_place"]["written"] == {"A": written}
        assert sum(_args(s)["written_in_place"] for s in installed.spans
                   if s[0] == "lowered.call") == written
    else:
        assert low.bytes_moved["gather"] > 0
        assert low.bytes_moved["scatter"] > 0
    spans.uninstall()
    mode = _StoreOps()
    with mode:
        out = low.step_fn(st)
    assert _independent_bytes(mode.ops, [*st.values(), *out.values()]) \
        == sum(low.bytes_moved.values())


def test_bytes_moved_are_priced_in_each_lowerings_tiles():
    """Two lowerings of one structure in tiles of two sizes share one
    cached step; each prices its rows in its own tiles."""
    big, _ = _lowered("cholesky")
    a = torch.tensor(make_spd(N // 2, 1))
    A = SymTwoDimBlockCyclic.from_dense("A", a, NB // 2, NB // 2)
    small = lower_taskpool(tiled_cholesky_ptg(A), device="cpu")
    assert small.step_fn is big.step_fn
    assert {k: 4 * v for k, v in small.bytes_moved.items()} \
        == big.bytes_moved


@pytest.mark.parametrize("pool", POOLS)
def test_recorder_off_records_nothing_and_gives_the_same_result(pool):
    prev = spans.recorder
    spans.uninstall()
    try:
        low, st = _lowered(pool)
        rec = spans.install()
        on = low.step_fn(st)
        n_on = len(rec.spans)
        spans.uninstall()
        off = low.step_fn(st)
        assert len(rec.spans) == n_on > 0
        assert spans.recorder is None and spans.active_trace() == 0
        assert set(on) == set(off)
        for name in on:
            assert torch.equal(on[name], off[name]), name
    finally:
        spans.uninstall()
        if prev is not None:
            spans.install(recorder_obj=prev)


@pytest.mark.parametrize("pool", POOLS)
def test_index_events_fall_in_gather_and_scatter_spans(installed, pool):
    from torch.profiler import ProfilerActivity, profile
    low, st = _lowered(pool)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        low.step_fn(st)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in ("aten::index", "aten::index_put_")]
    assert events
    slack = 50_000
    walls = [(installed.to_wall(s[2]) - slack, installed.to_wall(s[3])
              + slack) for s in installed.spans
             if s[0] in ("lowered.gather", "lowered.scatter")]
    for name, a, b in events:
        assert any(lo <= a and b <= hi for lo, hi in walls), (name, a, b)


@pytest.mark.parametrize("passes,mode", [
    ("chain-collapse", "chain-dense"), ("unrolled", "unrolled")])
def test_other_passes_record_their_step(installed, passes, mode):
    low, st = _lowered("gemm", passes)
    low.step_fn(st)
    assert _by_name(installed) == {"lowered.step": 1}
    assert _args(installed.spans[0]) == {"mode": mode}
    assert low.bytes_moved is None


def test_the_gathering_chain_records_its_clone(installed):
    """A chain over one collection read twice (``C += A @ A``) cannot
    take the dense layout: it gathers, and clones its result store."""
    rng = np.random.default_rng(5)
    A = TiledMatrix.from_dense(
        "A", torch.tensor(rng.standard_normal((N, N), np.float32)), NB, NB)
    C = TiledMatrix.from_dense("C", torch.zeros(N, N), NB, NB)
    low = lower_taskpool(tiled_gemm_ptg(A, A, C), device="cpu")
    st = low.initial_stores()
    out = low.step_fn(st)
    names = _by_name(installed)
    assert names == {"lowered.step": 1, "lowered.clone": 1}
    (clone,) = [s for s in installed.spans if s[0] == "lowered.clone"]
    assert _args(clone) == {"bytes": out["C"].nbytes}
    step = next(s for s in installed.spans if s[0] == "lowered.step")
    assert _args(step) == {"mode": "chain-gather"} and _inside(clone, step)


def test_no_lowering_span_outside_a_step(installed):
    """The wrappers' spans join a lowered step's trace; called on their
    own they record nothing."""
    from parsec_tpu_torch.ops import factor
    t = torch.tensor(make_spd(NB, 2))
    factor.potrf(t)
    factor.tri_inverse(torch.tril(t), upper=False)
    gemm_ops._k1_spans(installed, 0, 1, "mma_tf32", "nt-sub", 2, 4, 4, 4)
    assert installed.spans == []
    prev = spans.enter_trace(77)
    try:
        factor.potrf(t)
        gemm_ops._k1_spans(installed, 10, 20, "mma_tf32", "nt-sub", 2, 4,
                           4, 4)
    finally:
        spans.enter_trace(prev)
    names = [s[0] for s in installed.spans]
    assert names == ["lib.potrf", "k1.prep", "k1.launch"]
    assert all(s[1] == 77 for s in installed.spans)
    prep, launch = installed.spans[1:]
    assert prep[2:4] == (10, 20) and launch[2] == 20
    assert _args(prep) == _args(launch) == {
        "variant": "mma_tf32", "form": "nt-sub", "batch": 2, "m": 4, "n": 4,
        "k": 4}


def test_a_steps_records_leave_the_collectors_lists(installed):
    """The records hold their arguments as flat tuples of strings and
    numbers, which the collector stops tracking in its young generations,
    so that hundreds of records a step never reach the oldest one (whose
    full collections pause for the whole heap)."""
    import gc
    low, st = _lowered("cholesky")
    gc.disable()
    try:
        low.step_fn(st)
    finally:
        gc.enable()
    gc.collect(0)           # the arguments leave; the records go to gen 1
    gc.collect(1)           # the records leave there
    assert installed.spans
    assert not any(gc.is_tracked(s) for s in installed.spans)


def test_the_exports_read_the_flat_arguments(installed, tmp_path):
    import json
    from parsec_tpu_torch.prof import critpath
    low, st = _lowered("cholesky")
    low.step_fn(st)
    spans.export_chrome(str(tmp_path / "t.json"))
    spans.export_spans(str(tmp_path / "s.json"))
    with open(tmp_path / "t.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("name") == "lowered.gather"]
    assert len(events) == low.groups
    assert {"task", "G", "bytes", "trace"} == set(events[0]["args"])
    raw = [s for s in critpath.load(str(tmp_path / "s.json"))
           if s[0] == "lowered.gather"]
    assert sum(s[4]["bytes"] for s in raw) == low.bytes_moved["gather"]
    assert spans.args_dict("POTRF") == {"task": "POTRF"}
    assert spans.args_dict({"bytes": 3}) == {"bytes": 3}
    assert spans.args_dict(None) == {}


def test_the_clock_anchor_is_taken_once_and_exported(installed, tmp_path):
    import json
    unix_ns, perf_ns = installed.anchor
    assert installed.anchor == (unix_ns, perf_ns)
    # the wall clock through the anchor, against a fresh read
    p0 = time.perf_counter_ns()
    u = time.time_ns()
    assert abs(installed.to_wall(p0) - u) < 5_000_000
    spans.export_chrome(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        sync = json.load(f)["traceEvents"][0]
    assert sync["name"] == "parsec_clock_sync"
    assert sync["args"] == {"unix_ns": unix_ns, "perf_ns": perf_ns}


@pytest.mark.cuda
def test_k1_launch_spans_count_the_launches_on_the_card(installed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; K1 has no CPU mode")
    low, st = _lowered("cholesky", device="cuda")
    low.warm()
    before = gemm_ops.gemm_update.launches
    low.step_fn(st)
    torch.cuda.synchronize()
    launched = gemm_ops.gemm_update.launches - before
    names = _by_name(installed)
    assert launched > 0
    assert names["k1.launch"] == names["k1.prep"] == launched
    calls = [s for s in installed.spans if s[0] == "lowered.call"]
    for s in installed.spans:
        if s[0] in UNDER_CALL:
            assert any(_inside(s, c) for c in calls), s
