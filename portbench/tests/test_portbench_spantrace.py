"""The traced sub-window read through the program's spans
(:mod:`portbench.spantrace`), on synthetic profiler events with
correlation ids and nested spans, and once through the program on the
host."""

import time

import pytest
import torch

from portbench import loop, spantrace
from portbench.trace import Trace, read_events

MS = 1_000_000

# the events of the trace test in test_portbench_spec.py, no spans
PLAIN = [
    (True, "k1", 0 * MS, 4 * MS), (True, "copy", 3 * MS, 5 * MS),
    (True, "k1", 7 * MS, 9 * MS),
    (False, "cudaLaunchKernel", 6 * MS, 6 * MS + 10),
    (False, "cudaStreamSynchronize", 9 * MS, 12 * MS),
    (True, "outside", 20 * MS, 21 * MS),
]


def _read(events, spans, w0=0, w1=20 * MS, solves=1):
    t = spantrace.SpanTrace(solves=solves)
    spantrace.read_spans(events, spans, w0, w1, t)
    return t


def test_without_spans_the_trace_reads_as_before():
    old = Trace(solves=2)
    read_events(PLAIN, -1 * MS, 10 * MS, old)
    new = _read([(*e, 0) for e in PLAIN], [], -1 * MS, 10 * MS, solves=2)
    assert new.device_ns == old.device_ns
    assert new.device_events == old.device_events
    assert new.busy_s == old.busy_s
    assert new.gaps_s == old.gaps_s
    assert new.breakdown() == old.breakdown()
    assert new.device_ns_by_span == {"none": 8 * MS}
    assert new.step_idle_ns == 0 and not new.span_counts


def test_innermost_pieces():
    spans = [(0, 10, "step"), (1, 4, "level"), (2, 3, "call"),
             (5, 9, "level"), (6, 7, "gather"), (12, 13, "step")]
    assert spantrace.innermost(spans) == [
        (0, 1, "step"), (1, 2, "level"), (2, 3, "call"), (3, 4, "level"),
        (4, 5, "step"), (5, 6, "level"), (6, 7, "gather"), (7, 9, "level"),
        (9, 10, "step"), (12, 13, "step")]


# one solve: a step [0, 10] ms holding a level [1, 8] with a gather
# [1, 3] and a call [3, 6] holding k1.launch [4, 5]; the caller's
# turnaround after it, and a second step [12, 19] with no level
SPANS = [
    ("lowered.step", 0 * MS, 10 * MS, {"mode": "wavefront"}),
    ("lowered.level", 1 * MS, 8 * MS, {"level": 0, "groups": 1}),
    ("lowered.gather", 1 * MS, 3 * MS, {"task": "GEMM", "G": 2,
                                        "bytes": 4096}),
    ("lowered.call", 3 * MS, 6 * MS, {"task": "GEMM", "G": 2}),
    ("k1.prep", 3 * MS, 4 * MS, {"variant": "mma_tf32"}),
    ("k1.launch", 4 * MS, 5 * MS, {"variant": "mma_tf32"}),
    ("lowered.scatter", 6 * MS, 8 * MS, ("bytes", 1024)),    # flat form
    ("lowered.step", 12 * MS, 19 * MS, {"mode": "wavefront"}),
]
# runtime calls (host) and the device operations they launched, paired
# by correlation id
EVENTS = [
    (False, "cudaLaunchKernel", 2 * MS, 2 * MS + 100, 11),
    (True, "vectorized_gather_kernel", 2 * MS + MS // 2, 3 * MS, 11),
    (False, "cudaLaunchKernel", 4 * MS + 10, 4 * MS + 300, 12),
    (True, "gemm_update_kernel", 5 * MS, 9 * MS, 12),
    (False, "cudaMemcpyAsync", 7 * MS, 7 * MS + 2000, 13),
    (True, "Memcpy DtoD", 9 * MS, 10 * MS, 13),
    (False, "cudaLaunchKernel", 11 * MS, 11 * MS + 100, 14),
    (True, "outside_any", 16 * MS, 18 * MS, 14),
    (False, "cudaStreamSynchronize", 18 * MS + 500, 18 * MS + 900, 0),
]


def test_a_device_op_goes_to_the_innermost_span_of_its_launch():
    t = _read(EVENTS, SPANS)
    assert t.device_ns_by_span == {
        "lowered.gather": MS // 2, "k1.launch": 4 * MS,
        "lowered.scatter": MS, "none": 2 * MS}
    assert t.runtime_ns_by_span[("k1.launch", "cudaLaunchKernel")] == 290
    assert t.device_ns_by_span_op[("k1.launch", "gemm_update_kernel")] \
        == 4 * MS
    assert t.device_ns == {"vectorized_gather_kernel": MS // 2,
                           "gemm_update_kernel": 4 * MS,
                           "Memcpy DtoD": MS, "outside_any": 2 * MS}


def test_a_launch_is_paired_with_its_first_runtime_event():
    """The driver's own events under a launch (module loading, say) carry
    the launch's correlation id and start later: the launch's span owns
    the operation."""
    events = [(False, "cudaLaunchKernel", 1 * MS, 5 * MS, 7),
              (False, "Lazy Function Loading", 4 * MS, 5 * MS, 7),
              (True, "k", 6 * MS, 8 * MS, 7)]
    spans = [("k1.launch", 0, 3 * MS, {}), ("lowered.call", 3 * MS, 9 * MS,
                                           {})]
    t = _read(events, spans, 0, 10 * MS)
    assert t.device_ns_by_span == {"k1.launch": 2 * MS}


def test_gaps_are_named_by_the_span_open_at_their_middle():
    t = _read(EVENTS, SPANS)
    # [0, 2.5]: middle in the gather; [3, 5]: middle 4 ms, just before
    # the launch's runtime call, as k1.launch opens; [10, 16]: middle 13
    # ms, in the second step; [18, 20]: middle 19 ms, as the second step
    # closes: no span open
    assert dict(t.gaps_s) == pytest.approx({
        "lowered.gather > vectorized_gather_kernel": 2.5e-3,
        "k1.launch > gemm_update_kernel": 2e-3,
        "lowered.step > outside_any": 6e-3,
        "host > the window's end": 2e-3})
    # idle inside the steps: [0, 2.5], [3, 5], [12, 16], [18, 19]
    assert t.step_idle_ns == int(2.5 * MS) + 2 * MS + 4 * MS + MS
    # the gaps whose middle lies in a step, all named by a span
    assert t.step_gap_ns_by_namer == {"span": int(10.5 * MS)}


def test_a_gap_in_a_runtime_call_keeps_its_name():
    events = [(False, "cudaStreamSynchronize", 0, 10 * MS, 0),
              (True, "k", 6 * MS, 8 * MS, 0)]
    t = _read(events, [("lowered.step", 0, 10 * MS, {})], 0, 8 * MS)
    assert dict(t.gaps_s) == pytest.approx(
        {"cudaStreamSynchronize > k": 6e-3})
    assert t.step_gap_ns_by_namer == {"runtime": 6 * MS}


def test_host_time_counts_and_bytes_by_span():
    t = _read(EVENTS, SPANS, solves=2)
    assert t.span_counts["lowered.step"] == 2
    assert t.host_ns_by_span["lowered.step"] == 17 * MS
    assert t.self_ns_by_span["lowered.step"] == 3 * MS + 7 * MS
    assert t.self_ns_by_span["lowered.level"] == 0
    assert t.self_ns_by_span["lowered.call"] == MS
    assert t.longest_by_span["lowered.step"] == (10 * MS,
                                                 {"mode": "wavefront"})
    assert t.longest_by_span["lowered.scatter"] == (2 * MS, {"bytes": 1024})
    assert t.bytes_by_span == {"lowered.gather": 4096,
                               "lowered.scatter": 1024}


def test_per_layer_numbers():
    t = _read(EVENTS, SPANS, solves=2)
    got = {name: f(t) for name, f in spantrace.PER_LAYER.items()}
    assert got.pop("library_ms") is None        # no lib.* span
    assert got == pytest.approx({
        "gather_ms": 0.25, "scatter_ms": 0.5, "moved_gb": 2560 / 1e9,
        "k1_prep_ms": 0.5, "step_idle_ms": 4.75}, rel=1e-12)


@pytest.mark.parametrize("name", sorted(spantrace.PER_LAYER))
def test_each_per_layer_number_is_none_without_spans(name):
    """The parent's program records no span: every new number is
    missing there, not zero."""
    t = _read([(*e, 0) for e in PLAIN], [], -1 * MS, 10 * MS, solves=2)
    assert spantrace.PER_LAYER[name](t) is None


def test_traced_on_the_host_reads_the_programs_spans(small):
    """The lowered Cholesky at a small size on the host: a window of whole
    solves whose span counts are the plan's, a solve each, and the
    recorder left as it was found (uninstalled)."""
    from parsec_tpu_torch.prof import spans
    from portbench.kinds import potrf

    cpu = torch.device("cpu")
    problem = potrf.build(small("potrf16k.lowered"), 7, cpu)
    assert spans.recorder is None
    t = spantrace.traced(problem, cpu, 0.2)
    assert spans.recorder is None
    low = problem.lowered
    n = t.solves
    assert n >= 1 and t.window_s > 0
    assert t.span_counts["lowered.step"] == n
    assert t.span_counts["lowered.level"] == n * low.levels
    assert t.span_counts["lowered.call"] == n * low.groups
    moved = sum(low.bytes_moved.values())
    assert spantrace.moved_gb(t) == pytest.approx(moved / 1e9)
    # the host's step time is the enqueue the loop timed around step_fn
    assert t.host_ns_by_span["lowered.step"] / 1e9 <= sum(t.enqueue_s)
    assert spantrace.k1_prep_ms(t) is None      # no K1 launch on the host


def test_traced_keeps_a_recorder_installed_before_it(small):
    from parsec_tpu_torch.prof import spans
    from portbench.kinds import gemm

    cpu = torch.device("cpu")
    problem = gemm.build(small("gemm16k.lowered"), 7, cpu)
    rec = spans.install()
    try:
        before = time.perf_counter_ns()
        t = spantrace.traced(problem, cpu, 0.1,
                             run=lambda p, d, s: loop.run(p, d, solves=2))
        assert spans.recorder is rec
        assert t.solves == 2 and t.span_counts == {"lowered.step": 2}
        assert all(s[2] >= before for s in rec.spans)
    finally:
        spans.uninstall()
