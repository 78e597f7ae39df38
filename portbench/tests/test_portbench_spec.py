"""The benchmark's counts and its data: operations and bytes, the
percentile, every cell found by name, every metric's ``moves``."""

import json

import pytest

from portbench import roofline, spec
from portbench.kinds import gemm, potrf


def test_gemm_counts(bench):
    cfg = spec.config(bench, "gemm_n16384_nb512")
    assert gemm.flops(cfg) == 2 * 16384 ** 3 == 8.796093022208e12
    flops, nbytes = gemm.k1_work(cfg)
    # A and B bf16 read once, C fp32 read once and written once
    assert nbytes == 2 * 16384 ** 2 * 2 + 2 * 16384 ** 2 * 4
    least, by = roofline.least_time(flops, nbytes, cfg["peak"])
    assert by == "operations"
    assert least == pytest.approx(8.894e-3, rel=1e-3)


def test_cholesky_counts(bench):
    cfg = spec.config(bench, "potrf_n16384_nb512")
    assert potrf.task_counts(cfg["N"] // cfg["nb"]) == {
        "POTRF": 32, "TRSM": 496, "SYRK": 496, "GEMM": 4960}
    n = cfg["N"]
    assert potrf.flops(cfg) == n ** 3 / 3 + n ** 2 / 2
    flops, nbytes = potrf.k1_work(cfg)
    assert flops == (496 + 496 + 2 * 4960) * 512 ** 3
    # by step k, with r = 31 - k tiles below the diagonal: TRSM reads r
    # tiles and the inverse and writes r, SYRK reads 2r and writes r,
    # GEMM reads r panel tiles and r(r-1)/2 tiles and writes r(r-1)/2
    tiles = sum(2 * r + 1 + 3 * r + (r if r >= 2 else 0) + r * (r - 1)
                for r in range(1, 32))
    assert tiles == 12926
    assert nbytes == tiles * 512 * 512 * 4
    least, by = roofline.least_time(flops, nbytes, cfg["peak"])
    assert by == "bytes"
    assert least == pytest.approx(4.046e-3, rel=1e-3)
    # one group a class and step: 31 TRSM, 31 SYRK, 30 GEMM, as the
    # wavefront's 92 K1 launches a solve
    groups = {(c, k) for c, k, _, _ in potrf.k1_tasks(32)}
    assert len(groups) == 92
    assert len(potrf.lower_keys(32)) == 528


def test_cholesky_flops_as_the_program_counts_them(bench):
    from parsec_tpu_torch.models.cholesky import cholesky_flops
    cfg = spec.config(bench, "potrf_n16384_nb512")
    assert potrf.flops(cfg) == cholesky_flops(cfg["N"])


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 95, 95),
    (list(range(100, 0, -1)), 95, 95),
    ([5.0], 95, 5.0),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 100],
     95, 19),
    ([1] * 19 + [100] * 2, 95, 100),
])
def test_percentile_over_all_samples(values, q, want):
    assert roofline.percentile(values, q) == want


def test_percentile_is_not_a_median_of_chunks():
    # ten chunks of ten: the chunks' p95s have a median of 10, the whole
    # sample's p95 is 95
    xs = list(range(1, 101))
    assert roofline.percentile(xs, 95) == 95


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (35, 38), (50, 51)]
    assert roofline.device_busy(spans) == 20 + 10 + 1
    assert roofline.idle_gaps(spans) == [(20, 30), (40, 50)]


def test_every_cell_found_by_name(bench):
    names = set()
    for cell in bench["workloads"]:
        cfg = spec.config(bench, cell["config"])
        assert cfg["name"] == cell["config"]
        kind = spec.kind(cfg["kind"])
        for fn in ("flops", "k1_work", "build", "check", "stand_in"):
            assert callable(getattr(kind, fn))
        assert set(cfg["limits"]) and all(
            isinstance(v, float) for v in cfg["limits"].values())
        traffic = spec.traffic(cell["traffic"])
        assert traffic["keep"] >= 1 and traffic["warmup_solves"] >= 1
        for group in ("end_to_end", "per_layer"):
            for m in spec.metrics_of(bench, cell["name"], group):
                assert callable(spec.metric(m["name"]).read)
        names.add(cell["name"])
    assert names == {"gemm16k.lowered", "potrf16k.lowered"}


def test_metric_files_agree_with_the_benchmark(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [c["name"] for c in bench["workloads"]]
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            mod = spec.metric(m["name"])
            assert mod.UNIT == m["unit"] and mod.BETTER == m["better"]
            if group == "end_to_end":
                assert mod.MOVES is None
                continue
            assert mod.MOVES == m["moves"] and m["moves"] in e2e
            # every cell of the metric reports the metric it moves
            for c in m.get("workloads", cells):
                assert c in e2e[m["moves"]].get("workloads", cells), \
                    (m["name"], c)


def test_every_cell_reports_setup_an_end_to_end_and_a_layer(bench):
    for c in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(bench, c["name"],
                                                   "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(bench, c["name"], "per_layer")


def test_movement_patterns_are_data(bench):
    path = spec.PKG / "metrics" / "movement_ms.json"
    pats = json.loads(path.read_text())["patterns"]
    assert pats and all(isinstance(p, str) and p for p in pats)


def test_trace_reads_busy_idle_and_gaps():
    from portbench.trace import Trace, read_events
    ms = 1_000_000
    events = [
        (True, "k1", 0 * ms, 4 * ms), (True, "copy", 3 * ms, 5 * ms),
        (True, "k1", 7 * ms, 9 * ms),
        (False, "cudaLaunchKernel", 6 * ms, 6 * ms + 10),
        (False, "cudaStreamSynchronize", 9 * ms, 12 * ms),
        (True, "outside", 20 * ms, 21 * ms),
    ]
    t = Trace(solves=2)
    read_events(events, -1 * ms, 10 * ms, t)
    assert t.busy_s == pytest.approx(7e-3)        # [0,5] and [7,9]
    assert t.device_events == 3
    assert t.device_ns == {"k1": 6 * ms, "copy": 2 * ms}
    # the leading gap (the host in no runtime call), the gap at [5, 7]
    # (a launch under way at its middle) and the trailing gap (a wait)
    assert dict(t.gaps_s) == pytest.approx({
        "host > k1": 1e-3, "cudaLaunchKernel > k1": 2e-3,
        "cudaStreamSynchronize > the window's end": 1e-3})
