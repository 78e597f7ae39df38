"""The port's log histograms, SLO plane and server metrics against the JAX
package's.

The same seeded values (numpy) go into both packages' ``LogHistogram``:
the serialized dicts must be equal, the quantiles equal to the last bit,
and each package's ``from_dict`` must read the other's dict.  The
properties of the JAX package's tests are held on the port's copy: exact
associative merge, the quantile error bound against numpy, the round
trip, the extremes, the racy-count clamp.  Then the serving side: a
``RuntimeServer`` of each package serves the same two-tenant ToyLM
backlog (the port's on the CUDA device module around the host): the
tokens equal the float64 oracle, and the per-tenant SLO keys and the
deterministic counts (TTFT one a stream, token latency one a token, one
admission, queue and latency sample a pool) are the JAX server's; a
stuck pool's stall section names its tenant and trace; the server fires
the ``SERVE_*`` events in the JAX package's order.
"""

import json
import threading

import numpy as np
import pytest

from parsec_tpu.prof.histogram import LogHistogram as JLogHistogram
from parsec_tpu.prof.histogram import SLOPlane as JSLOPlane
from parsec_tpu.serve import RuntimeServer as JRuntimeServer
from parsec_tpu_torch import ptg
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.llm import ToyLM
from parsec_tpu_torch.prof import flight_recorder, pins, runtime_report
from parsec_tpu_torch.prof.histogram import LogHistogram, SLOPlane
from parsec_tpu_torch.prof.histogram import merged_summary
from parsec_tpu_torch.prof.pins import PinsEvent
from parsec_tpu_torch.serve import RuntimeServer
from parsec_tpu_torch.serve.admission import (AdmissionController,
                                              AdmissionRejected)

MODEL = ToyLM()
DISTS = ("lognormal", "exponential", "uniform")


def _values(dist, n=4000, seed=7):
    rng = np.random.default_rng(seed)
    return {"lognormal": rng.lognormal(1.0, 1.0, n) * 3,
            "exponential": rng.exponential(20.0, n) + 0.01,
            "uniform": rng.uniform(0.5, 400.0, n)}[dist]


def _hist(cls, values):
    h = cls()
    for v in values:
        h.record(float(v))
    return h


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


# ---------------------------------------------------------------------------
# histograms against the JAX package's (exact: the same float arithmetic)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS)
def test_histogram_dicts_and_quantiles_equal_the_jax_package(dist):
    xs = _values(dist)
    h, jh = _hist(LogHistogram, xs), _hist(JLogHistogram, xs)
    assert h.to_dict() == jh.to_dict()
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q), q
    assert h.mean == jh.mean


@pytest.mark.parametrize("dist", DISTS)
def test_each_package_reads_the_others_dict(dist):
    xs = _values(dist, seed=11)
    h, jh = _hist(LogHistogram, xs), _hist(JLogHistogram, xs)
    wire = json.loads(json.dumps(h.to_dict()))
    from_port = JLogHistogram.from_dict(wire)
    from_jax = LogHistogram.from_dict(json.loads(json.dumps(jh.to_dict())))
    assert from_port.counts == jh.counts and from_jax.counts == h.counts
    for q in (0.5, 0.99):
        assert from_port.quantile(q) == from_jax.quantile(q) == h.quantile(q)


def test_histogram_merge_is_associative_and_exact():
    xs = np.random.default_rng(42).lognormal(1.0, 1.5, 3000) * 5
    a, b, c = xs[:1000], xs[1000:1700], xs[1700:]
    left = _hist(LogHistogram, a).merge(_hist(LogHistogram, b)).merge(
        _hist(LogHistogram, c))
    right = _hist(LogHistogram, a).merge(
        _hist(LogHistogram, b).merge(_hist(LogHistogram, c)))
    whole = _hist(LogHistogram, xs)
    assert left.counts == right.counts == whole.counts
    assert left.count == whole.count == len(xs)
    # float sums in another order: 1e-6 relative
    assert abs(left.total - whole.total) < 1e-6 * whole.total
    jwhole = _hist(JLogHistogram, xs)
    assert whole.to_dict()["counts"] == jwhole.to_dict()["counts"]


@pytest.mark.parametrize("dist", DISTS)
def test_histogram_quantile_error_is_bounded(dist):
    """Within ``growth - 1`` (about 19%) of numpy's percentile: the
    midpoint bound sqrt(growth) plus the rank conventions at bucket
    edges, the JAX package's tolerance."""
    xs = _values(dist, n=5000)
    h = _hist(LogHistogram, xs)
    bound = h.growth - 1.0
    for q in (0.5, 0.9, 0.99):
        hq, nq = h.quantile(q), float(np.percentile(xs, q * 100))
        assert abs(hq - nq) / nq <= bound, (dist, q, hq, nq)


def test_histogram_serialization_round_trip():
    h = _hist(LogHistogram, np.random.default_rng(3).exponential(5.0, 2000))
    h2 = LogHistogram.from_dict(json.loads(json.dumps(h.to_dict())))
    assert h2.counts == h.counts and h2.count == h.count
    for q in (0.5, 0.99):
        assert h2.quantile(q) == h.quantile(q)
    assert all(isinstance(i, int) and c > 0 for i, c in h.to_dict()["counts"])


def test_histogram_extremes_and_empty():
    h = LogHistogram()
    assert h.quantile(0.5) == 0.0
    h.record(0.0)
    h.record(1e12)
    assert h.count == 2
    assert h.quantile(0.01) == h.lo
    assert h.quantile(0.99) == h._bucket_value(h.nbuckets - 1)
    with pytest.raises(ValueError):
        h.merge(LogHistogram(lo=1.0))
    with pytest.raises(ValueError):
        LogHistogram(growth=1.0)


def test_histogram_quantile_clamps_racy_count_divergence():
    h = _hist(LogHistogram, [1.0, 2.0, 3.0])
    h.count += 2            # two lost bucket increments
    assert h.quantile(0.99) < 10.0
    empty = LogHistogram()
    empty.count = 5
    assert empty.quantile(0.5) == 0.0


def test_slo_plane_summary_and_dumps_equal_the_jax_plane():
    rng = np.random.default_rng(5)
    p, jp = SLOPlane(), JSLOPlane()
    for tenant in ("a", "b"):
        for v in rng.exponential(30.0, 200):
            p.observe(tenant, "ttft_ms", float(v))
            jp.observe(tenant, "ttft_ms", float(v))
        p.inc(tenant, "admission_sheds", 3)
        jp.inc(tenant, "admission_sheds", 3)
    assert p.summary() == jp.summary()
    assert p.summary((0.5, 0.9, 0.99)) == jp.summary((0.5, 0.9, 0.99))
    assert p.to_dict() == jp.to_dict()
    assert p.summary()["a"]["admission_sheds"] == 3
    # the live planes merge: this one's tenants are in the merged summary
    merged = merged_summary()
    assert merged["a"]["ttft_ms_count"] >= 200
    flight_recorder.ensure_installed()   # the slo block follows the rings
    assert runtime_report()["slo"]["b"]["ttft_ms_count"] >= 200
    p.reset()
    assert p.summary() == {}


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _ctl_pool(build, depth=4, lanes=4, body=None):
    p = build.PTGBuilder("slopool", NT=lanes, DEPTH=depth)
    t = p.task("EP", d=build.span(0, lambda g, l: g.DEPTH - 1),
               n=build.span(0, lambda g, l: g.NT - 1))
    f = t.flow("ctl", build.CTL)
    f.input(pred=("EP", "ctl", lambda g, l: {"d": l.d - 1, "n": l.n}),
            guard=lambda g, l: l.d > 0)
    f.output(succ=("EP", "ctl", lambda g, l: {"d": l.d + 1, "n": l.n}),
             guard=lambda g, l: l.d < g.DEPTH - 1)
    t.body(body or (lambda es, task, g, l: None))
    return p.build()


def _serve_pools(server_cls, build):
    server = server_cls(nb_cores=2)
    tks = [server.submit(_ctl_pool(build), tenant=f"t{i % 2}")
           for i in range(8)]
    for tk in tks:
        tk.result(timeout=60)
    live = server.metrics()
    server.drain(timeout=60)
    return live, server.metrics(), tks


def test_server_metrics_equal_the_jax_servers_counts():
    from parsec_tpu import ptg as jptg
    live, after, tks = _serve_pools(RuntimeServer, ptg)
    jlive, jafter, _ = _serve_pools(JRuntimeServer, jptg)
    assert sorted(live) == sorted(jlive)
    assert live["tenants"]["t0"]["admission_wait_ms_count"] == 4
    # counted after the drain: a pool's queue and latency samples land
    # just after its ticket resolves
    for tenant in ("t0", "t1"):
        d, jd = after["tenants"][tenant], jafter["tenants"][tenant]
        assert sorted(d) == sorted(jd)
        for metric in ("latency_ms", "queue_wait_ms", "admission_wait_ms"):
            assert d[f"{metric}_count"] == jd[f"{metric}_count"] == 4
        assert d["latency_ms_p99"] >= d["latency_ms_p50"] > 0
    assert live["drain_s"] is None and after["drain_s"] is not None
    assert after["tenants"]["_server"]["drain_ms_count"] == 1
    assert jafter["tenants"]["_server"]["drain_ms_count"] == 1
    assert len({tk.trace.trace_id for tk in tks}) == len(tks)


def test_admission_sheds_counted_per_tenant():
    server = RuntimeServer(
        nb_cores=1, admission=AdmissionController(max_inflight=1))
    gate = threading.Event()
    tk = server.submit(_ctl_pool(ptg, body=lambda es, task, g, l:
                                 (gate.wait(10), None)[1]), tenant="busy")
    try:
        with pytest.raises(AdmissionRejected):
            server.submit(_ctl_pool(ptg), tenant="shed", block=False)
        assert server.metrics()["tenants"]["shed"]["admission_sheds"] == 1
    finally:
        gate.set()
        tk.result(timeout=60)
        server.drain(timeout=60)


def test_stall_section_names_the_stuck_tenant_and_trace():
    server = RuntimeServer(nb_cores=1)
    gate = threading.Event()
    tk = server.submit(_ctl_pool(ptg, body=lambda es, task, g, l:
                                 (gate.wait(10), None)[1]), tenant="victim")
    try:
        report = flight_recorder.build_stall_report(server.context,
                                                    reason="test")
        sec = [v for k, v in report["sections"].items()
               if k.startswith("serve")]
        assert sec, report.get("sections")
        victim = sec[0]["victim"]
        assert victim["inflight"] == 1
        assert victim["oldest_trace_id"] == format(tk.trace.trace_id, "x")
        assert victim["oldest_age_s"] >= 0
        assert victim["oldest_pool"] == tk.name
        assert report["queue_depths"]["fair.victim"] >= 3
    finally:
        gate.set()
        tk.result(timeout=60)
        server.drain(timeout=60)
    report = flight_recorder.build_stall_report(None, reason="after")
    assert not any(k.startswith("serve")
                   for k in (report.get("sections") or {}))


def test_the_server_fires_the_serve_events_in_order():
    evs = (PinsEvent.SERVE_SUBMIT, PinsEvent.SERVE_ADMIT,
           PinsEvent.SERVE_START, PinsEvent.SERVE_COMPLETE,
           PinsEvent.SERVE_DRAIN)
    order = []
    hooks = [(ev, (lambda ev: lambda es, p: order.append((ev.name, p)))(ev))
             for ev in evs]
    for ev, h in hooks:
        pins.register(ev, h)
    try:
        server = RuntimeServer(nb_cores=1)
        server.submit(_ctl_pool(ptg), tenant="x").result(timeout=60)
        server.drain(timeout=60)
    finally:
        for ev, h in hooks:
            pins.unregister(ev, h)
    assert [n for n, _ in order] == ["SERVE_SUBMIT", "SERVE_ADMIT",
                                     "SERVE_START", "SERVE_COMPLETE",
                                     "SERVE_DRAIN"]
    assert order[0][1] == ("x", "slopool")
    rep = runtime_report()
    assert rep["serve"]["submitted"] >= 1 and rep["serve"]["drains"] >= 1


def _serve_streams(server_cls, prompts, max_new):
    with server_cls(nb_cores=2) as server:
        tks = {name: server.submit_stream(p, max_new_tokens=max_new,
                                          tenant=f"t{i % 2}")
               for i, (name, p) in enumerate(prompts.items())}
        out = {name: tk.result(timeout=120)["tokens"]
               for name, tk in tks.items()}
        traces = {tk.trace.trace_id for tk in tks.values()}
    # after the drain: every pool's samples have landed.  The server goes
    # back too: ``runtime_report`` merges the LIVE planes, held weakly
    return out, server.metrics(), traces, server


def test_two_tenant_streams_equal_the_jax_server_and_the_oracle(
        cpu_cuda_device):
    rng = np.random.default_rng(21)
    prompts = {f"s{i}": [int(t) for t in rng.integers(
        0, MODEL.vocab, int(rng.integers(3, 30)))] for i in range(5)}
    got, m, traces, _server = _serve_streams(RuntimeServer, prompts, 9)
    jgot, jm, _, _ = _serve_streams(JRuntimeServer, prompts, 9)
    for name, prompt in prompts.items():
        assert got[name] == jgot[name] == \
            MODEL.reference_generate(prompt, 9), name
    assert len(traces) == len(prompts)
    for tenant, n in (("t0", 3), ("t1", 2)):
        d, jd = m["tenants"][tenant], jm["tenants"][tenant]
        assert sorted(d) == sorted(jd)
        assert d["ttft_ms_count"] == jd["ttft_ms_count"] == n
        assert d["tok_latency_ms_count"] == jd["tok_latency_ms_count"] \
            == 9 * n
        # one admission, queue and latency sample a pool, in each package
        assert d["admission_wait_ms_count"] == d["queue_wait_ms_count"] \
            == d["latency_ms_count"] > 0
        assert jd["admission_wait_ms_count"] == jd["latency_ms_count"]
        assert d["tok_latency_ms_p99"] >= d["tok_latency_ms_p50"] > 0
    rep = runtime_report()
    assert rep["llm"]["tokens_generated"] >= 45
    assert "t0" in rep["slo"] and "t1" in rep["slo"]
