"""The port's sharded RuntimeServer (``parsec_tpu_torch/serve/sharded.py``)
against the JAX package's behaviour (``tests/test_serve_sharded.py``).

Rank threads of ``run_multirank`` (``nb_cores=1``) share the port's CUDA
device module around the host (``init_cuda_devices(device="cpu")``), as
rank threads share the card.  Every stream must give the JAX package's
oracle tokens (``ToyLM.reference_generate``), placement must follow
residency and then load, the frontend's ``metrics()`` must equal the
bucket-merge of every rank's plane (the merged counts the per-rank sums),
CONFIG must ride the broadcast tree (binomial on 4 ranks: the frontend
serves ranks 1 and 2, rank 1 serves rank 3), and a rank killed with
``fail_rank`` must have its streams finish on a survivor, oracle-exact,
with a zombie's late deltas dropped by the index dedup.  ``merge_planes``
itself equals the JAX package's on the same serialized planes.  Tokens
and counts are exact.
"""

import threading
import time

import pytest

from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.prof.histogram import SLOPlane as JSLOPlane
from parsec_tpu.serve.sharded import merge_planes as j_merge_planes
from parsec_tpu_torch.comm.multirank import run_multirank
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.prof.histogram import SLOPlane
from parsec_tpu_torch.serve import ShardedRuntimeServer
from parsec_tpu_torch.serve.sharded import merge_planes

JMODEL = JToyLM()


@pytest.fixture(autouse=True)
def cpu_cuda_device():
    """The port's CUDA device module around the host CPU, shared by every
    rank thread."""
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _run_plane(nranks, frontend_fn, timeout=180):
    """Every rank builds a ShardedRuntimeServer; rank 0 runs
    ``frontend_fn(srv, peers)``, the workers serve until SHUTDOWN."""
    bar = threading.Barrier(nranks)
    peers: dict[int, ShardedRuntimeServer] = {}

    def body(ctx, rank, nranks):
        srv = ShardedRuntimeServer(ctx)
        peers[rank] = srv
        bar.wait()
        if rank == 0:
            try:
                return frontend_fn(srv, peers)
            finally:
                srv.shutdown()
                bar.wait()
        try:
            srv.serve_forever(idle_timeout=timeout)
        finally:
            srv.close()
            bar.wait()
        return None

    return run_multirank(nranks, body, nb_cores=1, timeout=timeout)[0]


def test_two_rank_oracle_equal_and_metrics_merge_exactly():
    prompts = [[3, 7, 11, 5], [1, 40], [8, 30, 22], [9, 2, 4, 6]]

    def frontend(srv, peers):
        hs = [srv.submit_stream(p, max_new_tokens=10, tenant=f"t{i % 2}")
              for i, p in enumerate(prompts)]
        srv.wait(hs, timeout=120)
        for p, h in zip(prompts, hs):
            assert h.result(timeout=1)["tokens"] == \
                JMODEL.reference_generate(p, 10), p
        m = srv.metrics(timeout=30)
        assert {h.rank for h in hs} == {0, 1}
        raw = [peers[r]._plane_dict() for r in sorted(peers)]
        assert m["tenants"] == merge_planes(raw)
        assert m["tenants"] == j_merge_planes(raw)
        assert m["ranks"] == 2
        for t in ("t0", "t1"):
            want = sum(h["count"] for plane in raw
                       for h in [plane.get(t, {}).get("latency_ms")]
                       if h is not None)
            assert want > 0
            assert m["tenants"][t]["latency_ms_count"] == want
        # each rank's batcher pinned its tiles to its rank
        for r, p in peers.items():
            assert p._local._llm.owner_rank == r
        return True

    assert _run_plane(2, frontend) is True


def test_merged_quantiles_are_those_of_the_union_of_samples(monkeypatch):
    """Every sample the two ranks' planes record, tapped raw, makes one
    histogram per (tenant, metric); the frontend's ``metrics()`` gives
    its quantiles and counts exactly."""
    from parsec_tpu_torch.prof.histogram import LogHistogram
    samples = []
    orig = SLOPlane.observe

    def observe(plane, tenant, metric, value):
        samples.append((tenant, metric, float(value)))
        orig(plane, tenant, metric, value)

    monkeypatch.setattr(SLOPlane, "observe", observe)
    prompts = [[3, 7, 11, 5], [1, 40], [8, 30, 22], [9, 2, 4, 6], [5, 5]]

    def frontend(srv, peers):
        hs = [srv.submit_stream(p, max_new_tokens=8, tenant=f"t{i % 2}")
              for i, p in enumerate(prompts)]
        srv.wait(hs, timeout=120)
        for _ in range(100):
            n = len(samples)
            m = srv.metrics(timeout=30)
            if len(samples) == n:
                break
            time.sleep(0.05)
        return m, list(samples[:n])

    m, got = _run_plane(2, frontend)
    hists = {}
    for tenant, metric, v in got:
        hists.setdefault((tenant, metric), LogHistogram()).record(v)
    assert {t for t, _ in hists} >= {"t0", "t1"}
    for (tenant, metric), h in hists.items():
        d = m["tenants"][tenant]
        assert d[f"{metric}_count"] == h.count
        for q in (0.5, 0.99):
            assert d[f"{metric}_p{int(q * 100)}"] == round(h.quantile(q), 3)
    assert {(t, k[:-len("_count")]) for t, d in m["tenants"].items()
            for k in d if k.endswith("_count")} == set(hists)


def test_placement_prefers_prefix_residency_then_least_loaded():
    a, b = [3, 7, 11, 5], [21, 22, 23, 24, 25]

    def frontend(srv, peers):
        ha = srv.submit_stream(a, max_new_tokens=6)
        hb = srv.submit_stream(b, max_new_tokens=6)
        assert ha.rank == 0 and hb.rank == 1, (ha.rank, hb.rank)
        srv.wait([ha, hb], timeout=120)
        hc = srv.submit_stream(b, max_new_tokens=6)
        assert hc.rank == 1, hc.rank
        srv.wait([hc], timeout=120)
        assert hc.result(timeout=1)["tokens"] == \
            JMODEL.reference_generate(b, 6)
        return True

    assert _run_plane(2, frontend) is True


def test_config_broadcast_rides_the_tree():
    def frontend(srv, peers):
        srv.broadcast_config(weights={"pro": 4.0}, max_inflight=32,
                             max_tenant_inflight=8)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            srv.step()
            if all(peers[r]._local._adm.max_inflight == 32 for r in peers):
                break
            time.sleep(0.005)
        for r, p in sorted(peers.items()):
            assert p._local._adm.max_inflight == 32, r
            assert p._local._adm.max_tenant_inflight == 8, r
            assert p._local._fair._weights.get("pro") == 4.0, r
        assert [peers[r].config_forwards for r in range(4)] == [2, 1, 0, 0]
        return True

    assert _run_plane(4, frontend) is True


def test_dead_rank_streams_requeue_oracle_exact():
    prompt, nmax = [5, 9, 13, 2], 12
    oracle = JMODEL.reference_generate(prompt, nmax)

    def frontend(srv, peers):
        filler = srv.submit_stream([2, 4], max_new_tokens=4)   # rank 0
        h = srv.submit_stream(prompt, max_new_tokens=nmax)     # rank 1
        assert h.rank == 1
        deadline = time.monotonic() + 60
        while len(h.tokens) < 3:
            srv.step()
            assert time.monotonic() < deadline, h.tokens
            time.sleep(0.002)
        peers[1].zombie = True
        srv.fail_rank(1)
        assert h.rank == 0 and h.requeues == 1 and h.ranks == [1, 0]
        srv.wait([h, filler], timeout=120)
        assert h.result(timeout=1)["tokens"] == oracle
        peers[1].zombie = False
        deadline = time.monotonic() + 30
        while peers[1]._live and time.monotonic() < deadline:
            srv.step()
            time.sleep(0.005)
        srv.step()
        assert h.tokens == oracle            # nothing re-landed
        srv._handle(1, {"op": "TOKENS", "sid": h.sid, "base": 0,
                        "toks": list(oracle[:2])})
        assert h.tokens == oracle and h.dup_tokens >= 2
        assert h.result(timeout=1)["requeues"] == 1
        return True

    assert _run_plane(2, frontend) is True


def test_merge_planes_equals_the_jax_merge():
    """Both packages' planes, fed the same samples, serialize and merge
    to the same summary, whichever package merges."""
    jp, pp = [JSLOPlane(), JSLOPlane()], [SLOPlane(), SLOPlane()]
    for i in range(400):
        t = f"t{i % 3}"
        for planes in (jp, pp):
            planes[i % 2].observe(t, "tok_latency_ms", 0.5 + (i * 7) % 91)
            planes[i % 2].observe(t, "ttft_ms", 10.0 + (i * 13) % 977)
            planes[i % 2].inc(t, "admission_sheds", i % 2)
    jd = [p.to_dict() for p in jp]
    pd = [p.to_dict() for p in pp]
    assert pd == jd
    assert merge_planes(pd) == j_merge_planes(jd) == merge_planes(jd)
