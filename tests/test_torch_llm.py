"""The port's LLM decode serving slice against the JAX package's.

The same prompts (made with numpy from a seed) go through
``parsec_tpu``'s pools and server on the CPU and through
``parsec_tpu_torch``'s with the CUDA device module wrapped around the
host (``init_cuda_devices(device="cpu")``), so every ATTN/OUT/SAMPLE/PF
task takes the device path — stage-in, the tile cache, flooding and the
batched bodies — with the kernels' plain versions.  Tokens must equal
the JAX pools' tokens and the port's float64 oracle
``ToyLM.reference_generate`` token for token, task counts must equal the
JAX pools', and attention outputs agree to 1e-5 abs (fp32 both sides,
only the summation order differs).
"""

import numpy as np
import pytest
import torch

from parsec_tpu.data.datatype import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JPagedKV
from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.llm import decode as jdec
from parsec_tpu.llm.batcher import ContinuousBatcher as JContinuousBatcher
from parsec_tpu.runtime import Context as JContext
from parsec_tpu.serve import RuntimeServer as JRuntimeServer
from parsec_tpu_torch.core.params import params as port_params
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.llm import ContinuousBatcher, ToyLM
from parsec_tpu_torch.llm import decode as pdec
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.serve import AdmissionRejected, RuntimeServer

JMODEL = JToyLM()
MODEL = ToyLM()
H, D = MODEL.num_heads, MODEL.head_dim
TOL = 1e-5


@pytest.fixture
def cpu_cuda_device():
    """The port's CUDA device module around the host CPU, registered for
    the test and unregistered after."""
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


@pytest.fixture
def port_param():
    saved = {}

    def set_(name, value):
        saved.setdefault(name, port_params.get(name))
        port_params.set(name, value)

    yield set_
    for name, value in saved.items():
        port_params.set(name, value)


def _prompts(seed, n, lo=2, hi=30):
    rng = np.random.default_rng(seed)
    return {f"s{i}": [int(t) for t in rng.integers(0, MODEL.vocab,
                                                   int(rng.integers(lo, hi)))]
            for i in range(n)}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_model_carries_the_jax_table_bit_for_bit():
    ported = ToyLM.from_numpy(JMODEL.emb)
    assert np.array_equal(ported.q3_table().numpy(), JMODEL.q3_table())
    # the same seeded draw: the default models already hold the same bits
    assert np.array_equal(MODEL.emb.numpy(), JMODEL.emb)
    assert np.array_equal(MODEL.q3(70).numpy(), JMODEL.q3(70))
    other = JToyLM(vocab=32, num_heads=2, head_dim=4, seed=9)
    assert np.array_equal(ToyLM.from_numpy(other.emb).q3_table().numpy(),
                          other.q3_table())


@pytest.mark.parametrize("prompt,n", [([3, 7, 11, 5], 12), ([1], 5),
                                      (list(range(40, 0, -1)), 9)])
def test_oracle_matches_the_jax_oracle(prompt, n):
    want = JMODEL.reference_generate(prompt, n)
    margins = []
    assert MODEL.reference_generate(prompt, n, margins=margins) == want
    assert len(margins) == n and min(margins) >= 0.0
    eos = want[2]
    assert MODEL.reference_generate(prompt, n, eos=eos) == \
        JMODEL.reference_generate(prompt, n, eos=eos)


# ---------------------------------------------------------------------------
# the pools
# ---------------------------------------------------------------------------

def _jax_side(page_size=4):
    kv = JPagedKV("KV", page_size=page_size, num_heads=H, head_dim=D)
    return (kv, JDict("Q", dtt=JTileType((3, H, D), np.float32)),
            JDict("O", dtt=JTileType((H, D), np.float32)),
            JDict("TOK", dtt=JTileType((3,), np.float32)),
            JDict("EMB", dtt=JTileType(JMODEL.q3_table().shape,
                                       np.float32)))


def _port_side(page_size=4):
    kv = PagedKVCollection("KV", page_size=page_size, num_heads=H,
                           head_dim=D)
    return (kv, DictCollection("Q", dtt=TileType((3, H, D))),
            DictCollection("O", dtt=TileType((H, D))),
            DictCollection("TOK", dtt=TileType((3,))),
            DictCollection("EMB", dtt=TileType(tuple(
                MODEL.q3_table().shape))))


def _run_jax(tp):
    ctx = JContext(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=120)
    ctx.fini()


def _run_port(tp, nb_cores=0):
    with Context(nb_cores=nb_cores) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)


def _seed_port(side, prompts, steps, eos=None):
    """The port's side of ``jdec.seed_decode_superpool``: prefill each
    prompt's pages in place (no runtime), preallocate every step's write
    slot, and seed Q, TOK and EMB the way the batcher does."""
    kv, Q, _, TOK, EMB = side
    pdec.seed_emb_table(MODEL, EMB)
    for seq, prompt in prompts.items():
        kv.alloc_seq(seq)
        for key, tile in pdec.prefill_chunks(MODEL, kv, seq,
                                             prompt[:-1]).items():
            pg = kv.data_of(*key).get_copy(0)
            pg.value = tile
            pg.version += 1
        pdec.preallocate_decode_steps(kv, seq, steps[seq])
        pdec.seed_stream_step(MODEL, Q, TOK, seq, prompt[-1], eos=eos)


def test_decode_step_matches_the_jax_pool(cpu_cuda_device):
    """One decode step for every sequence: a one-step superpool
    (ATTN -> OUT -> SAMPLE) on both packages."""
    prompts = _prompts(1, 4)
    steps = {s: 1 for s in prompts}
    jside, pside = _jax_side(), _port_side()
    jdec.seed_decode_superpool(JMODEL, *jside[:2], *jside[3:], prompts,
                               steps)
    _seed_port(pside, prompts, steps)
    jtp = jdec.decode_superpool_ptg(*jside, list(prompts), [1] * 4)
    ptp = pdec.decode_superpool_ptg(*pside, list(prompts), [1] * 4)
    assert ptp.nb_local_tasks() == jtp.nb_local_tasks()
    _run_jax(jtp)
    _run_port(ptp)
    assert cpu_cuda_device.executed_tasks == jtp.nb_local_tasks()
    got = pdec.read_token_chains(pside[3], steps)
    for seq, prompt in prompts.items():
        jo = np.asarray(jside[2].data_of(seq).newest_copy().value)
        po = pside[2].data_of(seq).newest_copy().value.numpy()
        assert np.abs(po - jo).max() <= TOL, seq
        n = pside[0].npages(seq) - 1
        jt = np.asarray(jside[0].data_of(seq, n).newest_copy().value)
        pt = pside[0].data_of(seq, n).newest_copy().value.numpy()
        assert np.array_equal(pt, jt), seq     # the appended k/v and fill
        assert got[seq] == jdec.read_token_chain(jside[3], seq, 1), seq
        assert got[seq][0] == MODEL.reference_generate(prompt, 1), seq


@pytest.mark.parametrize("eos_case", [False, True])
def test_superpool_matches_the_jax_pool_and_the_oracle(cpu_cuda_device,
                                                       eos_case):
    """Mixed k per sequence, token positions crossing page boundaries
    mid-pool (page size 4) and, in the EOS case, one stream sampling EOS
    at an interior step while the others run on."""
    prompts = _prompts(2, 4)
    steps = dict(zip(prompts, (7, 5, 1, 8)))
    eos = None
    if eos_case:
        free = MODEL.reference_generate(prompts["s3"], 8)
        eos = free[2]
    jside, pside = _jax_side(), _port_side()
    jdec.seed_decode_superpool(JMODEL, jside[0], jside[1], jside[3],
                               jside[4], prompts, steps, eos=eos)
    _seed_port(pside, prompts, steps, eos=eos)
    k = [steps[s] for s in prompts]
    jtp = jdec.decode_superpool_ptg(*jside, list(prompts), k)
    ptp = pdec.decode_superpool_ptg(*pside, list(prompts), k)
    assert ptp.nb_local_tasks() == jtp.nb_local_tasks()
    _run_jax(jtp)
    _run_port(ptp, nb_cores=2)
    assert cpu_cuda_device.executed_tasks == jtp.nb_local_tasks()
    assert cpu_cuda_device.batched_dispatches > 0
    got = pdec.read_token_chains(pside[3], steps)
    for seq, prompt in prompts.items():
        want = MODEL.reference_generate(prompt, steps[seq], eos=eos)
        jt = jdec.read_token_chain(jside[3], seq, steps[seq])
        assert got[seq] == jt, seq
        assert got[seq][0] == want, seq
    if eos_case:
        assert got["s3"][1] and len(got["s3"][0]) < 8


def test_host_chore_pools_equal_the_device_pools(cpu_cuda_device):
    """``devices="cpu"`` builds the host bodies only: the same tokens,
    and nothing runs through the device module."""
    prompts = _prompts(3, 3)
    steps = {s: 6 for s in prompts}
    pside = _port_side()
    _seed_port(pside, prompts, steps)
    tp = pdec.decode_superpool_ptg(*pside, list(prompts), [6, 6, 6],
                                   devices="cpu")
    assert [c.device_type for tc in tp.task_classes for c in tc.chores] \
        == ["cpu"] * 3
    _run_port(tp)
    assert cpu_cuda_device.executed_tasks == 0
    got = pdec.read_token_chains(pside[3], steps)
    for seq, prompt in prompts.items():
        assert got[seq][0] == MODEL.reference_generate(prompt, 6)


def test_device_builders_carry_only_the_device_chore():
    pside = _port_side()
    pside[0].alloc_seq("a")
    pdec.preallocate_decode_steps(pside[0], "a", 1)
    tp = pdec.decode_superpool_ptg(*pside, ["a"], [1])
    assert {c.device_type for tc in tp.task_classes for c in tc.chores} \
        == {"cuda"}
    with pytest.raises(ValueError):
        pdec.decode_superpool_ptg(*pside, ["a"], [1], devices="tpu")


def test_prefill_pool_copies_chunks_through_the_device(cpu_cuda_device):
    prompts = _prompts(4, 3, lo=5, hi=20)
    kv = PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D)
    chunks = {}
    for seq, prompt in prompts.items():
        kv.alloc_seq(seq)
        chunks.update(pdec.prefill_chunks(MODEL, kv, seq, prompt[:-1]))
    T = DictCollection("T", dtt=kv.default_dtt,
                       init_fn=lambda *k: chunks[k], keys=list(chunks))
    tp = pdec.prefill_ptg(kv, T, list(prompts))
    assert tp.nb_local_tasks() == len(chunks)
    _run_port(tp)
    assert cpu_cuda_device.tasks_by_class["PF"] == len(chunks)
    jkv = JPagedKV("KV", page_size=4, num_heads=H, head_dim=D)
    for seq, prompt in prompts.items():
        jkv.alloc_seq(seq)
        jchunks = jdec.prefill_chunks(JMODEL, jkv, seq, prompt[:-1])
        for key, tile in chunks.items():
            if key[0] == seq:
                got = kv.data_of(*key).newest_copy().value
                assert torch.equal(got, tile)
                assert np.array_equal(got.numpy(), jchunks[key])


# ---------------------------------------------------------------------------
# continuous batching on the RuntimeServer
# ---------------------------------------------------------------------------

def _serve(server_cls, prompts, fork_pairs, max_new, eos=None):
    out = {}
    with server_cls(nb_cores=2) as server:
        tks = {}
        for i, (name, prompt) in enumerate(prompts.items()):
            parent = fork_pairs.get(name)
            tks[name] = server.submit_stream(
                prompt, max_new_tokens=max_new, tenant=f"t{i % 2}",
                eos=eos.get(name) if eos else None,
                fork_from=None if parent is None else tks[parent])
        for name, tk in tks.items():
            r = tk.result(timeout=120)
            assert len(r["per_token_s"]) == len(r["tokens"])
            out[name] = r["tokens"]
        stats = server.stats()["llm"]
    return out, stats


def test_streams_match_the_jax_server_and_the_oracle(cpu_cuda_device):
    """The slice as a whole: RuntimeServer.submit_stream with two tenants,
    a fork_from stream and an EOS stream, on both packages."""
    base = _prompts(5, 5, lo=3, hi=40)
    # the fork is submitted right behind its parent, so it is classified
    # while the parent still sits at its prompt boundary
    prompts = {"s0": base["s0"], "fork": list(base["s0"]),
               **{k: v for k, v in base.items() if k != "s0"}}
    fork_pairs = {"fork": "s0"}
    eos = {"s1": MODEL.reference_generate(prompts["s1"], 10)[3]}
    got, stats = _serve(RuntimeServer, prompts, fork_pairs, 10, eos)
    jgot, jstats = _serve(JRuntimeServer, prompts, fork_pairs, 10, eos)
    for name, prompt in prompts.items():
        want = MODEL.reference_generate(prompt, 10, eos=eos.get(name))
        assert got[name] == jgot[name] == want, name
    assert len(got["s1"]) < 10                  # stopped at its EOS
    assert stats["forked_streams"] == 1
    # sharing is an optimization whose window depends on iteration timing
    # (tests/test_llm.py accepts both outcomes for the JAX batcher)
    assert jstats["forked_streams"] in (0, 1)
    assert stats["streams_completed"] == len(prompts)
    assert stats["kv"]["physical_pages"] == 0
    assert stats["kv"]["cow_copies"] >= 1
    s = cpu_cuda_device.stats()
    assert set(s["tasks_by_class"]) == {"PF", "ATTN", "OUT", "SAMPLE"}
    assert s["batched_dispatches"] > 0


def test_streams_join_and_leave_between_superpools(cpu_cuda_device,
                                                   port_param):
    port_param("llm_steps_per_pool", 4)
    with RuntimeServer(nb_cores=2) as server:
        first = server.submit_stream([3, 7, 11], max_new_tokens=11)
        short = server.submit_stream([5, 9], max_new_tokens=2)
        assert short.result(timeout=120)["tokens"] == \
            MODEL.reference_generate([5, 9], 2)
        late = server.submit_stream([8, 30], max_new_tokens=6)
        assert first.result(timeout=120)["tokens"] == \
            MODEL.reference_generate([3, 7, 11], 11)
        # one arrival stamp a token; a superpool's tokens share theirs
        stamps = first.token_at
        assert len(stamps) == 11 and stamps == sorted(stamps)
        assert stamps[0] == first.first_token_at
        assert 3 <= len(set(stamps)) < 11
        assert late.result(timeout=120)["tokens"] == \
            MODEL.reference_generate([8, 30], 6)
        llm = server.stats()["llm"]
    assert llm["streams_completed"] == 3
    assert llm["decode_submits"] < 11 + 2 + 6


def test_the_server_needs_a_card_by_default():
    """With no CUDA device registered, the batcher registers the card
    itself — and without one that raises instead of serving on the host."""
    snapshot = list(registry.devices)
    registry.devices = [d for d in snapshot if d.type != "cuda"]
    try:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the batcher would use it")
        with RuntimeServer(nb_cores=1) as server:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                server.submit_stream([1, 2], max_new_tokens=2)
    finally:
        registry.devices = snapshot


def test_batcher_on_host_chores_needs_no_device():
    """``devices="cpu"`` builds host-chore pools: no CUDA device is
    registered or needed, and the tokens are the oracle's."""
    snapshot = list(registry.devices)
    registry.devices = [d for d in snapshot if d.type != "cuda"]
    try:
        with RuntimeServer(nb_cores=2) as server:
            b = ContinuousBatcher(server, model=MODEL, devices="cpu")
            tk = b.submit_stream([3, 7, 11, 5, 9], max_new_tokens=9)
            assert tk.result(timeout=60)["tokens"] == \
                MODEL.reference_generate([3, 7, 11, 5, 9], 9)
            b.stop()
        assert registry.by_type("cuda") == []
    finally:
        registry.devices = snapshot


def test_batcher_validates_inputs_and_rejects_after_stop(cpu_cuda_device):
    with RuntimeServer(nb_cores=1) as server:
        with pytest.raises(ValueError):
            server.submit_stream([], max_new_tokens=2)
        with pytest.raises(ValueError):
            server.submit_stream([1], max_new_tokens=0)
        t1 = server.submit_stream([1, 2, 3], max_new_tokens=2)
        with pytest.raises(ValueError, match="identical prompt"):
            server.submit_stream([1, 2, 4], max_new_tokens=2, fork_from=t1)
        with pytest.raises(ValueError, match="StreamTicket"):
            server.submit_stream([1, 2, 3], max_new_tokens=2,
                                 fork_from=object())
        assert t1.result(timeout=60)["tokens"] == \
            MODEL.reference_generate([1, 2, 3], 2)
    with pytest.raises(AdmissionRejected):
        server.submit_stream([1, 2], max_new_tokens=2)


def test_page_budget_exhaustion_fails_only_the_oversized_stream(
        cpu_cuda_device):
    with RuntimeServer(nb_cores=2) as server:
        kv = PagedKVCollection("KV", page_size=2, num_heads=H, head_dim=D,
                               max_pages=3)
        b = ContinuousBatcher(server, model=MODEL, kv=kv)
        big = b.submit_stream(list(range(1, 10)), max_new_tokens=2,
                              tenant="big")
        small = b.submit_stream([1, 2], max_new_tokens=2, tenant="small")
        with pytest.raises(MemoryError):
            big.result(timeout=60)
        assert small.result(timeout=60)["tokens"] == \
            MODEL.reference_generate([1, 2], 2)
        assert b.stats()["kv"]["physical_pages"] == 0
        assert b.Q.known_keys() == [] and b.TOK.known_keys() == []
        b.stop()


def test_step_timeout_defers_page_release_until_pool_terminates(
        cpu_cuda_device):
    from parsec_tpu_torch.llm.batcher import StreamTicket, _Stream
    from parsec_tpu_torch.runtime.taskpool import Taskpool
    with RuntimeServer(nb_cores=1) as server:
        b = ContinuousBatcher(server, model=MODEL,
                              kv=PagedKVCollection("KV", page_size=4,
                                                   num_heads=H, head_dim=D))
        b.kv.alloc_seq("z")
        b.kv.alloc_page("z")
        st = _Stream("z", "t", 0, [1], 1, StreamTicket("z", "t"))
        zombie = Taskpool(name="zombie_step")
        b._retire_failed([st], TimeoutError("step timeout"),
                         defer_pool=zombie)
        with pytest.raises(TimeoutError):
            st.ticket.result(timeout=1)
        assert b.stats()["kv"]["physical_pages"] == 1
        assert not b._fork_ready(st)
        zombie.terminated()
        assert b.stats()["kv"]["physical_pages"] == 0
        b.stop()


# ---------------------------------------------------------------------------
# the ACC chain updated in place, and a Llama-2-7B head width
# ---------------------------------------------------------------------------

def test_acc_tiles_own_their_tensor_on_the_host_stand_in(cpu_cuda_device):
    """The host stand-in lands a host tile by sharing its tensor.  Every
    ACC tile an ATTN task updates in place must be the device's own: right
    after stage-in no host copy shares its storage, and after the run
    every host copy still holds what it held (a NEW tile's zeros)."""
    prompts = _prompts(6, 3)
    steps = {s: 5 for s in prompts}
    pside = _port_side()
    _seed_port(pside, prompts, steps)
    seen = []
    dev = cpu_cuda_device
    real = dev.stage_in_many

    def stage_in_many(tasks):
        real(tasks)
        for t in tasks:
            if t.task_class.name != "ATTN":
                continue
            c = t.data[2]
            host = c.original.get_copy(0)
            assert c.device_index == dev.device_index
            if host is not None and host is not c:
                assert host.value.untyped_storage().data_ptr() \
                    != c.value.untyped_storage().data_ptr()
                seen.append((host, host.version, host.value.clone()))

    dev.stage_in_many = stage_in_many
    try:
        tp = pdec.decode_superpool_ptg(*pside, list(prompts), [5, 5, 5])
        _run_port(tp, nb_cores=2)
    finally:
        del dev.stage_in_many
    assert dev.batched_dispatches > 0
    # every chain's first ATTN stages a NEW tile: a host zero tile, v1
    assert sum(1 for _, v, x in seen if v == 1 and not x.any()) >= 15
    for host, version, value in seen:
        assert host.version == version and torch.equal(host.value, value)
    got = pdec.read_token_chains(pside[3], steps)
    for seq, prompt in prompts.items():
        assert got[seq][0] == MODEL.reference_generate(prompt, 5), seq


def _counting(server):
    """Record the task count of every pool the server is handed."""
    counts = []
    real = server.submit

    def submit(tp, *args, **kwargs):
        counts.append(tp.nb_local_tasks())
        return real(tp, *args, **kwargs)

    server.submit = submit
    return counts


def test_wide_heads_match_the_jax_batcher(cpu_cuda_device):
    """ToyLM at a Llama-2-7B head width (32 heads of 128, pages of
    (3, 16, 32, 128)) through both packages' ContinuousBatcher: the same
    tokens, the oracle's, and the same number of tasks, every one of the
    port's through the device module."""
    rng = np.random.default_rng(3)
    model = ToyLM(num_heads=32, head_dim=128)
    jmodel = JToyLM(num_heads=32, head_dim=128)
    prompts = [[int(t) for t in rng.integers(0, model.vocab,
                                             int(rng.integers(10, 40)))]
               for _ in range(3)]
    out = {}
    for name, server_cls, batcher_cls, m in (
            ("jax", JRuntimeServer, JContinuousBatcher, jmodel),
            ("port", RuntimeServer, ContinuousBatcher, model)):
        before = cpu_cuda_device.executed_tasks
        with server_cls(nb_cores=2) as server:
            counts = _counting(server)
            b = batcher_cls(server, model=m)
            tks = [b.submit_stream(p, max_new_tokens=6, tenant=f"t{i % 2}")
                   for i, p in enumerate(prompts)]
            toks = [tk.result(timeout=120)["tokens"] for tk in tks]
            b.stop()
        out[name] = (toks, sum(counts),
                     cpu_cuda_device.executed_tasks - before)
    (jtoks, jtasks, jdev), (ptoks, ptasks, pdev) = out["jax"], out["port"]
    margins = []
    for p in prompts:
        m: list[float] = []
        model.reference_generate(p, 6, margins=m)
        margins += m
    assert min(margins) > 1e-2          # no near-tie for fp32 to flip
    assert ptoks == jtoks == [model.reference_generate(p, 6)
                              for p in prompts]
    assert ptasks == jtasks == pdev and jdev == 0
    # PF a prompt page, then a step's ATTN over its pages, OUT, SAMPLE
    assert set(cpu_cuda_device.tasks_by_class) == {"PF", "ATTN", "OUT",
                                                   "SAMPLE"}
    assert cpu_cuda_device.batched_dispatches > 0
