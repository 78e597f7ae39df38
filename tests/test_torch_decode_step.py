"""The port's one-step decode pool (``llm/decode.py:decode_step_ptg``),
its helpers (``seed_decode_superpool``, ``read_token_chain``,
``generate_by_steps``) and paged KV over several ranks, against the JAX
package.

The same prompts (numpy, from a seed) go through the JAX package's
``decode_step_ptg`` with host bodies and through the port's, with its
CUDA chores on the device module around the host
(``init_cuda_devices(device="cpu")``, the kernels' plain versions) and
with host chores.  At ToyLM's width and at 32 heads of 128: task counts
equal, attention outputs within 1e-5 abs (fp32 both sides, only the
summation order differs), the appended tail page bit for bit, and tokens
generated step by step equal to the JAX step loop's, to the k-step
superpool's and to the float64 oracle, token for token.
"""

import numpy as np
import pytest

from parsec_tpu.analysis.__main__ import _model_graphs as j_model_graphs
from parsec_tpu.data.datatype import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.paged_kv import PagedKVCollection as JPagedKV
from parsec_tpu.llm import ToyLM as JToyLM
from parsec_tpu.llm import decode as jdec
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch import analysis
from parsec_tpu_torch.analysis.__main__ import _model_graphs
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
from parsec_tpu_torch.device import registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.llm import ToyLM
from parsec_tpu_torch.llm import decode as pdec
from parsec_tpu_torch.runtime import Context

TOL = 1e-5
WIDTHS = {"toy": (4, 8), "wide": (32, 128)}


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _models(width):
    h, d = WIDTHS[width]
    return JToyLM(num_heads=h, head_dim=d), ToyLM(num_heads=h, head_dim=d)


def _prompts(model, seed, n, lo=2, hi=40):
    rng = np.random.default_rng(seed)
    return {f"s{i}": [int(t) for t in rng.integers(0, model.vocab,
                                                   int(rng.integers(lo, hi)))]
            for i in range(n)}


def _sides(jm, pm, page_size=4):
    H, D = pm.num_heads, pm.head_dim
    jside = (JPagedKV("KV", page_size=page_size, num_heads=H, head_dim=D),
             JDict("Q", dtt=JTileType((3, H, D), np.float32)),
             JDict("O", dtt=JTileType((H, D), np.float32)))
    pside = (PagedKVCollection("KV", page_size=page_size, num_heads=H,
                               head_dim=D),
             DictCollection("Q", dtt=TileType((3, H, D))),
             DictCollection("O", dtt=TileType((H, D))))
    return jside, pside


def _jrun(tp):
    ctx = JContext(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
    finally:
        ctx.fini()


def _prun(tp, nb_cores=0):
    with Context(nb_cores=nb_cores) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)


def _jax_prefill(jm, kv, prompts):
    for seq, prompt in prompts.items():
        kv.alloc_seq(seq)
        for key, tile in jdec.prefill_chunks(jm, kv, seq,
                                             prompt[:-1]).items():
            pg = kv.data_of(*key).get_copy(0)
            pg.value = np.array(tile, copy=True)
            pg.version += 1


def _jax_steps(jm, kv, Q, O, prompts, steps):
    """The JAX package's step loop: one ``decode_step_ptg`` pool a step,
    sampled on the host."""
    _jax_prefill(jm, kv, prompts)
    cur = {s: p[-1] for s, p in prompts.items()}
    out = {s: [] for s in prompts}
    ntasks = []
    for _ in range(steps):
        for seq in prompts:
            kv.ensure_tail_slot(seq)
            qc = Q.data_of(seq).get_copy(0)
            qc.value = jm.q3(cur[seq])
            qc.version += 1
        tp = jdec.decode_step_ptg(kv, Q, O, list(prompts))
        ntasks.append(tp.nb_local_tasks())
        _jrun(tp)
        for seq in prompts:
            kv.note_appended(seq, 1)
            cur[seq] = jm.sample(np.asarray(O.data_of(seq).newest_copy()
                                            .value))
            out[seq].append(cur[seq])
    return out, ntasks


@pytest.mark.parametrize("width", ["toy", "wide"])
@pytest.mark.parametrize("devices", ["cuda", "cpu"])
def test_one_step_matches_the_jax_pool(cpu_cuda_device, width, devices):
    jm, pm = _models(width)
    prompts = _prompts(pm, 1, 3, hi=20)
    (jkv, jQ, jO), (pkv, pQ, pO) = _sides(jm, pm)
    _jax_prefill(jm, jkv, prompts)
    for seq, prompt in prompts.items():
        pkv.alloc_seq(seq)
        for key, tile in pdec.prefill_chunks(pm, pkv, seq,
                                             prompt[:-1]).items():
            pdec._set(pkv, key, tile)
    for seq, prompt in prompts.items():
        for kv, Q, q in ((jkv, jQ, jm.q3(prompt[-1])),
                         (pkv, pQ, pm.q3(prompt[-1]))):
            kv.ensure_tail_slot(seq)
            c = Q.data_of(seq).get_copy(0)
            c.value = q
            c.version += 1
    jtp = jdec.decode_step_ptg(jkv, jQ, jO, list(prompts))
    ptp = pdec.decode_step_ptg(pkv, pQ, pO, list(prompts), devices=devices)
    assert ptp.nb_local_tasks() == jtp.nb_local_tasks()
    before = cpu_cuda_device.executed_tasks
    _jrun(jtp)
    _prun(ptp)
    ran = cpu_cuda_device.executed_tasks - before
    assert ran == (jtp.nb_local_tasks() if devices == "cuda" else 0)
    for seq in prompts:
        jo = np.asarray(jO.data_of(seq).newest_copy().value)
        po = pO.data_of(seq).newest_copy().value.numpy()
        assert np.abs(po - jo).max() <= TOL, seq
        n = pkv.npages(seq) - 1
        jt = np.asarray(jkv.data_of(seq, n).newest_copy().value)
        pt = pkv.data_of(seq, n).newest_copy().value.numpy()
        assert np.array_equal(pt, jt), seq


@pytest.mark.parametrize("width", ["toy", "wide"])
def test_steps_give_the_jax_loop_the_superpool_and_the_oracle(
        cpu_cuda_device, width):
    jm, pm = _models(width)
    k = 5
    prompts = _prompts(pm, 2, 3)
    (jkv, jQ, jO), (pkv, pQ, pO) = _sides(jm, pm)
    want, jtasks = _jax_steps(jm, jkv, jQ, jO, prompts, k)
    ptasks = []

    def run(tp):
        ptasks.append(tp.nb_local_tasks())
        _prun(tp, nb_cores=2)

    got = pdec.generate_by_steps(pm, pkv, pQ, pO, prompts, k, run)
    assert got == want
    assert ptasks == jtasks
    for seq, prompt in prompts.items():
        assert got[seq] == pm.reference_generate(prompt, k), seq
    # the k-step superpool on the same prompts: the same tokens
    H, D = pm.num_heads, pm.head_dim
    kv2 = PagedKVCollection("KV2", page_size=4, num_heads=H, head_dim=D)
    Q2 = DictCollection("Q2", dtt=TileType((3, H, D)))
    O2 = DictCollection("O2", dtt=TileType((H, D)))
    TOK = DictCollection("TOK", dtt=TileType((3,)))
    EMB = DictCollection("EMB", dtt=TileType(tuple(pm.q3_table().shape)))
    steps = {s: k for s in prompts}
    pdec.seed_decode_superpool(pm, kv2, Q2, TOK, EMB, prompts, steps)
    _prun(pdec.decode_superpool_ptg(kv2, Q2, O2, TOK, EMB, list(prompts),
                                    [k] * len(prompts)))
    for seq in prompts:
        assert pdec.read_token_chain(TOK, seq, k) == (got[seq], False), seq


def test_seed_decode_superpool_equals_the_jax_seeding(cpu_cuda_device):
    """The port's one-call seeding against the JAX package's, then one
    superpool each: the same tokens, read by each package's
    ``read_token_chain``, EOS included."""
    jm, pm = _models("toy")
    prompts = _prompts(pm, 3, 4)
    free = pm.reference_generate(prompts["s1"], 6)
    eos = free[2]
    steps = dict(zip(prompts, (6, 3, 1, 5)))
    H, D = pm.num_heads, pm.head_dim
    jcolls = (JPagedKV("KV", page_size=4, num_heads=H, head_dim=D),
              JDict("Q", dtt=JTileType((3, H, D), np.float32)),
              JDict("O", dtt=JTileType((H, D), np.float32)),
              JDict("TOK", dtt=JTileType((3,), np.float32)),
              JDict("EMB", dtt=JTileType(jm.q3_table().shape, np.float32)))
    pcolls = (PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D),
              DictCollection("Q", dtt=TileType((3, H, D))),
              DictCollection("O", dtt=TileType((H, D))),
              DictCollection("TOK", dtt=TileType((3,))),
              DictCollection("EMB", dtt=TileType(tuple(
                  pm.q3_table().shape))))
    jdec.seed_decode_superpool(jm, jcolls[0], jcolls[1], jcolls[3],
                               jcolls[4], prompts, steps, eos=eos)
    pdec.seed_decode_superpool(pm, pcolls[0], pcolls[1], pcolls[3],
                               pcolls[4], prompts, steps, eos=eos)
    for seq in prompts:
        assert pcolls[0].npages(seq) == jcolls[0].npages(seq)
        assert pcolls[0].seq_len(seq) == jcolls[0].seq_len(seq)
    ks = [steps[s] for s in prompts]
    _jrun(jdec.decode_superpool_ptg(*jcolls, list(prompts), ks))
    _prun(pdec.decode_superpool_ptg(*pcolls, list(prompts), ks))
    for seq in prompts:
        assert pdec.read_token_chain(pcolls[3], seq, steps[seq]) \
            == jdec.read_token_chain(jcolls[3], seq, steps[seq]), seq
    assert pdec.read_token_chain(pcolls[3], "s1", 6)[1] is True


def test_the_cli_graph_of_llm_decode_equals_the_jax_one():
    for nt in (3, 5):
        jr = __import__("parsec_tpu.analysis", fromlist=["check_ptg"]) \
            .check_ptg(dict(j_model_graphs(nt))["llm_decode"])
        pr = analysis.check_ptg(dict(_model_graphs(nt))["llm_decode"])
        assert (pr.ntasks, pr.nedges) == (jr.ntasks, jr.nedges)
        assert pr.ok and pr.ntasks > 0
        assert pr.graph == jr.graph


def test_a_step_without_a_tail_slot_is_refused():
    pm = ToyLM()
    kv = PagedKVCollection("KV", page_size=4, num_heads=4, head_dim=8)
    kv.alloc_seq("a")
    with pytest.raises(ValueError, match="ensure_tail_slot"):
        pdec.decode_step_ptg(kv, DictCollection("Q"), DictCollection("O"),
                             ["a"])
    with pytest.raises(ValueError):
        pdec.decode_step_ptg(kv, DictCollection("Q"), DictCollection("O"),
                             ["a"], devices="tpu")
    assert pm.vocab > 0


# ---------------------------------------------------------------------------
# paged KV over several ranks
# ---------------------------------------------------------------------------

SEQS = [0, 1, 7, 12, np.int64(5), "a", "stream3", ("t", 1), 2.5, None]


@pytest.mark.parametrize("nodes", [1, 2, 4])
def test_paged_kv_over_ranks_gives_the_jax_rank_of(nodes):
    jkv = JPagedKV("KV", nodes=nodes, myrank=nodes - 1)
    pkv = PagedKVCollection("KV", nodes=nodes, myrank=nodes - 1)
    assert (pkv.nodes, pkv.myrank) == (jkv.nodes, jkv.myrank)
    for seq in SEQS:
        for page in (0, 3):
            assert pkv.rank_of(seq, page) == jkv.rank_of(seq, page), seq
    ranks = {pkv.rank_of(s, 0) for s in range(32)}
    assert ranks == set(range(nodes))


def test_a_rank_function_overrides_the_hash():
    def fn(seq, page):
        return 1
    jkv = JPagedKV("KV", nodes=4, rank_of_fn=fn)
    pkv = PagedKVCollection("KV", nodes=4, rank_of_fn=fn)
    assert pkv.rank_of("x", 2) == jkv.rank_of("x", 2) == 1
