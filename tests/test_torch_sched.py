"""The port's eleven schedulers (``parsec_tpu_torch/sched/modules.py``)
against the JAX package's (``parsec_tpu/sched/modules.py``), each under
the same name.

For every name: the tiled GEMM on the device module around the host
(``init_cuda_devices(device="cpu")`` and the JAX package's
``accel_device``) gives the JAX package's C and task counts; a host EP
pool and a host RW chain on the dynamic path (``runtime_dag_compile``
off, else the compiled DAG would bypass the scheduler) give its traces
and tiles; and on one caller-driven thread a pool of prioritized tasks
runs in exactly the JAX package's order.  ``ll`` queues on the native
LIFO in both packages; ``llp`` needs priority scans and queues on a
Python deque in both.  Tolerances: fp32 ``rtol=1e-5, atol=1e-4`` for
the GEMM (sums of the same fp32 products, in another order), exact for
traces, orders and integer tiles.
"""

from collections import deque

import numpy as np
import pytest
import torch

import parsec_tpu.runtime.dagrun  # noqa: F401  (registers its params)
from parsec_tpu import ptg as jptg
from parsec_tpu.core.params import params as jparams
from parsec_tpu.data.data import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.data_dist.matrix import TiledMatrix as JTiledMatrix
from parsec_tpu.models.tiled_gemm import tiled_gemm_ptg as jax_tiled_gemm
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch import native, ptg
from parsec_tpu_torch.core.params import params
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.data_dist.matrix import TiledMatrix
from parsec_tpu_torch.device import registry as port_registry
from parsec_tpu_torch.device.cuda import init_cuda_devices
from parsec_tpu_torch.models.ep import ep_pool as port_ep_pool
from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
from parsec_tpu_torch.runtime import Context
from parsec_tpu_torch.sched import open_scheduler
from test_torch_dagrun import jax_ep_pool

NAMES = ["lfq", "ap", "spq", "ip", "gd", "rnd", "ll", "llp", "pbq", "ltq",
         "lhq"]
FP32_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cpu_cuda_device():
    snapshot = list(port_registry.devices)
    dev = init_cuda_devices(device="cpu")[0]
    yield dev
    port_registry.devices = snapshot
    for i, d in enumerate(port_registry.devices):
        d.device_index = i


@pytest.fixture
def dynamic_only():
    saved = (params.get("runtime_dag_compile"),
             jparams.get("runtime_dag_compile"))
    params.set("runtime_dag_compile", False)
    jparams.set("runtime_dag_compile", False)
    yield
    params.set("runtime_dag_compile", saved[0])
    jparams.set("runtime_dag_compile", saved[1])


def _run(ctx, tp, dev=None):
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        if dev is not None:
            dev.sync()
            dev.flush_cache()
    finally:
        ctx.fini(timeout=30)


def test_open_scheduler_knows_the_eleven():
    for name in NAMES:
        assert open_scheduler(name).name == name
    with pytest.raises(LookupError):
        open_scheduler("serve_fair")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("nb_cores", [0, 2])
def test_tiled_gemm_matches_jax(accel_device, cpu_cuda_device, name,
                                nb_cores):
    rng = np.random.default_rng(17)
    a = rng.standard_normal((48, 32), dtype=np.float32)
    b = rng.standard_normal((32, 40), dtype=np.float32)
    c = rng.standard_normal((48, 40), dtype=np.float32)
    jm = [JTiledMatrix.from_dense(x, v, 16, 16)
          for x, v in zip("ABC", (a, b, c))]
    pm = [TiledMatrix.from_dense(x, v, 16, 16)
          for x, v in zip("ABC", (a, b, c))]
    _run(JContext(nb_cores=nb_cores, scheduler=name),
         jax_tiled_gemm(*jm, devices="tpu"), accel_device)
    _run(Context(nb_cores=nb_cores, scheduler=name), tiled_gemm_ptg(*pm),
         cpu_cuda_device)
    np.testing.assert_allclose(pm[2].to_dense(), jm[2].to_dense(),
                               **FP32_TOL)
    assert cpu_cuda_device.executed_tasks == accel_device.executed_tasks \
        == 3 * 3 * 2


def _chain(P, coll, n=9):
    p = P.PTGBuilder("chain", N=n, A=coll)
    t = p.task("T", i=P.span(0, lambda g, l: g.N - 1))
    f = t.flow("V", P.RW)
    f.input(data=("A", lambda g, l: (0,)), guard=lambda g, l: l.i == 0)
    f.input(pred=("T", "V", lambda g, l: {"i": l.i - 1}),
            guard=lambda g, l: l.i > 0)
    f.output(succ=("T", "V", lambda g, l: {"i": l.i + 1}),
             guard=lambda g, l: l.i < g.N - 1)
    f.output(data=("A", lambda g, l: (0,)),
             guard=lambda g, l: l.i == g.N - 1)

    @t.body
    def body(es, task, g, l):
        c = task.flow_data("V")
        c.value = c.value + 1

    return p.build()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("nb_cores", [0, 3])
def test_host_pools_match_jax(dynamic_only, name, nb_cores):
    traces = []
    for P, C in ((jptg, JContext), (ptg, Context)):
        trace = []
        ep = port_ep_pool if P is ptg else jax_ep_pool
        _run(C(nb_cores=nb_cores, scheduler=name),
             ep(6, 7, lambda d, n: trace.append((d, n))).build())
        traces.append(trace)
    assert sorted(traces[0]) == sorted(traces[1]) == sorted(
        (d, n) for d in range(7) for n in range(6))
    for n in range(6):     # each lane in dependency order
        assert [d for d, m in traces[1] if m == n] == list(range(7))
    jc = JDict("A", dtt=JTileType((1,), np.float32))
    pc = DictCollection("A", dtt=TileType((1,), torch.float32))
    _run(JContext(nb_cores=nb_cores, scheduler=name), _chain(jptg, jc))
    _run(Context(nb_cores=nb_cores, scheduler=name), _chain(ptg, pc))
    assert float(pc.data_of(0).newest_copy().value[0]) \
        == float(jc.data_of(0).newest_copy().value[0]) == 9.0


def _prio_pool(P, order):
    """Twelve S tasks with scrambled priorities, each releasing two U
    tasks with other priorities (one takes the stream's next-task slot,
    the other goes to the scheduler)."""
    p = P.PTGBuilder("prio", N=12)
    s = p.task("S", i=P.span(0, lambda g, l: g.N - 1))
    s.priority(lambda g, l: (l.i * 7) % 5)
    s.flow("ctl", P.CTL).output(succ=("U", "ctl", lambda g, l: [
        {"i": 2 * l.i}, {"i": 2 * l.i + 1}]))
    s.body(lambda es, task, g, l: order.append(("S", l.i)))
    u = p.task("U", i=P.span(0, lambda g, l: 2 * g.N - 1))
    u.priority(lambda g, l: (l.i * 5) % 7 - 3)
    u.flow("ctl", P.CTL).input(
        pred=("S", "ctl", lambda g, l: {"i": l.i // 2}))
    u.body(lambda es, task, g, l: order.append(("U", l.i)))
    return p.build()


@pytest.mark.parametrize("name", NAMES)
def test_caller_driven_order_matches_jax(dynamic_only, name):
    """One caller-driven thread: every module is deterministic there, so
    the executed order must be the JAX package's, task for task; the
    priority modules (ap/spq/ip/pbq/ltq/lhq) order by priority."""
    orders = []
    for P, C in ((jptg, JContext), (ptg, Context)):
        order = []
        _run(C(nb_cores=0, scheduler=name), _prio_pool(P, order))
        orders.append(order)
    assert orders[1] == orders[0]
    assert sorted(orders[1]) == sorted(
        [("S", i) for i in range(12)] + [("U", i) for i in range(24)])
    if name in ("ap", "spq"):
        # highest priority first: the first task is an S of priority 4
        assert orders[1][0][0] == "S" and (orders[1][0][1] * 7) % 5 == 4


@pytest.mark.parametrize("name,native_lifo", [("ll", True), ("llp", False)])
def test_ll_queues(name, native_lifo):
    assert native.available(), native.build_error
    for C in (Context, JContext):
        ctx = C(nb_cores=2, scheduler=name)
        try:
            q = ctx.streams[0].sched_private
            kind = type(q).__name__
            if native_lifo:
                assert kind == "NativeLifo", kind
            else:
                assert isinstance(q, tuple) and isinstance(q[0], deque)
        finally:
            ctx.fini()
    ctx = Context(nb_cores=2, scheduler=name)
    assert type(ctx.scheduler).__name__ == ("LLModule" if name == "ll"
                                            else "LLPModule")
    assert (type(ctx.streams[0].sched_private) is native.NativeLifo) \
        == native_lifo
    ctx.fini()
