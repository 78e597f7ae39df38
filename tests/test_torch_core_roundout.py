"""The rest of the port's core against the JAX package's: the rwlock, the
mempool (with a task as a pooled element), the info slots, the MCA
repository's priority query, the output streams with ``fatal`` and
``show_help``, the param sources (``--mca`` parsing, the param file,
``dump``), ``key_to_string``, ``Device.load_add`` and the version.

Each runs the same sequence in both packages and compares what it
returns; everything here is exact (no arithmetic).
"""

import importlib
import threading
import time

import pytest

from parsec_tpu.core import info as jinfo
from parsec_tpu.core import mca as jmca
from parsec_tpu.core import mempool as jmempool
from parsec_tpu.core import output as joutput
from parsec_tpu.core import rwlock as jrwlock
from parsec_tpu_torch.core import info as pinfo
from parsec_tpu_torch.core import mca as pmca
from parsec_tpu_torch.core import mempool as pmempool
from parsec_tpu_torch.core import output as poutput
from parsec_tpu_torch.core import rwlock as prwlock

# the modules themselves: the JAX package's core re-exports the registry
# under the name ``params``
jparams_mod = importlib.import_module("parsec_tpu.core.params")
pparams_mod = importlib.import_module("parsec_tpu_torch.core.params")


# ---------------------------------------------------------------------------
# rwlock
# ---------------------------------------------------------------------------

def _rwlock_trace(mod):
    """Two readers hold the lock; a writer waits; a third reader arriving
    after the writer waits behind it (writer preference)."""
    lock = mod.RWLock()
    log, lk = [], threading.Lock()
    r_in = threading.Barrier(3)
    release = threading.Event()

    def note(x):
        with lk:
            log.append(x)

    def reader(tag, barrier=None):
        with lock.read():
            note(f"{tag}+")
            if barrier is not None:
                barrier.wait()
                release.wait(5)
        note(f"{tag}-")

    def writer():
        with lock.write():
            note("w+")
        note("w-")

    rs = [threading.Thread(target=reader, args=(f"r{i}", r_in))
          for i in range(2)]
    for t in rs:
        t.start()
    r_in.wait()
    w = threading.Thread(target=writer)
    w.start()
    while not lock._writers_waiting:
        time.sleep(0.001)
    late = threading.Thread(target=reader, args=("r2",))
    late.start()
    time.sleep(0.05)
    blocked = "r2+" not in log
    release.set()
    for t in (*rs, w, late):
        t.join(10)
    order = [x for x in log if x in ("w+", "r2+")]
    return blocked, order, lock._readers, lock._writer


def test_the_rwlock_behaves_like_the_jax_one():
    got = _rwlock_trace(prwlock)
    assert got == _rwlock_trace(jrwlock)
    assert got == (True, ["w+", "r2+"], 0, False)


# ---------------------------------------------------------------------------
# mempool
# ---------------------------------------------------------------------------

class _Obj:
    __slots__ = ("v", "_mempool_owner")

    def __init__(self):
        self.v = 0


def _mempool_trace(mod):
    made = []

    def factory():
        made.append(1)
        return _Obj()

    pool = mod.Mempool(factory, reset=lambda o: setattr(o, "v", 0))
    a, b = pool.allocate(), pool.allocate()
    a.v = 5
    out = [pool.stats()]
    # b freed from another thread goes back to its owner's list
    t = threading.Thread(target=pool.free, args=(b,))
    t.start()
    t.join()
    pool.free(a)
    out.append(pool.stats())
    c = pool.allocate()
    out += [c.v, len(made), pool.stats()]
    other = []
    th = threading.Thread(target=lambda: other.append(pool.allocate()))
    th.start()
    th.join()
    out += [len(made), pool.stats()["thread_pools"],
            other[0]._mempool_owner is not c._mempool_owner]
    pool.free(_Obj())         # no owner yet: this thread's list takes it
    out.append(pool.stats())
    return out


def test_the_mempool_behaves_like_the_jax_one():
    assert _mempool_trace(pmempool) == _mempool_trace(jmempool)


def test_a_task_is_a_pooled_element():
    """The port's ``Task`` carries an owner slot, as the JAX task does."""
    from parsec_tpu_torch.runtime.task import Task
    assert "_mempool_owner" in Task.__slots__
    pool = pmempool.Mempool(lambda: Task.__new__(Task))
    t = pool.allocate()
    assert t._mempool_owner is pool.thread_pool()
    pool.free(t)
    assert pool.stats()["free_elements"] == 1


# ---------------------------------------------------------------------------
# info slots
# ---------------------------------------------------------------------------

def _info_trace(mod):
    reg = mod.Info()
    reg.register("handle", lambda owner: ("h", owner))
    reg.register("empty")
    arr = mod.InfoObjectArray(owner="dev0")
    first = reg.get(arr, "handle")
    again = reg.get(arr, "handle") is first
    out = [first, again, reg.get(arr, "empty"), sorted(reg.names())]
    reg.unregister("empty")
    out.append(sorted(reg.names()))
    with pytest.raises(KeyError):
        reg.get(arr, "empty")
    out.append(sorted(n for n in ("per_device_infos", "per_stream_infos")
                      if isinstance(getattr(mod, n), mod.Info)))
    return out


def test_info_slots_behave_like_the_jax_ones():
    assert _info_trace(pinfo) == _info_trace(jinfo)


def test_a_device_carries_its_info_slots_and_load():
    from parsec_tpu_torch.device.device import CPUDevice, DeviceRegistry
    from parsec_tpu_torch.runtime.task import TaskClass
    d = CPUDevice()
    pinfo.per_device_infos.register("probe", lambda dev: dev.name)
    try:
        assert pinfo.per_device_infos.get(d.infos, "probe") == "cpu"
    finally:
        pinfo.per_device_infos.unregister("probe")
    reg = DeviceRegistry()
    a, b = reg.add(CPUDevice()), reg.add(CPUDevice())

    class T:
        task_class = TaskClass("X", params=[], flows=[], chores=[])

    assert reg.best_device(T(), "cpu") is a
    a.load_add(2.0)
    assert a.device_load == 2.0 and reg.best_device(T(), "cpu") is b
    T.task_class.time_estimate = lambda task, dev: 0.0 if dev is a else 5.0
    assert reg.best_device(T(), "cpu") is a       # 2.0 + 0 < 0 + 5.0
    a.load_add(-2.0)
    assert a.device_load == 0.0


# ---------------------------------------------------------------------------
# the MCA repository
# ---------------------------------------------------------------------------

def _mca_trace(mod, params):
    repo = mod.ComponentRepository()

    def comp(n, prio, ok=True):
        cls = type(f"C{n}", (mod.Component,), {
            "type_name": "zz_fam", "name": n, "priority": prio,
            "query": lambda self, ctx=None, ok=ok: ok})
        return repo.register(cls())

    comp("low", 1)
    comp("high", 9, ok=False)
    comp("mid", 5)
    out = [[c.name for c in repo.components_of_type("zz_fam")],
           repo.query("zz_fam").name, repo.query("zz_fam",
                                                 requested="high").name]
    with pytest.raises(LookupError):
        repo.query("zz_fam", requested="nope")
    with pytest.raises(LookupError):
        repo.query("zz_empty")
    params.register("zz_fam", "", "a test family's selection")
    with params.overrides({"zz_fam": "low"}):
        out.append(repo.query("zz_fam").name)
    out.append(repo.query("zz_fam").name)
    return out


def test_the_mca_query_selects_like_the_jax_one():
    from parsec_tpu.core.params import params as jp
    from parsec_tpu_torch.core.params import params as pp
    got = _mca_trace(pmca, pp)
    assert got == _mca_trace(jmca, jp)
    assert got == [["high", "mid", "low"], "mid", "high", "low", "mid"]


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

def test_output_streams_fatal_and_show_help_behave_like_the_jax_ones(
        caplog):
    for mod, root in ((poutput, "parsec_tpu_torch"), (joutput, "parsec_tpu")):
        st = mod.output_open("zz_stream", verbose=2)
        assert mod.output_open("zz_stream") is st and st.verbose == 2
        assert mod.output_open("zz_stream", verbose=0).verbose == 0
        st.verbose = 2
        logger = __import__("logging").getLogger(root)
        logger.propagate = True
        try:
            with caplog.at_level("DEBUG"):
                caplog.clear()
                mod.debug_verbose(1, st, "shown %d", 1)
                mod.debug_verbose(3, "zz_stream", "hidden")
                assert [r.getMessage() for r in caplog.records] == ["shown 1"]
            with pytest.raises(mod.FatalError, match="bad 7"):
                mod.fatal("bad %d", 7)
            mod.show_help_flush()
            assert mod.show_help("t", "s", "first") is True
            assert mod.show_help("t", "s", "again") is False
            assert mod.show_help("t", "u", "other") is True
            assert mod.show_help_flush() == {("t", "s"): 2, ("t", "u"): 1}
            assert mod.show_help_flush() == {}
        finally:
            logger.propagate = False


def test_a_stream_takes_its_verbosity_from_the_params():
    """A new stream's level defaults to ``debug_verbose``."""
    for mod, reg in ((poutput, pparams_mod.params),
                     (joutput, jparams_mod.params)):
        mod.output_open("zz_probe")          # registers debug_verbose
        with reg.overrides({"debug_verbose": 4}):
            assert mod.output_open("zz_level").verbose == 4
        assert mod.output_open("zz_probe").verbose == 0


# ---------------------------------------------------------------------------
# params: --mca, the param file, dump
# ---------------------------------------------------------------------------

def _params_trace(mod, tmp_path, monkeypatch):
    reg = mod.ParamRegistry()
    reg.register("a_int", 3, "an int")
    reg.register("b_str", "x", "a string")
    reg.register("c_flag", False, "a flag")
    reg.register("d_float", 0.5, "a float")
    rest = reg.parse_cmdline(["prog", "--mca", "a_int", "7", "arg",
                              "--parsec-mca", "c_flag", "on", "--mca"])
    pf = tmp_path / f"{mod.__name__}.conf"
    pf.write_text("# comment\nb_str = from-file  # trailing\n"
                  "a_int = 99\n\nd_float=2.5\n")
    reg.parse_paramfile(str(pf))
    monkeypatch.setenv("PARSEC_MCA_d_float", "4.25")
    reg.register("e_late", 1, "registered after the sources")
    monkeypatch.setenv("PARSEC_MCA_e_late", "2")
    reg.parse_cmdline([])
    out = [rest, {n: (reg.lookup(n).value, reg.lookup(n).source)
                  for n in ("a_int", "b_str", "c_flag", "d_float", "e_late")}]
    reg.set("b_str", "pinned")
    reg.parse_cmdline(["--mca", "b_str", "cli"])
    out.append((reg.get("b_str"), reg.lookup("b_str").source))
    out.append(reg.dump())
    out.append(mod.register.__name__)
    return out


def test_param_sources_and_dump_equal_the_jax_registry(tmp_path,
                                                       monkeypatch):
    got = _params_trace(pparams_mod, tmp_path, monkeypatch)
    monkeypatch.delenv("PARSEC_MCA_d_float")
    monkeypatch.delenv("PARSEC_MCA_e_late")
    want = _params_trace(jparams_mod, tmp_path, monkeypatch)
    assert got == want
    assert got[0] == ["prog", "arg", "--mca"]
    assert got[1]["a_int"] == (7, "cli") and got[1]["b_str"] == (
        "from-file", "file")
    assert got[1]["d_float"] == (4.25, "env")
    assert got[2] == ("pinned", "set")


def test_the_module_register_shorthand_reads_the_value():
    assert pparams_mod.register("zz_shorthand", 11, "a test param") == 11
    assert pparams_mod.params.get("zz_shorthand") == 11


# ---------------------------------------------------------------------------
# key_to_string and the version
# ---------------------------------------------------------------------------

def test_key_to_string_and_the_version_equal_the_jax_ones():
    import parsec_tpu.version as jv
    from parsec_tpu.data_dist.collection import DictCollection as JDict
    from parsec_tpu_torch import version as pv
    from parsec_tpu_torch.data_dist.collection import DictCollection
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    assert DictCollection("A").key_to_string(1, "x", (2,)) \
        == JDict("A").key_to_string(1, "x", (2,)) == "A(1, x, (2,))"
    assert TiledMatrix("M", 4, 4, 2, 2).key_to_string(0, 1) == "M(0, 1)"
    assert (pv.__version__, pv.API_VERSION) == (jv.__version__,
                                                jv.API_VERSION)
