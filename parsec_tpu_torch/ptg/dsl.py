"""PTG: the Parameterized Task Graph DSL, algebraic builder form.

Port of ``parsec_tpu/ptg/dsl.py`` (the reference's JDF front-end as an
embedded API): a taskpool is described by task classes with

- parameters spanning an execution space (ranges that may depend on
  globals and on previously-bound parameters),
- a data affinity, a priority and a time estimate,
- flows (``READ``/``RW``/``WRITE``/``CTL``) with guarded input/output
  arrows to other task classes or to a collection,
- per-device bodies (chores): host callables ``fn(es, task, g, l)`` on the
  CPU, or a kernel-registry name (``dyld=``) for a device.

Expressions are callables ``fn(g, l)`` over read-only namespaces of
globals and locals.  The builder materializes
:class:`~parsec_tpu_torch.runtime.task.TaskClass` objects and a
:class:`PTGTaskpool` whose startup enumerates the execution space and
schedules the tasks with an empty IN-dep mask.

Left out: the JDF text front-ends, user-defined key/dep/startup
overrides, SIMCOST, stage hooks, wire regions, ranged inputs, pool
options, ``validate`` (graphcheck) and multi-rank affinity filtering.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Iterable

from ..data.data import ACCESS_READ, ACCESS_RW, ACCESS_WRITE
from ..runtime.task import FLOW_CTL, HOOK_RETURN_DONE, Chore, Dep, Flow, Task
from ..runtime.task import TaskClass
from ..runtime.taskpool import Taskpool

READ = ACCESS_READ
WRITE = ACCESS_WRITE
RW = ACCESS_RW
CTL = FLOW_CTL


class _NS(SimpleNamespace):
    def __getitem__(self, k):
        return getattr(self, k)


def _ns(d: dict) -> _NS:
    return _NS(**d)


class _DictNS:
    """Live attribute view over the globals dict."""

    __slots__ = ("_d",)

    def __init__(self, d: dict) -> None:
        object.__setattr__(self, "_d", d)

    def __getattr__(self, k):
        try:
            return self._d[k]
        except KeyError:
            raise AttributeError(k) from None

    def __getitem__(self, k):
        return self._d[k]


class FlowBuilder:
    def __init__(self, tcb: "TaskClassBuilder", name: str, access: Any,
                 dtt: Any = None) -> None:
        self._tcb = tcb
        self.name = name
        self.access = access
        self.dtt = dtt
        self._deps_in: list[Dep] = []
        self._deps_out: list[Dep] = []

    def input(self, pred: tuple | None = None, data: tuple | None = None,
              guard: Callable | None = None, dtt: Any = None,
              new: bool = False, null: bool = False) -> "FlowBuilder":
        """Add an input arrow: ``pred=(class, flow, params_fn)`` from a
        task, ``data=(collection, key_fn)`` from a collection, ``new=True``
        for a fresh tile of the flow's type, ``null=True`` for no data."""
        if new and dtt is None and self.dtt is None:
            raise ValueError(f"flow {self.name}: NEW needs a tile type")
        self._deps_in.append(self._tcb._mk_dep(pred, data, guard, dtt,
                                               new=new, null=null))
        if new and dtt is not None and self.dtt is None:
            self.dtt = dtt
        return self

    def output(self, succ: tuple | None = None, data: tuple | None = None,
               guard: Callable | None = None,
               dtt: Any = None) -> "FlowBuilder":
        self._deps_out.append(self._tcb._mk_dep(succ, data, guard, dtt))
        return self

    def _build(self) -> Flow:
        return Flow(self.name, self.access, deps_in=self._deps_in,
                    deps_out=self._deps_out, dtt=self.dtt)


class TaskClassBuilder:
    def __init__(self, ptg: "PTGBuilder", name: str,
                 params: dict[str, Callable]) -> None:
        self._ptg = ptg
        self.name = name
        self.param_ranges = dict(params)
        self._flows: list[FlowBuilder] = []
        self._chores: list[Chore] = []
        self._affinity: Callable | None = None
        self._priority: Callable | None = None
        self._time_estimate: Callable | None = None

    def affinity(self, collection: Any, key_fn: Callable) -> "TaskClassBuilder":
        dc_get = self._ptg._dc_getter(collection)
        g_ns = self._ptg._g_ns
        self._affinity = lambda locals_: (dc_get(),
                                          key_fn(g_ns(), _ns(locals_)))
        return self

    def flow(self, name: str, access: Any, dtt: Any = None) -> FlowBuilder:
        fb = FlowBuilder(self, name, access, dtt)
        self._flows.append(fb)
        return fb

    def priority(self, fn: Callable) -> "TaskClassBuilder":
        g_ns = self._ptg._g_ns
        self._priority = lambda locals_: int(fn(g_ns(), _ns(locals_)))
        return self

    def time_estimate(self, fn: Callable) -> "TaskClassBuilder":
        """``fn(task, device) -> seconds``, fed to best-device selection."""
        self._time_estimate = fn
        return self

    def body(self, fn: Callable | None = None, device: str = "cpu",
             dyld: str | None = None,
             evaluate: Callable | None = None) -> Any:
        """Attach a body for ``device``.  CPU bodies are callables
        ``fn(es, task, g, l)``; device bodies may instead name a
        kernel-registry entry via ``dyld``.  Usable as a decorator."""
        def attach(f: Callable | None) -> Callable | None:
            if device == "cpu":
                hook = self._wrap_cpu_body(f)
            else:
                from ..device.hooks import make_device_hook
                hook = make_device_hook(device, f, dyld, self._ptg)
            self._chores.append(Chore(device, hook=hook, evaluate=evaluate,
                                      dyld=dyld))
            return f

        if fn is None and dyld is not None:
            return attach(None)
        if fn is None:
            return attach
        return attach(fn)

    def _wrap_cpu_body(self, f: Callable) -> Callable:
        g_ns = self._ptg._g_ns

        def hook(es: Any, task: Any) -> int:
            rc = f(es, task, g_ns(), _ns(task.locals))
            return HOOK_RETURN_DONE if rc is None else rc

        return hook

    def _mk_dep(self, ref: tuple | None, data: tuple | None,
                guard: Callable | None, dtt: Any,
                new: bool = False, null: bool = False) -> Dep:
        g_ns = self._ptg._g_ns
        gfn = None
        if guard is not None:
            gfn = lambda locals_: guard(g_ns(), _ns(locals_))
        if new or null:
            return Dep(guard=gfn, dtt=dtt, null=null)
        if ref is not None:
            cls_name, flow_name, params_fn = ref
            return Dep(guard=gfn, target_class=cls_name,
                       target_flow=flow_name,
                       target_params=lambda locals_: params_fn(
                           g_ns(), _ns(locals_)), dtt=dtt)
        if data is not None:
            collection, key_fn = data
            dc_get = self._ptg._dc_getter(collection)

            def data_ref(locals_: dict) -> tuple:
                key = key_fn(g_ns(), _ns(locals_))
                return dc_get(), key if isinstance(key, tuple) else (key,)

            return Dep(guard=gfn, data_ref=data_ref, dtt=dtt)
        raise ValueError("dep needs a task ref or a data ref")

    def _enumerate_space(self) -> Iterable[dict]:
        """Every locals assignment of the execution space."""
        g = self._ptg._g_ns()
        names = list(self.param_ranges)

        def rec(i: int, partial: dict):
            if i == len(names):
                yield dict(partial)
                return
            name = names[i]
            for v in self.param_ranges[name](g, _ns(partial)):
                partial[name] = v
                yield from rec(i + 1, partial)
            partial.pop(name, None)

        yield from rec(0, {})

    def _build(self) -> TaskClass:
        tc = TaskClass(self.name, params=list(self.param_ranges),
                       flows=[fb._build() for fb in self._flows],
                       chores=list(self._chores), affinity=self._affinity,
                       priority=self._priority,
                       time_estimate=self._time_estimate)
        g_ns = self._ptg._g_ns
        ranges = self.param_ranges

        def in_space(locals_: dict) -> bool:
            """Parameters validate in declaration order against their
            ranges (the generated bounds check)."""
            g = g_ns()
            partial: dict = {}
            for pname, rngfn in ranges.items():
                v = locals_.get(pname)
                if v is None or v not in rngfn(g, _ns(partial)):
                    return False
                partial[pname] = v
            return True

        tc.in_space = in_space
        return tc


class PTGTaskpool(Taskpool):
    """A taskpool generated from a PTG description."""

    def __init__(self, name: str, builder: "PTGBuilder") -> None:
        super().__init__(name=name)
        self._builder = builder
        self._tc_builders: dict[str, TaskClassBuilder] = {}

    @property
    def globals(self) -> dict:
        return self._builder.globals

    def nb_local_tasks(self) -> int:
        return sum(sum(1 for _ in self._tc_builders[tc.name]._enumerate_space())
                   for tc in self.task_classes)

    def startup(self, context: Any) -> list:
        """Initially-ready tasks: those whose IN-dep mask is empty."""
        from ..runtime.scheduling import resolve_data_inputs
        out = []
        for tc in self.task_classes:
            for locals_ in self._tc_builders[tc.name]._enumerate_space():
                if tc.input_dep_mask(locals_):
                    continue
                prio = tc.priority(locals_) if tc.priority else 0
                t = Task(self, tc, dict(locals_), priority=prio)
                t.status = "ready"
                resolve_data_inputs(t)  # snapshot collection reads now
                out.append(t)
        return out


class PTGBuilder:
    """Top-level builder: globals + task classes -> :class:`PTGTaskpool`."""

    def __init__(self, name: str, **globals_) -> None:
        self.name = name
        self.globals = dict(globals_)
        self._classes: list[TaskClassBuilder] = []
        self._g_view = _DictNS(self.globals)

    def _g_ns(self) -> _DictNS:
        return self._g_view

    def _dc_getter(self, collection: Any) -> Callable[[], Any]:
        if isinstance(collection, str):
            return lambda: self.globals[collection]
        return lambda: collection

    def task(self, name: str, **params: Callable) -> TaskClassBuilder:
        tcb = TaskClassBuilder(self, name, params)
        self._classes.append(tcb)
        return tcb

    def build(self) -> PTGTaskpool:
        tp = PTGTaskpool(self.name, self)
        for tcb in self._classes:
            tc = tp.add_task_class(tcb._build())
            tp._tc_builders[tc.name] = tcb
        return tp


def span(low: Callable | int, high: Callable | int, step: int = 1) -> Callable:
    """Inclusive range ``low .. high`` like JDF execution-space ranges."""

    def rng(g: Any, l: Any) -> range:
        lo = low(g, l) if callable(low) else low
        hi = high(g, l) if callable(high) else high
        return range(lo, hi + 1, step)

    return rng
