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

A taskpool may carry ``local_traceables``: batched incarnations scoped to
it (a stencil's weights differ per build), which the lowering looks up
before the process-wide registry.  ``output(wire=...)`` names the
sub-view of the tile a remote successor receives (the comm layer cuts it
before the send); same-rank successors share the whole tile.  On a
multi-rank context a pool counts and starts only the tasks whose affinity
lies on this rank (``nb_local_tasks``, ``startup``).
:meth:`PTGTaskpool.validate` verifies the built graph without running a
body (:mod:`parsec_tpu_torch.analysis.graphcheck`).

A class may override its key (``make_key``), its tracker location
(``find_deps``), its key hashing (``hash_struct``) and its startup
enumeration (``startup``), carry a simulated cost (``simcost``) and
device stage hooks (``stage_hooks``); an input may be a ranged fan-in
(``ranged=True``, CTL only, counted toward a goal); the builder's
``option`` sets the pool's ``nb_local_tasks_fn`` and its termination
detector.  The JDF text front-ends (:mod:`parsec_tpu_torch.ptg.jdf` and
:mod:`parsec_tpu_torch.ptg.jdf_c`) parse into this builder.
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

    @property
    def __dict__(self):   # vars(g), as the JDF expression evaluator reads
        return self._d


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
              new: bool = False, null: bool = False,
              ranged: bool = False) -> "FlowBuilder":
        """Add an input arrow: ``pred=(class, flow, params_fn)`` from a
        task, ``data=(collection, key_fn)`` from a collection, ``new=True``
        for a fresh tile of the flow's type, ``null=True`` for no data.
        ``ranged=True`` marks a fan-in whose ``params_fn`` returns a
        sequence of predecessor instances, each expected to arrive (the
        JDF ``<- ctl T(k, 0 .. NB .. 2)``; CTL joins only)."""
        if new and dtt is None and self.dtt is None:
            raise ValueError(
                f"flow {self.name}: NEW needs a tile type to allocate "
                f"(pass dtt= on the arrow or declare it on the flow)")
        if ranged and self.access != CTL:
            # N producers racing one datum slot is nondeterministic
            raise ValueError(
                f"flow {self.name}: ranged fan-in input on a data flow; "
                f"range inputs are CTL-only")
        self._deps_in.append(self._tcb._mk_dep(pred, data, guard, dtt,
                                               new=new, null=null,
                                               ranged=ranged))
        if new and dtt is not None and self.dtt is None:
            self.dtt = dtt
        return self

    def output(self, succ: tuple | None = None, data: tuple | None = None,
               guard: Callable | None = None, dtt: Any = None,
               wire: Any = None) -> "FlowBuilder":
        """Add an output arrow to a task (``succ``) or a collection
        (``data``).  ``wire`` names the sub-view of the tile a remote
        successor would receive: slices, or ``wire_fn(g, l) -> slices``."""
        self._deps_out.append(self._tcb._mk_dep(succ, data, guard, dtt,
                                                wire=wire))
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
        # user-defined overrides and the simulated cost
        self._make_key: Callable | None = None
        self._find_deps: Callable | None = None
        self._hash_struct: Any = None
        self._startup: Callable | None = None
        self._simcost: Callable | None = None
        self._stage_in_hook: Callable | None = None
        self._stage_out_hook: Callable | None = None

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

    def make_key(self, fn: Callable) -> "TaskClassBuilder":
        """``make_key_fn``: the task key ``fn(g, l)`` (any hashable; a
        non-tuple is wrapped by the runtime)."""
        g_ns = self._ptg._g_ns
        self._make_key = lambda locals_: fn(g_ns(), _ns(locals_))
        return self

    def find_deps(self, fn: Callable) -> "TaskClassBuilder":
        """``find_deps_fn``: the tracker's identity
        ``fn(taskpool, g, l)``."""
        g_ns = self._ptg._g_ns
        self._find_deps = lambda tp, locals_: fn(tp, g_ns(), _ns(locals_))
        return self

    def hash_struct(self, key_hash: Callable | None = None,
                    key_equal: Callable | None = None,
                    key_print: Callable | None = None) -> "TaskClassBuilder":
        """``hash_struct``: user hashing, equality and printing of the
        raw key tuples."""
        from ..runtime.task import KeyHashStruct
        self._hash_struct = KeyHashStruct(key_hash, key_equal, key_print)
        return self

    def startup(self, fn: Callable) -> "TaskClassBuilder":
        """``startup_fn``: ``fn(taskpool, context, g) -> iterable of locals
        dicts`` naming the initially-ready instances (in place of the
        empty-IN-mask scan)."""
        self._startup = fn
        return self

    def simcost(self, fn: Callable) -> "TaskClassBuilder":
        """``SIMCOST``: a simulated cost ``fn(g, l) -> float``; the pool
        then tracks ``largest_simulation_date``."""
        g_ns = self._ptg._g_ns
        self._simcost = lambda locals_: fn(g_ns(), _ns(locals_))
        return self

    def stage_hooks(self, stage_in: Callable | None = None,
                    stage_out: Callable | None = None
                    ) -> "TaskClassBuilder":
        """User transfer hooks of this class's device tasks, each
        ``fn(device, task)`` in place of the default stage-in or
        stage-out; only the hooks given are updated."""
        if stage_in is not None:
            self._stage_in_hook = stage_in
        if stage_out is not None:
            self._stage_out_hook = stage_out
        return self

    def body(self, fn: Callable | None = None, device: str = "cpu",
             dyld: str | None = None,
             evaluate: Callable | None = None) -> Any:
        """Attach a body for ``device``.  CPU bodies are callables
        ``fn(es, task, g, l)``; device bodies may instead name a
        kernel-registry entry via ``dyld``.  A ``"recursive"`` body is a
        host callable too: it spawns a nested pool through
        :func:`~parsec_tpu_torch.runtime.recursive.recursive_call` and
        returns its ASYNC.  Usable as a decorator."""
        def attach(f: Callable | None) -> Callable | None:
            if device in ("cpu", "recursive"):
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

        # the compiled-DAG executor (runtime/dagrun.py) bypasses this
        # wrapper and calls the body with a namespace it builds once per
        # task
        hook.ptg_body = f
        hook.ptg_gns = g_ns
        return hook

    def _mk_dep(self, ref: tuple | None, data: tuple | None,
                guard: Callable | None, dtt: Any,
                new: bool = False, null: bool = False,
                ranged: bool = False, wire: Any = None) -> Dep:
        g_ns = self._ptg._g_ns
        gfn = None
        if guard is not None:
            gfn = lambda locals_: guard(g_ns(), _ns(locals_))
        wfn = wire
        if callable(wire):
            wfn = lambda locals_: wire(g_ns(), _ns(locals_))
        if new or null:
            return Dep(guard=gfn, dtt=dtt, null=null)
        if ref is not None:
            cls_name, flow_name, params_fn = ref
            return Dep(guard=gfn, target_class=cls_name,
                       target_flow=flow_name,
                       target_params=lambda locals_: params_fn(
                           g_ns(), _ns(locals_)), dtt=dtt, ranged=ranged,
                       wire=wfn)
        if data is not None:
            collection, key_fn = data
            dc_get = self._ptg._dc_getter(collection)

            def data_ref(locals_: dict) -> tuple:
                key = key_fn(g_ns(), _ns(locals_))
                return dc_get(), key if isinstance(key, tuple) else (key,)

            return Dep(guard=gfn, data_ref=data_ref, dtt=dtt, wire=wfn)
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
                       time_estimate=self._time_estimate,
                       make_key_fn=self._make_key,
                       find_deps_fn=self._find_deps,
                       hash_struct=self._hash_struct,
                       startup_fn=self._startup, simcost=self._simcost)
        # the device module reads the transfer overrides per dispatch
        if self._stage_in_hook is not None:
            tc.stage_in_hook = self._stage_in_hook
        if self._stage_out_hook is not None:
            tc.stage_out_hook = self._stage_out_hook
        g_ns = self._ptg._g_ns
        ranges = self.param_ranges

        class _Poison:
            def __getattr__(self, k):
                raise LookupError(k)

            def __getitem__(self, k):
                raise LookupError(k)

        def extents_fn() -> tuple | None:
            """The static box of the space for the index-array dep
            tier: every range locals-independent with unit step, else
            None."""
            try:
                st = tuple(rngfn(g_ns(), _Poison())
                           for rngfn in ranges.values())
            except (LookupError, AttributeError, TypeError):
                return None
            if all(isinstance(r, range) and r.step == 1 for r in st):
                return tuple((r.start, r.stop) for r in st)
            return None

        tc.space_extents_fn = extents_fn

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
        # build-scoped batched incarnations, by dyld name (the lowering
        # consults them before the process-wide registry)
        self.local_traceables: dict[str, Any] = {}

    @property
    def globals(self) -> Any:
        """The bound globals as a live view (``g.NT`` and ``g["NT"]``); UD
        override functions read problem sizes through it."""
        return self._builder._g_ns()

    def validate(self, nb_ranks: int | None = None,
                 raise_on_error: bool = True) -> Any:
        """Statically verify this pool's dataflow (graphcheck): edge
        symmetry, access consistency, cycles, tile and rank bounds,
        without executing a body.  Returns the
        :class:`~parsec_tpu_torch.analysis.graphcheck.GraphReport`; raises
        :class:`~parsec_tpu_torch.analysis.graphcheck.GraphCheckError` on
        an error-severity finding when ``raise_on_error``."""
        from ..analysis import check_ptg
        report = check_ptg(self, nb_ranks=nb_ranks)
        if raise_on_error:
            report.raise_if_failed()
        return report

    def _foreign(self, context: Any) -> Callable[[Any, dict], bool]:
        """``foreign(tc, locals)``: whether the task runs on another rank
        of ``context`` (never, on one rank or for a rank-private pool)."""
        if context is None or self.local_only or context.nb_ranks <= 1:
            return lambda tc, locals_: False
        from ..runtime.scheduling import _rank_of_task

        def foreign(tc: TaskClass, locals_: dict) -> bool:
            rank = _rank_of_task(tc, locals_)
            return rank is not None and rank != context.my_rank

        return foreign

    def nb_local_tasks(self) -> int:
        """Tasks whose affinity lands on this rank; a pool-level
        ``nb_local_tasks_fn`` replaces the scan."""
        if self._builder._nb_local_tasks_fn is not None:
            return int(self._builder._nb_local_tasks_fn(self))
        foreign = self._foreign(self.context)
        return sum(sum(1 for l in self._tc_builders[tc.name]._enumerate_space()
                       if not foreign(tc, l))
                   for tc in self.task_classes)

    def startup(self, context: Any) -> list:
        """Initially-ready local tasks: those whose IN-dep mask is empty."""
        from ..runtime.scheduling import resolve_data_inputs
        foreign = self._foreign(context)
        out = []
        for tc in self.task_classes:
            tcb = self._tc_builders[tc.name]
            if tc.startup_fn is not None:
                # UD startup: the user names the initially-ready instances
                space = tc.startup_fn(self, context, tcb._ptg._g_ns())
            else:
                space = (l for l in tcb._enumerate_space()
                         if tc.input_dep_mask(l) == 0)
            for locals_ in space:
                if foreign(tc, locals_):
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
        self._nb_local_tasks_fn: Callable | None = None
        self._termdet: str | None = None

    def option(self, nb_local_tasks_fn: Callable | None = None,
               termdet: str | None = None) -> "PTGBuilder":
        """Pool options (the JDF ``%option``): ``nb_local_tasks_fn(taskpool)
        -> int`` replaces the execution-space count; ``termdet`` names the
        pool's termination detector."""
        if nb_local_tasks_fn is not None:
            self._nb_local_tasks_fn = nb_local_tasks_fn
        if termdet is not None:
            self._termdet = termdet
        return self

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
        tp.termdet_name = self._termdet
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
