"""JDF: the textual PTG front-end.

Port of ``parsec_tpu/ptg/jdf.py`` (the reference's JDF compiler,
``parsec/interfaces/ptg/ptg-compiler``) as a parser into
:class:`~parsec_tpu_torch.ptg.dsl.PTGBuilder`: both front-ends share one
backend.  Expressions and bodies are Python; the JDF structure stays:

Comments: ``/* block */`` and *full-line* ``//`` outside BODY/prologue
regions only — trailing ``// …`` after code is not a comment because ``//``
is Python floor division inside expressions; bodies use Python ``#``.

.. code-block:: none

    /* comments, and full-line // comments */
    %{
    # python prologue: names defined here are visible to every
    # expression and body
    %}

    NT    [type = int]          /* scalar global, bound at build()    */
    V     [type = data]         /* data-collection global             */

    T(i)                        /* task class + parameters            */
      i = 0 .. NT-1             /* execution-space range (inclusive)  */
      : V(i)                    /* data affinity -> owning rank       */
      RW A <- (i == 0) ? V(0) : A T(i-1)     /* guarded input arrows  */
           -> (i <  NT-1) ? A T(i+1)         /* guarded output arrows */
           -> (i == NT-1) ? V(0)
      ; NT - i                  /* priority expression                */
    BODY [type = cuda  dyld = gemm]
    END
    BODY
      A += 1       # python body: flow names bound to the tiles
    END

Grammar notes (vs ``parsec.y``): execution-space ranges are ``lo .. hi`` or
``lo .. hi .. step``; arrow targets are ``FLOW Class(args)`` (task dep) or
``DataGlobal(args)`` (collection read/write-back); guards are
``(expr) ? target`` or ``(expr) ? target : target``.  A dep may carry
``[type = NAME]``: ``NAME`` resolves (through the build bindings or the
prologue) to a :class:`~parsec_tpu_torch.data.datatype.TileType`, and the
consumer of that edge observes the datum converted to it
(:mod:`parsec_tpu_torch.data.reshape`); ``[type_remote = LR displ_remote =
...]`` with ``LR`` a :class:`~parsec_tpu_torch.data.datatype.WireRegion`
cuts what a remote consumer receives.  ``<- NEW [type=T]`` allocates a
fresh tile of type ``T``; ``<- NULL`` declares an explicitly data-less
input and ``-> NULL`` drops the datum.

A ``BODY [type = X dyld = K]`` registers a chore for device type ``X``
running the kernel-registry entry ``K``; the port's card is ``cuda``.  A
chore whose device type has no registered device passes the task to its
next chore (``HOOK_RETURN_NEXT``), so a body of ``type = tpu`` falls
through to the Python body.  Python bodies see each data flow's tile as a
torch tensor (a CPU tensor where they run on the host): numpy operators
such as ``A += 1`` and ``Z += X @ Y`` act on it in place, and a body that
rebinds a flow name to a numpy array has it written back as a tensor.  A
body that calls a numpy function expecting an ``ndarray`` result of its
own (``np.copyto``, ``out=`` arguments) must use the torch form instead.

Sanity checking mirrors ``jdf_sanity_checks`` (``jdf.h:68-86``): unknown
target classes/flows/collections, missing ranges, CTL flows with data
targets, malformed arrows and unknown ``%option`` names raise
:class:`JDFError` at parse or build time, with the JAX package's messages.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np
import torch

from ..data.datatype import to_tensor
from .dsl import CTL, READ, RW, WRITE, PTGBuilder, PTGTaskpool

_ACCESS = {"RW": RW, "READ": READ, "WRITE": WRITE, "CTL": CTL}


class JDFError(ValueError):
    """Parse-time or build-time JDF rejection (sanity-check failure)."""


# ---------------------------------------------------------------------------
# lexical helpers
# ---------------------------------------------------------------------------

_RE_BODY_KW = re.compile(r"\s*BODY(\s|\[|$)")


def _strip_comments(text: str) -> str:
    """Remove ``/* */`` blocks and full-line ``//`` comments — but never
    inside BODY…END regions, whose content is Python (where ``//`` is floor
    division and ``#`` comments naturally).  Trailing ``// …`` after code is
    deliberately NOT a comment for the same reason."""
    out: list[str] = []
    in_body = False
    in_block = False
    for line in text.split("\n"):
        if in_body:
            out.append(line)
            if line.strip() == "END":
                in_body = False
            continue
        kept: list[str] = []
        j = 0
        while j < len(line):
            if in_block:
                end = line.find("*/", j)
                if end < 0:
                    j = len(line)
                else:
                    in_block = False
                    j = end + 2
                continue
            start = line.find("/*", j)
            if start < 0:
                kept.append(line[j:])
                break
            kept.append(line[j:start])
            in_block = True
            j = start + 2
        s = "".join(kept)
        if s.lstrip().startswith("//"):
            s = ""
        if _RE_BODY_KW.match(s):
            in_body = True
        out.append(s)
    return "\n".join(out)


def _split_top(s: str, sep: str) -> list[str]:
    """Split on ``sep`` at paren depth 0 (guards/ternaries contain parens)."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


# ---------------------------------------------------------------------------
# parsed representation
# ---------------------------------------------------------------------------

class _Arrow:
    __slots__ = ("direction", "guard_src", "then_tgt", "else_tgt", "line",
                 "props")

    def __init__(self, direction, guard_src, then_tgt, else_tgt, line,
                 props=None) -> None:
        self.direction = direction      # "in" | "out"
        self.guard_src = guard_src      # str | None
        self.then_tgt = then_tgt        # (kind, name, flow, args_src)
        self.else_tgt = else_tgt        # same | None
        self.line = line
        self.props = props or {}        # [type=NAME ...] dep properties


class _FlowDecl:
    __slots__ = ("access", "name", "arrows")

    def __init__(self, access, name) -> None:
        self.access = access
        self.name = name
        self.arrows: list[_Arrow] = []


class _TaskDecl:
    __slots__ = ("name", "params", "ranges", "affinity_src", "flows",
                 "priority_src", "bodies", "line", "props", "simcost_src",
                 "derived")

    def __init__(self, name, params, line, props=None) -> None:
        self.name = name
        self.params = params
        self.ranges: dict[str, tuple[str, str, str | None]] = {}
        self.affinity_src: tuple[str, str] | None = None  # (collection, args)
        self.flows: list[_FlowDecl] = []
        self.priority_src: str | None = None
        self.bodies: list[tuple[dict, str]] = []          # (props, code)
        self.line = line
        self.props = props or {}        # UD overrides (jdf.h:185-210)
        self.simcost_src: str | None = None
        # derived locals (`m = t % lmt` lines whose name is not a param,
        # cf. jdf_variable_list entries without a param): evaluated in
        # declaration order on top of the bound params, visible to
        # affinity/guards/arrow args/priority/bodies
        self.derived: dict[str, str] = {}


class JDF:
    """A parsed JDF template; :meth:`build` binds globals and materializes
    the taskpool (the ``parsec_<name>_new`` generated-constructor analog)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.prologue_src: list[str] = []
        self.globals_decl: dict[str, dict] = {}   # name -> props
        self.tasks: dict[str, _TaskDecl] = {}
        self.options: dict[str, str] = {}         # %option lines
        # rewrite notes from jdf_c.resolve_read_chains (empty when the
        # pass hasn't run or found nothing to forward)
        self.read_chain_notes: list[str] = []

    # -- build ---------------------------------------------------------------
    def build(self, **bindings: Any) -> PTGTaskpool:
        ns: dict[str, Any] = {}
        for src in self.prologue_src:
            exec(compile(src, f"<jdf:{self.name}:prologue>", "exec"), ns)
        ns.pop("__builtins__", None)
        # <math.h> equivalents for expressions (reference JDFs compute
        # e.g. reduction-tree depths with ceil/log in global defaults);
        # prologue definitions win.  NOT `pow`: math.pow would shadow the
        # int-preserving builtin every Python-grammar JDF already sees
        import math as _math
        for _mn in ("ceil", "floor", "log", "log2", "sqrt", "fabs"):
            ns.setdefault(_mn, getattr(_math, _mn))
        self._last_ns = ns    # introspection: tests/tools peek at prologue state

        for gname, props in self.globals_decl.items():
            if gname in bindings:
                continue
            if "default" in props:
                env = dict(ns)
                env.update(bindings)
                bindings[gname] = eval(
                    compile(props["default"], "<jdf:default>", "eval"), env)
            else:
                raise JDFError(f"global '{gname}' needs a value at build()")
        for gname in bindings:
            if gname not in self.globals_decl:
                raise JDFError(f"build() got unknown global '{gname}'")

        self._sanity_check()
        builder = PTGBuilder(self.name, **bindings)

        def resolve(pname: str, val: str, line: int) -> Any:
            """Look a UD property value up in the prologue/bindings."""
            env = dict(ns)
            env.update(bindings)
            if val not in env:
                raise JDFError(
                    f"line {line}: [{pname} = {val}] does not name a "
                    f"prologue or build() binding")
            return env[val]

        # pool-level %option lines (jdf.h UD pool properties)
        for oname, oval in self.options.items():
            if oname == "nb_local_tasks_fn":
                builder.option(nb_local_tasks_fn=resolve(oname, oval, 0))
            elif oname == "termdet":
                builder.option(termdet=oval)
            else:
                raise JDFError(f"unknown %option '{oname}'")

        def expr(src: str) -> Callable:
            code = compile(src.strip(), f"<jdf:{self.name}>", "eval")

            def fn(g, l):
                # everything goes in eval's *globals*: comprehension scopes
                # inside the expression cannot see an eval-locals mapping
                env = dict(ns)
                env.update(vars(g))
                env.update(vars(l))
                return eval(code, env)
            return fn

        for td in self.tasks.values():
            params = {}
            for p in td.params:
                lo, hi, step = td.ranges[p]
                params[p] = _mk_range(expr(lo), expr(hi),
                                      expr(step) if step else None)
            tcb = builder.task(td.name, **params)

            # derived locals layer on top of the bound params: every
            # expression of this task evaluates them (in order) first
            dcodes = [(dn, compile(src.strip(),
                                   f"<jdf:{self.name}:{td.name}:{dn}>",
                                   "eval"))
                      for dn, src in td.derived.items()]

            def texpr(src: str, _dc=dcodes) -> Callable:
                code = compile(src.strip(), f"<jdf:{self.name}>", "eval")

                def fn(g, l):
                    env = dict(ns)
                    env.update(vars(g))
                    env.update(vars(l))
                    for dn, c in _dc:
                        env[dn] = eval(c, env)
                    return eval(code, env)
                return fn

            if td.affinity_src is not None:
                coll, args = td.affinity_src
                key_fn = _mk_key(texpr, args)
                tcb.affinity(coll, key_fn)
            if td.priority_src is not None:
                tcb.priority(texpr(td.priority_src))
            if td.simcost_src is not None:
                tcb.simcost(texpr(td.simcost_src))
            for pname, pval in td.props.items():
                fn = resolve(pname, str(pval), td.line)
                if pname == "make_key_fn":
                    tcb.make_key(fn)
                elif pname == "find_deps_fn":
                    tcb.find_deps(fn)
                elif pname == "startup_fn":
                    tcb.startup(fn)
                elif pname == "hash_struct":
                    from ..runtime.task import KeyHashStruct
                    if isinstance(fn, KeyHashStruct):
                        tcb._hash_struct = fn
                    elif isinstance(fn, dict):
                        tcb.hash_struct(**fn)
                    else:
                        raise JDFError(
                            f"line {td.line}: hash_struct must name a "
                            f"KeyHashStruct or a dict of key_* callables")
                else:
                    raise JDFError(
                        f"line {td.line}: unknown task property "
                        f"'{pname}'")
            typeenv = dict(ns)
            typeenv.update(bindings)
            for fd in td.flows:
                fb = tcb.flow(fd.name, fd.access)
                for ar in fd.arrows:
                    self._attach_arrow(fb, ar, fd, td, texpr, typeenv)
            for props, code_str in td.bodies:
                btype = props.get("type", "python")
                evaluate = None
                if "evaluate" in props:
                    # BODY [evaluate = fn]: chore-selection hook from the
                    # prologue, (es, task) -> HOOK_RETURN_* (jdf.h
                    # JDF_BODY_PROP_EVALUATE)
                    evaluate = resolve("evaluate", str(props["evaluate"]),
                                       td.line)
                if btype in ("python", "cpu"):
                    tcb.body(_mk_body(code_str, ns, td.name, dcodes),
                             evaluate=evaluate)
                else:
                    dyld = props.get("dyld")
                    if not dyld:
                        raise JDFError(
                            f"{td.name}: device BODY needs dyld = <kernel>")
                    tcb.body(device=btype, dyld=dyld, evaluate=evaluate)
        return builder.build()

    # -- arrows --------------------------------------------------------------
    def _attach_arrow(self, fb, ar: _Arrow, fd: _FlowDecl, td: _TaskDecl,
                      expr, typeenv: dict | None = None) -> None:
        guard = expr(ar.guard_src) if ar.guard_src else None
        neg = (lambda g, l: not guard(g, l)) if guard else None
        dtt = None
        tname = ar.props.get("type")
        if tname is not None:
            from ..data.datatype import TileType
            dtt = (typeenv or {}).get(tname)
            if not isinstance(dtt, TileType):
                raise JDFError(
                    f"line {ar.line}: [type={tname}] must name a TileType "
                    f"global or prologue binding (got "
                    f"{type(dtt).__name__})")
        # [type_remote = NAME, displ_remote = expr]: partial-tile wire
        # datatype (stencil_1D.jdf:83-92 role).  NAME resolves to a
        # WireRegion (prologue/build binding); displ_remote is a BYTE
        # offset expression evaluated per task instance; the edge ships
        # region.slices(displ) to remote peers instead of the full tile.
        wire = None
        wname = ar.props.get("type_remote")
        if wname is not None and isinstance(wname, str):
            from ..data.datatype import WireRegion
            region = (typeenv or {}).get(wname)
            if isinstance(region, WireRegion):
                displ_fn = (expr(str(ar.props["displ_remote"]))
                            if "displ_remote" in ar.props else None)

                def wire(g, l, _r=region, _d=displ_fn):
                    return _r.slices(int(_d(g, l)) if _d else 0)
            # any other binding (unbound FULL, a TileType doubling as the
            # full-tile arena — the reference's `type = DEFAULT
            # type_remote = DEFAULT` idiom, merge_sort.jdf) keeps the
            # full-tile wire, the reference's default datatype behavior
        for tgt, gfn in ((ar.then_tgt, guard),
                        (ar.else_tgt, neg if ar.else_tgt else None)):
            if tgt is None:
                continue
            kind, name, flow, args_src = tgt
            if kind in ("new", "null"):
                if ar.direction == "out":
                    if kind == "new":
                        raise JDFError(
                            f"line {ar.line}: NEW is an input-only target")
                    continue    # `-> NULL`: the datum is dropped — no dep
                if kind == "new" and fd.access == CTL:
                    # CTL flows carry no data: nothing to allocate.  Reject
                    # here with the line number instead of letting the DSL
                    # layer surface a raw ValueError.
                    raise JDFError(
                        f"line {ar.line}: CTL flow {fd.name} cannot take "
                        f"<- NEW (control flows carry no data)")
                if kind == "new" and dtt is None:
                    # NEW allocates at the flow's declared type; JDF flows
                    # declare it through the arrow's [type=...] property
                    raise JDFError(
                        f"line {ar.line}: NEW needs a [type = ...] "
                        f"property naming the tile type to allocate")
                fb.input(new=(kind == "new"), null=(kind == "null"),
                         guard=gfn, dtt=dtt)
                continue
            if kind == "task":
                t_decl = self.tasks[name]
                args = [a.strip() for a in _split_top(args_src, ",")]
                if len(args) != len(t_decl.params):
                    raise JDFError(
                        f"line {ar.line}: {name}() takes "
                        f"{len(t_decl.params)} params, got {len(args)}")
                # range args (`0 .. NB .. 2`): the arrow fans out (output)
                # or joins N arrivals (input; CTL only)
                arg_fns: list = []
                any_rng = False
                for a in args:
                    parts = [p.strip() for p in a.split("..")]
                    if len(parts) == 1:
                        arg_fns.append((expr(a), None, None))
                    elif len(parts) in (2, 3):
                        any_rng = True
                        arg_fns.append(
                            (expr(parts[0]), expr(parts[1]),
                             expr(parts[2]) if len(parts) == 3 else None))
                    else:
                        raise JDFError(
                            f"line {ar.line}: bad range argument {a!r}")
                pnames = list(t_decl.params)

                def params_fn(g, l, _fns=arg_fns, _ps=pnames,
                              _rng=any_rng):
                    import itertools as _it
                    axes = []
                    for lo_fn, hi_fn, step_fn in _fns:
                        if hi_fn is None:
                            axes.append((lo_fn(g, l),))
                        else:
                            step = int(step_fn(g, l)) if step_fn else 1
                            axes.append(range(
                                int(lo_fn(g, l)),
                                int(hi_fn(g, l)) + (1 if step > 0 else -1),
                                step))
                    if not _rng:
                        return {p: v[0] for p, v in zip(_ps, axes)}
                    return tuple(dict(zip(_ps, combo))
                                 for combo in _it.product(*axes))

                ref = (name, flow, params_fn)
                if ar.direction == "in":
                    if any_rng and fd.access != CTL:
                        raise JDFError(
                            f"line {ar.line}: range input on data flow "
                            f"{fd.name} — N producers for one datum is "
                            f"nondeterministic; range fan-in is CTL-only")
                    # [type_remote] on an INPUT arrow is accepted for
                    # reference fidelity but carries no runtime action:
                    # the wire view is a producer-side (output dep)
                    # decision; the consumer recognizes a region payload
                    # by shape (the body's local-vs-remote branch)
                    fb.input(pred=ref, guard=gfn, dtt=dtt, ranged=any_rng)
                else:
                    fb.output(succ=ref, guard=gfn, dtt=dtt, wire=wire)
            else:   # data
                if fd.access == CTL:
                    raise JDFError(
                        f"line {ar.line}: CTL flow {fd.name} cannot "
                        f"reference data {name}()")
                key_fn = _mk_key(expr, args_src)
                if ar.direction == "in":
                    fb.input(data=(name, key_fn), guard=gfn, dtt=dtt)
                else:
                    fb.output(data=(name, key_fn), guard=gfn, dtt=dtt)

    # -- sanity (jdf_sanity_checks analog) -----------------------------------
    def _sanity_check(self) -> None:
        data_globals = {g for g, p in self.globals_decl.items()
                        if p.get("type") == "data"}
        for td in self.tasks.values():
            for p in td.params:
                if p not in td.ranges:
                    raise JDFError(
                        f"{td.name}: parameter '{p}' has no range line")
            for p in td.ranges:
                if p not in td.params:
                    raise JDFError(
                        f"{td.name}: range for '{p}' which is not a "
                        f"parameter")
            if td.affinity_src is not None \
                    and td.affinity_src[0] not in data_globals:
                raise JDFError(
                    f"{td.name}: affinity references '{td.affinity_src[0]}' "
                    f"which is not a [type = data] global")
            if not td.bodies:
                raise JDFError(f"{td.name}: no BODY")
            seen_flows = set()
            for fd in td.flows:
                if fd.name in seen_flows:
                    raise JDFError(f"{td.name}: duplicate flow {fd.name}")
                seen_flows.add(fd.name)
                for ar in fd.arrows:
                    for tgt in (ar.then_tgt, ar.else_tgt):
                        if tgt is None:
                            continue
                        kind, name, flow, _args = tgt
                        if kind in ("new", "null"):
                            continue
                        if kind == "task":
                            if name not in self.tasks:
                                raise JDFError(
                                    f"line {ar.line}: unknown task class "
                                    f"'{name}'")
                            t_flows = {f.name for f in
                                       self.tasks[name].flows}
                            if flow not in t_flows:
                                raise JDFError(
                                    f"line {ar.line}: {name} has no flow "
                                    f"'{flow}'")
                        elif name not in data_globals:
                            raise JDFError(
                                f"line {ar.line}: '{name}' is neither a "
                                f"task class (missing flow name?) nor a "
                                f"[type = data] global")
                    if fd.access == WRITE and ar.direction == "in" \
                            and any(t is not None and t[0] == "task"
                                    for t in (ar.then_tgt, ar.else_tgt)):
                        raise JDFError(
                            f"line {ar.line}: WRITE flow {fd.name} cannot "
                            f"have a task input dependency")


def _mk_range(lo_fn, hi_fn, step_fn):
    def rng(g, l):
        step = int(step_fn(g, l)) if step_fn else 1
        hi = int(hi_fn(g, l))
        # JDF ranges are inclusive of hi in the step direction
        return range(int(lo_fn(g, l)), hi + (1 if step > 0 else -1), step)
    return rng


def _mk_key(expr, args_src: str):
    fns = [expr(a) for a in _split_top(args_src, ",") if a.strip()]

    def key_fn(g, l):
        return tuple(fn(g, l) for fn in fns)
    return key_fn


def _mk_body(code_str: str, prologue_ns: dict, tname: str,
             derived_codes: list | None = None):
    code = compile(_dedent(code_str), f"<jdf:{tname}:body>", "exec")

    def body(es, task, g, l):
        env = dict(prologue_ns)
        env.update(vars(g))
        env.update(vars(l))
        for dn, c in derived_codes or ():
            env[dn] = eval(c, env)
        env["es"], env["task"] = es, task
        before = {}
        for f in task.task_class.flows:
            if f.is_ctl:
                continue
            copy = task.data[f.flow_index]
            before[f.name] = copy.value if copy is not None else None
            env[f.name] = before[f.name]
        exec(code, env)
        for f in task.task_class.flows:   # functional rebinds write back
            if f.is_ctl:
                continue
            copy = task.data[f.flow_index]
            if copy is not None and env.get(f.name) is not before[f.name]:
                v = env[f.name]
                if not isinstance(v, torch.Tensor):
                    v = to_tensor(np.asarray(v))
                copy.value = v

    return body


def _dedent(code: str) -> str:
    import textwrap
    return textwrap.dedent(code)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

_RE_GLOBAL = re.compile(r"^(\w+)\s*(?:=\s*(?P<default>[^\[]+?))?\s*"
                        r"(?:\[(?P<props>[^\]]*)\])?\s*$")
_RE_TASK = re.compile(r"^(\w+)\s*\(([\w\s,]*)\)\s*"
                      r"(?:\[(?P<props>[^\]]*)\])?\s*$")
_RE_RANGE = re.compile(r"^(\w+)\s*=\s*(.+)$")
_RE_FLOW = re.compile(r"^(RW|READ|WRITE|CTL)\s+(\w+)\s*(.*)$")
_RE_TARGET_TASK = re.compile(r"^(\w+)\s+(\w+)\s*\((.*)\)$")
_RE_TARGET_DATA = re.compile(r"^(\w+)\s*\((.*)\)$")


_RE_PROP_KEY = re.compile(r"(\w+)\s*(=)?\s*")
_RE_PROP_BARE = re.compile(r"[\w.\-*%/+]+")


def scan_balanced(s: str, i: int) -> int:
    """Index of the ``)`` closing the paren group opening at ``s[i]``
    (arbitrary depth; ``len(s) - 1`` when unterminated).  Shared by the
    native and C-syntax property scanners."""
    depth, j, n = 0, i, len(s)
    while j < n:
        if s[j] == "(":
            depth += 1
        elif s[j] == ")":
            depth -= 1
            if depth == 0:
                return j
        j += 1
    return n - 1


def _parse_props(s: str | None) -> dict:
    """``key = value`` pairs and bare flags.  Values are either a
    balanced parenthesized expression at ARBITRARY depth (displ_remote
    formulas — a regex depth cap here once misparsed a deep expression
    as a flag and shipped the wrong ghost columns) or a spaceless token
    run."""
    out: dict = {}
    if not s:
        return out
    i, n = 0, len(s)
    while i < n:
        m = _RE_PROP_KEY.match(s, i)
        if m is None:
            i += 1
            continue
        key, has_eq = m.group(1), m.group(2)
        i = m.end()
        if not has_eq:
            out[key] = True
            continue
        if i < n and s[i] == "(":
            j = scan_balanced(s, i)
            out[key] = s[i:j + 1]
            i = j + 1
        else:
            mv = _RE_PROP_BARE.match(s, i)
            out[key] = mv.group(0) if mv else True
            i = mv.end() if mv else i
    return out


def unparse_jdf(jdf: JDF) -> str:
    """Render a parsed :class:`JDF` back to JDF text (``jdf_unparse``,
    ``jdf.h:137`` / ``jdf_unparse.c``): the round-trip tool — the output
    re-parses to an equivalent template (prologues, %options, globals,
    task properties, execution space, derived locals, affinity, SIMCOST,
    flows with guarded/ranged arrows and dep properties, priorities,
    bodies)."""
    out: list[str] = []
    for src in jdf.prologue_src:
        out.append("%{" + src + "%}")
    for oname, oval in jdf.options.items():
        out.append(f"%option {oname} = {oval}")
    if jdf.options:
        out.append("")
    for gname, props in jdf.globals_decl.items():
        line = gname
        if "default" in props:
            line += f" = {props['default']}"
        rest = [f"{k} = {v}" if v is not True else k
                for k, v in props.items() if k != "default"]
        if rest:
            line += "  [" + "  ".join(rest) + "]"
        out.append(line)
    out.append("")

    def tgt(t: tuple) -> str:
        kind, name, flow, args = t
        if kind == "new":
            return "NEW"
        if kind == "null":
            return "NULL"
        if kind == "task":
            return f"{flow} {name}({args})"
        return f"{name}({args})"

    for td in jdf.tasks.values():
        head = f"{td.name}({', '.join(td.params)})"
        if td.props:
            head += "  [" + "  ".join(f"{k} = {v}"
                                      for k, v in td.props.items()) + "]"
        out.append(head)
        for p in td.params:
            lo, hi, step = td.ranges[p]
            if step is not None:
                out.append(f"  {p} = {lo} .. {hi} .. {step}")
            elif lo == hi:
                out.append(f"  {p} = {lo}")
            else:
                out.append(f"  {p} = {lo} .. {hi}")
        for dn, src in td.derived.items():
            out.append(f"  {dn} = {src}")
        if td.affinity_src is not None:
            out.append(f"  : {td.affinity_src[0]}({td.affinity_src[1]})")
        if td.simcost_src is not None:
            out.append(f"  SIMCOST {td.simcost_src}")
        for fd in td.flows:
            acc = {RW: "RW", READ: "READ", WRITE: "WRITE",
                   CTL: "CTL"}[fd.access]
            prefix = f"  {acc} {fd.name} "
            pad = " " * len(prefix)
            first = True
            for ar in fd.arrows:
                arrow = "<-" if ar.direction == "in" else "->"
                seg = tgt(ar.then_tgt)
                if ar.guard_src is not None:
                    # guard_src is stored parenthesized (the grammar
                    # requires it) — emit verbatim
                    seg = f"{ar.guard_src} ? {seg}"
                    if ar.else_tgt is not None:
                        seg += f" : {tgt(ar.else_tgt)}"
                if ar.props:
                    seg += "  [" + "  ".join(
                        f"{k} = {v}" if v is not True else k
                        for k, v in ar.props.items()) + "]"
                out.append((prefix if first else pad) + f"{arrow} {seg}")
                first = False
            if first:
                out.append(prefix.rstrip())
        if td.priority_src is not None:
            out.append(f"  ; {td.priority_src}")
        for props, code in td.bodies:
            line = "BODY"
            if props:
                line += " [" + "  ".join(f"{k} = {v}" if v is not True else k
                                         for k, v in props.items()) + "]"
            out.append(line)
            out.append(code)
            out.append("END")
        out.append("")
    return "\n".join(out)


def load_jdf(path: Any, name: str | None = None) -> JDF:
    """Parse a ``.jdf`` file from disk (the ``parsec_ptgpp <file>`` entry)."""
    import pathlib
    p = pathlib.Path(path)
    return parse_jdf(p.read_text(), name or p.stem)


def parse_jdf(text: str, name: str = "jdf") -> JDF:
    jdf = JDF(name)

    # %{ ... %} prologues come out first: their content is Python and must
    # not be touched by JDF comment stripping
    def grab_prologue(m):
        jdf.prologue_src.append(m.group(1))
        return "\n" * m.group(0).count("\n")
    text = re.sub(r"%\{(.*?)%\}", grab_prologue, text, flags=re.S)
    text = _strip_comments(text)

    lines = text.split("\n")
    i, n = 0, len(lines)
    cur: _TaskDecl | None = None
    cur_flow: _FlowDecl | None = None

    def err(msg):
        raise JDFError(f"line {i + 1}: {msg}")

    while i < n:
        raw = lines[i]
        line = raw.strip()
        if not line:
            i += 1
            continue

        if line.startswith("%"):
            # %option name = value (pool-level UD properties); other
            # %-directives are accepted and ignored
            if line.startswith("%option"):
                jdf.options.update(
                    {k: v for k, v in _parse_props(line[7:]).items()})
            i += 1
            continue

        if _RE_BODY_KW.match(line):
            if cur is None:
                err("BODY outside a task class")
            props = _parse_props(
                line[4:].strip().strip("[]") if "[" in line else None)
            body_lines = []
            i += 1
            while i < n and lines[i].strip() != "END":
                body_lines.append(lines[i])
                i += 1
            if i >= n:
                raise JDFError(f"{cur.name}: BODY without END")
            cur.bodies.append((props, "\n".join(body_lines)))
            cur_flow = None
            i += 1
            continue

        m = _RE_TASK.match(line)
        if m and ".." not in line and not line.startswith(":"):
            cur = _TaskDecl(
                m.group(1),
                [p.strip() for p in m.group(2).split(",") if p.strip()],
                i + 1,
                props=_parse_props(m.group("props")))
            if cur.name in jdf.tasks:
                err(f"duplicate task class {cur.name}")
            jdf.tasks[cur.name] = cur
            cur_flow = None
            i += 1
            continue

        if cur is None:
            mg = _RE_GLOBAL.match(line)
            if not mg:
                err(f"bad global declaration: {line!r}")
            props = _parse_props(mg.group("props"))
            if mg.group("default"):
                props["default"] = mg.group("default").strip()
            jdf.globals_decl[mg.group(1)] = props
            i += 1
            continue

        # inside a task class ------------------------------------------------
        if line.startswith(":"):
            md = _RE_TARGET_DATA.match(line[1:].strip())
            if not md:
                err(f"bad affinity: {line!r}")
            cur.affinity_src = (md.group(1), md.group(2))
            cur_flow = None
            i += 1
            continue

        if line.startswith(";"):
            cur.priority_src = line[1:].strip()
            cur_flow = None
            i += 1
            continue

        if line.startswith("SIMCOST"):
            # simulation-cost expression (parsec.y:635-641, PARSEC_SIM)
            cur.simcost_src = line[len("SIMCOST"):].strip()
            if not cur.simcost_src:
                err("SIMCOST needs an expression")
            cur_flow = None
            i += 1
            continue

        if line.startswith("<-") or line.startswith("->"):
            if cur_flow is None:
                err("dependency arrow outside a flow declaration")
            _parse_arrows(cur_flow, line, i + 1, err)
            i += 1
            continue

        mf = _RE_FLOW.match(line)
        if mf:
            cur_flow = _FlowDecl(_ACCESS[mf.group(1)], mf.group(2))
            cur.flows.append(cur_flow)
            rest = mf.group(3).strip()
            if rest:
                _parse_arrows(cur_flow, rest, i + 1, err)
            i += 1
            continue

        mr = _RE_RANGE.match(line)
        if mr and mr.group(1) in cur.params:
            parts = [p.strip() for p in mr.group(2).split("..")]
            if len(parts) == 1:
                # fixed value: a singleton range
                cur.ranges[mr.group(1)] = (parts[0], parts[0], None)
            elif len(parts) == 2:
                cur.ranges[mr.group(1)] = (parts[0], parts[1], None)
            elif len(parts) == 3:
                cur.ranges[mr.group(1)] = (parts[0], parts[1], parts[2])
            else:
                err(f"bad range: {line!r}")
            cur_flow = None
            i += 1
            continue

        if mr and ".." not in mr.group(2):
            # derived local: name = expr (the stencil's `m = t % lmt`,
            # Ex05's `loc = k + n` form)
            cur.derived[mr.group(1)] = mr.group(2).strip()
            cur_flow = None
            i += 1
            continue

        err(f"cannot parse: {line!r}")

    return jdf


def _parse_arrows(fd: _FlowDecl, s: str, lineno: int, err) -> None:
    """Parse one line of ``<- ...`` / ``-> ...`` arrow segments (a line may
    chain several, as JDF flows often put the first arrow on the flow line)."""
    # tokenize into (direction, segment) pairs by splitting on top-level
    # <- / -> occurrences
    segs: list[tuple[str, str]] = []
    depth = 0
    j = 0
    start = None
    direction = None
    while j < len(s):
        ch = s[j]
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if depth == 0 and s[j:j + 2] in ("<-", "->"):
            if direction is not None:
                segs.append((direction, s[start:j].strip()))
            direction = "in" if s[j] == "<" else "out"
            j += 2
            start = j
            continue
        j += 1
    if direction is None:
        err(f"expected <- or -> in {s!r}")
    segs.append((direction, s[start:].strip()))

    for direction, seg in segs:
        if not seg:
            err("empty dependency arrow")
        # trailing [type=NAME ...] dep properties (reshape-on-dep): the
        # first paren-top-level '[' opens them (targets only use parens)
        props = {}
        depth = 0
        bpos = -1
        for j, ch in enumerate(seg):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "[" and depth == 0:
                bpos = j
                break
        if bpos >= 0:
            if not seg.rstrip().endswith("]"):
                err(f"unterminated dep properties in {seg!r}")
            props = _parse_props(seg[bpos + 1:seg.rindex("]")])
            seg = seg[:bpos].strip()
        guard_src = None
        then_src, else_src = seg, None
        q = _split_top(seg, "?")
        if len(q) == 2:
            guard_src = q[0].strip()
            if not (guard_src.startswith("(") and guard_src.endswith(")")):
                err(f"guard must be parenthesized: {guard_src!r}")
            branches = _split_top(q[1], ":")
            then_src = branches[0].strip()
            if len(branches) == 2:
                else_src = branches[1].strip()
            elif len(branches) > 2:
                err(f"too many ':' in {seg!r}")
        elif len(q) > 2:
            err(f"too many '?' in {seg!r}")
        then_tgt = _parse_target(then_src, err)
        else_tgt = _parse_target(else_src, err) if else_src else None
        fd.arrows.append(_Arrow(direction, guard_src, then_tgt, else_tgt,
                                lineno, props))


def _parse_target(s: str, err) -> tuple:
    if s == "NEW":          # fresh-tile allocation (Ex03's `<- NEW`)
        return ("new", None, None, None)
    if s == "NULL":         # explicit no-data endpoint
        return ("null", None, None, None)
    mt = _RE_TARGET_TASK.match(s)
    if mt:
        return ("task", mt.group(2), mt.group(1), mt.group(3))
    md = _RE_TARGET_DATA.match(s)
    if md:
        return ("data", md.group(1), None, md.group(2))
    err(f"cannot parse dependency target {s!r}")
