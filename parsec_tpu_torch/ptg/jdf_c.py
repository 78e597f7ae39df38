"""Mechanical C-syntax JDF ingestion: reference ``.jdf`` files, directly.

Port of ``parsec_tpu/ptg/jdf_c.py``, text for text: the converted source
it produces equals the JAX converter's character for character.  The
reference's JDF front-end lexes C expressions and splices C bodies
(``parsec.l`` / ``parsec.y``); the port's textual grammar
(:mod:`parsec_tpu_torch.ptg.jdf`) is Python-expression-based.  This
module bridges them *mechanically*: :func:`convert_c_jdf` rewrites a
C-syntax JDF's **structure** — globals, execution spaces, derived locals,
affinities, guarded/ranged arrows, priorities, ``%option`` lines — into
the Python-expression grammar, and :func:`load_c_jdf` parses the result.

What converts:

- C prologues/epilogues (``extern "C" %{ ... %}``) are dropped — they hold
  includes and helper C functions; Python helpers go in ``bodies``/build
  bindings instead.
- ``%{ return EXPR; %}`` inline fragments become ``(EXPR)``.
- Expressions: ``&&``/``||``/``!`` → ``and``/``or``/``not``; ``->`` struct
  derefs become attribute access with a field map translating reference
  descriptor fields to this repo's collections (``lmt``→``mt``,
  ``super.myrank``→``myrank``, ...); bare ``/`` becomes floor division
  (JDF index arithmetic is integral in C).
- Globals: ``[type = "int"]``-style quoted props unquote;
  pointer-to-descriptor types become ``[type = data]``; ``default=``
  moves into the ``NAME = value`` position.  Collections referenced by
  affinities/data arrows but declared only in C code are synthesized as
  ``[type = data]`` globals.
- ``<- NEW`` arrows gain ``[type = DTT_DEFAULT]``; bind ``DTT_DEFAULT``
  to a :class:`~parsec_tpu_torch.data.datatype.TileType` at ``build()``.
- ``%option`` lines keep the options this grammar knows and drop the
  rest (``no_taskpool_instance``, ``dynamic`` — process-model artifacts).

C task bodies: the **mechanical statement subset** auto-converts —
pointer-cast flow aliases (``int *Aint = (int*)A;``), deref
assignments/compound assignments (``*Aint = k+1``, ``*Aint += 1``),
plain declarations, ``if``/``else`` blocks, ``return``, and ``printf``
(dropped: output side effects carry no dataflow) — which covers the
reference's Ex02/Ex05/Ex06/Ex07 bodies verbatim.  Anything outside the
subset (C function calls, loops, pointer arithmetic) falls back: pass
``bodies`` mapping task names to Python body source (flow names in
scope, like any JDF body); unmapped unconvertible bodies become
``pass`` — structure-only ingestion, which is what graph/protocol
tests need.

Out-of-space successor arrows (``(k < NT) ? T PING(k+1)`` at
``k = NT-1``, ``rtt.jdf:16``) rely on the generated bounds check; the
runtime's execution-space membership drop covers them.

Read-chain forwarding: jdf2c's symbolic dataflow analysis forwards an
input arrow that names a predecessor READ flow with *no reciprocal
output arrow* (``<- A FANOUT(r-1, t)``, ``a2a.jdf:58``) to that flow's
data origin.  :func:`resolve_read_chains` does the mechanical version of
the same fixpoint after parsing: a READ flow whose single input is
``(base) ? D(args) : F SELF(shifted)`` with ``args`` invariant under the
shift resolves to ``D(args)``; any input referencing a reciprocal-less
READ flow is rewritten to that resolved origin.  ``load_c_jdf`` applies
it by default, so the reference's ``a2a.jdf`` ingests and drains all
rounds verbatim.
"""

from __future__ import annotations

import re
from typing import Any

from .jdf import JDF, parse_jdf, scan_balanced

# reference descriptor field -> this repo's collection attribute
_FIELD_MAP = {
    "super.myrank": "myrank",
    "super.nodes": "nodes",
    "super.mt": "mt",
    "super.nt": "nt",
    "lmt": "mt",
    "lnt": "nt",
    "llm": "lm",
    "lln": "ln",
}

_KNOWN_OPTIONS = ("nb_local_tasks_fn", "termdet")


def convert_expr(s: str, field_map: dict[str, str] | None = None) -> str:
    """One C expression → Python expression (structure-level subset)."""
    fm = dict(_FIELD_MAP)
    if field_map:
        fm.update(field_map)
    s = s.replace("&&", " and ").replace("||", " or ")
    s = re.sub(r"!(?![=])", " not ", s)
    s = s.replace("->", ".")
    # C casts over a call: (int)ceil(...) -> int(ceil(...)) — the shape
    # reference defaults use (reduce_col.jdf's tree depth); math names
    # resolve from the build env (jdf.py exposes <math.h> equivalents)
    s = re.sub(
        r"\(\s*(?:int|long|unsigned|size_t)\s*\)\s*"
        r"(\w+\s*\([^()]*(?:\([^()]*\)[^()]*)*\))",
        r"int(\1)", s)
    s = re.sub(
        r"\(\s*(?:float|double)\s*\)\s*"
        r"(\w+\s*\([^()]*(?:\([^()]*\)[^()]*)*\))",
        r"float(\1)", s)
    for k, v in sorted(fm.items(), key=lambda kv: -len(kv[0])):
        s = s.replace("." + k, "." + v)
    # integral division (C semantics for the non-negative index math JDFs
    # do); '//' stays itself.  An expression doing FLOAT math — a decimal
    # literal or a float-returning <math.h> call anywhere in it — keeps
    # true division: C's '/' on doubles is float division, and flooring
    # log(mt)/log(2.0) would silently drop a reduction-tree level at
    # every power-of-two size
    if not re.search(r"\d\.\d|\d\.(?!\w)|"
                     r"\b(?:log|log2|sqrt|fabs|pow)\s*\(", s):
        s = re.sub(r"(?<!/)/(?!/)", "//", s)
    return re.sub(r"\s+", " ", s).strip()


def _strip_line_comments(text: str) -> str:
    """Remove C ``//`` line comments, leaving string literals intact."""
    out = []
    for line in text.split("\n"):
        res: list[str] = []
        in_str: str | None = None
        i, n = 0, len(line)
        while i < n:
            ch = line[i]
            if in_str:
                res.append(ch)
                if ch == "\\" and i + 1 < n:
                    res.append(line[i + 1])
                    i += 2
                    continue
                if ch == in_str:
                    in_str = None
                i += 1
                continue
            if ch in "\"'":
                in_str = ch
                res.append(ch)
                i += 1
                continue
            if ch == "/" and i + 1 < n and line[i + 1] == "/":
                break
            res.append(ch)
            i += 1
        out.append("".join(res))
    return "\n".join(out)


def _convert_inline(s: str, fm) -> str:
    """``%{ return EXPR; %}`` fragments → ``(EXPR)``."""
    return re.sub(
        r"%\{\s*return\s+(.*?);\s*%\}",
        lambda m: "(" + convert_expr(m.group(1), fm) + ")", s, flags=re.S)


_RE_EXTERN = re.compile(r'extern\s+"C"\s*%\{.*?%\}', re.S)
_RE_GLOBAL_C = re.compile(r"^(\w+)\s*\[(.*)\]\s*$")
_RE_PROP_KEY_C = re.compile(r"(\w+)\s*=\s*")


def _scan_props_c(s: str) -> list[tuple[str, str]]:
    """``key = value`` pairs from a C-syntax property block.  Values are
    quoted strings, balanced parenthesized expressions at arbitrary
    depth (converted ``%{ return ...; %}`` fragments), or bare tokens."""
    out: list[tuple[str, str]] = []
    i, n = 0, len(s)
    while i < n:
        m = _RE_PROP_KEY_C.match(s, i)
        if m is None:
            i += 1
            continue
        key = m.group(1)
        i = m.end()
        if i < n and s[i] == '"':
            j = s.find('"', i + 1)
            j = n - 1 if j < 0 else j
            out.append((key, s[i + 1:j]))
            i = j + 1
        elif i < n and s[i] == "(":
            from .jdf import scan_balanced
            j = scan_balanced(s, i)
            # strip interior whitespace so the value rides the
            # single-token prop grammar downstream
            out.append((key, re.sub(r"\s+", "", s[i:j + 1])))
            i = j + 1
        else:
            mv = re.match(r"\S+", s[i:])
            out.append((key, mv.group(0) if mv else ""))
            i += len(mv.group(0)) if mv else 1
    return out


def _convert_global(line: str, fm) -> str:
    m = _RE_GLOBAL_C.match(line.strip())
    if not m:
        return line
    name, props_src = m.group(1), m.group(2)
    props = dict(_scan_props_c(props_src))
    ctype = props.get("type", "")
    default = props.get("default")
    if "*" in ctype or "matrix" in ctype or "collection" in ctype \
            or "dist" in ctype:
        out_type = "data"
    elif any(t in ctype for t in ("int", "float", "double")):
        out_type = "int" if "int" in ctype else "float"
    else:
        out_type = "object"
    head = name if default is None else \
        f"{name} = {convert_expr(default, fm)}"
    return f"{head}  [type = {out_type}]"


_RE_PTR_DECL = re.compile(
    r"^(?:\w+\s+)+\*\s*(\w+)\s*=\s*\(\s*\w+\s*\*\s*\)\s*(\w+)$")
_RE_PLAIN_DECL = re.compile(
    r"^(?:int|float|double|long|unsigned|size_t)\s+(\w+)\s*=\s*(.+)$")
_RE_C_ASSIGN = re.compile(r"^(\*?\s*\w+)\s*(=(?!=)|\+=|-=|\*=)\s*(.+)$")


def _convert_rhs(rhs: str, aliases: set[str], fm) -> str | None:
    """Convert an expression of the simple subset, or None.  The subset
    has no function calls and no C-only operators: the converted text
    must compile as a Python expression and contain no call syntax —
    otherwise the body degrades to the override/pass fallback instead
    of shipping Python that crashes at build or task time."""
    out = convert_expr(_deref(rhs, aliases), fm)
    if re.search(r"[\w\]]\s*\(", out):
        return None                      # calls are outside the subset
    try:
        compile(out, "<jdf_c:body>", "eval")
    except SyntaxError:
        return None                      # e.g. a leftover C ternary
    return out


def convert_c_body(src: str, field_map: dict | None = None) -> str | None:
    """Mechanically convert a C task body of the simple statement subset
    to Python, or return None when any statement falls outside it.

    The subset (all the reference's Ex02/Ex05/Ex06/Ex07 bodies): flow
    pointer aliases (``int *Aint = (int*)A;`` — tiles are torch tensors,
    ``*Aint`` becomes ``Aint[0]``), assignments and compound assignments
    through the deref, plain arithmetic declarations, ``if``/``else``
    with braced or single statements, ``return``, and ``printf`` calls
    (dropped — output side effects carry no dataflow)."""
    s = src.strip()
    if s.startswith("{") and s.endswith("}"):
        s = s[1:-1]
    aliases: set[str] = set()
    lines: list[str] = []
    if _c_stmts(s, lines, "", aliases, field_map) is None:
        return None
    out = "\n".join(ln for ln in lines if ln.strip())
    return out or "pass"


def _deref(expr: str, aliases: set[str]) -> str:
    """``*Aint`` -> ``Aint[0]`` for known pointer aliases (the simple
    subset has no pointer arithmetic, so every ``* alias`` is a deref)."""
    for a in aliases:
        expr = re.sub(r"\*\s*" + a + r"\b", f"{a}[0]", expr)
    return expr


def _c_stmts(s: str, lines: list[str], indent: str, aliases: set[str],
             fm) -> bool | None:
    """Convert a statement sequence; None = outside the subset."""
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i] in " \t\r\n":
            i += 1
        if i >= n:
            break
        if s.startswith("if", i) and re.match(r"if\b", s[i:]):
            j = s.find("(", i)
            if j < 0:
                return None
            k = scan_balanced(s, j)
            cond = _convert_rhs(s[j + 1:k], aliases, fm)
            if cond is None:
                return None
            lines.append(f"{indent}if {cond}:")
            i = _c_block(s, k + 1, lines, indent + "    ", aliases, fm)
            if i is None:
                return None
            while i < n and s[i] in " \t\r\n":
                i += 1
            if s.startswith("else", i):
                lines.append(f"{indent}else:")
                i = _c_block(s, i + 4, lines, indent + "    ", aliases, fm)
                if i is None:
                    return None
            continue
        j = s.find(";", i)
        if j < 0:
            return None
        if _c_stmt(s[i:j].strip(), lines, indent, aliases, fm) is None:
            return None
        i = j + 1
    return True


def _c_block(s: str, i: int, lines: list[str], indent: str,
             aliases: set[str], fm) -> int | None:
    """One braced block or single statement starting at/after ``i``;
    returns the index past it."""
    n = len(s)
    while i < n and s[i] in " \t\r\n":
        i += 1
    if i < n and s[i] == "{":
        depth, j = 0, i
        while j < n:
            if s[j] == "{":
                depth += 1
            elif s[j] == "}":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        if depth != 0:
            return None
        if _c_stmts(s[i + 1:j], lines, indent, aliases, fm) is None:
            return None
        return j + 1
    j = s.find(";", i)
    if j < 0:
        return None
    if _c_stmt(s[i:j].strip(), lines, indent, aliases, fm) is None:
        return None
    return j + 1


def _c_stmt(stmt: str, lines: list[str], indent: str, aliases: set[str],
            fm) -> bool | None:
    if not stmt:
        return True
    m = _RE_PTR_DECL.match(stmt)
    if m:
        name, flow = m.groups()
        aliases.add(name)
        lines.append(f"{indent}{name} = {flow}")
        return True
    if re.match(r"printf\s*\(", stmt):
        lines.append(f"{indent}pass  # {' '.join(stmt.split())}")
        return True
    if stmt == "return":
        lines.append(f"{indent}return")
        return True
    m = _RE_PLAIN_DECL.match(stmt)
    if m:
        name, rhs = m.groups()
        conv = _convert_rhs(rhs, aliases, fm)
        if conv is None:
            return None
        lines.append(f"{indent}{name} = {conv}")
        return True
    m = _RE_C_ASSIGN.match(stmt)
    if m:
        lhs, op, rhs = m.groups()
        conv = _convert_rhs(rhs, aliases, fm)
        if conv is None:
            return None
        lines.append(f"{indent}{_deref(lhs.strip(), aliases)} {op} {conv}")
        return True
    return None


def convert_c_jdf(text: str, bodies: dict[str, str] | None = None,
                  field_map: dict[str, str] | None = None) -> str:
    """Rewrite a C-syntax JDF into the Python-expression grammar."""
    bodies = bodies or {}
    text = _RE_EXTERN.sub("", text)
    # strip C comments OUTSIDE bodies later; blanket-strip block comments
    # now (C-syntax files comment with /* */ everywhere, incl. body stubs)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    # line comments too (BEFORE inline conversion: converted expressions
    # legitimately contain Python's // floor division); string-literal
    # aware, so a '//' inside a printf format survives
    text = _strip_line_comments(text)
    text = _convert_inline(text, field_map)

    out: list[str] = []
    lines = _merge_continuations(text.split("\n"))
    i, n = 0, len(lines)
    cur_task: str | None = None
    seen_globals: set[str] = set()
    task_names: set[str] = set()
    data_used: set[str] = set()   # collections referenced anywhere

    # pre-scan task names (a task header is NAME(params) on its own line
    # with a following range line somewhere before a BODY)
    for ln in lines:
        m = re.match(r"^(\w+)\s*\(([\w\s,]*)\)\s*(?:\[.*\])?\s*$", ln.strip())
        if m and ".." not in ln:
            task_names.add(m.group(1))

    while i < n:
        raw = lines[i]
        line = raw.strip()
        if not line:
            out.append("")
            i += 1
            continue
        if line.startswith("%option"):
            kept = [f"{k} = {v}" for k, v in
                    re.findall(r"(\w+)\s*=\s*(\S+)", line)
                    if k in _KNOWN_OPTIONS]
            if kept:
                out.append("%option " + "  ".join(kept))
            i += 1
            continue
        if line == "BODY" or line.startswith("BODY"):
            # swallow the C body; emit the Python body (or pass)
            depth_body = []
            i += 1
            while i < n and lines[i].strip() != "END":
                depth_body.append(lines[i])
                i += 1
            i += 1  # consume END
            out.append("BODY")
            body = bodies.get(cur_task or "")
            if body is None:
                # no override: try the mechanical C-statement subset
                body = convert_c_body("\n".join(depth_body),
                                      field_map) or "pass"
            for bl in body.split("\n"):
                out.append("  " + bl)
            out.append("END")
            continue
        m = re.match(r"^(\w+)\s*\(([\w\s,]*)\)\s*(\[.*\])?\s*$", line)
        if m and ".." not in line and m.group(1) in task_names:
            cur_task = m.group(1)
            out.append(line)
            i += 1
            continue
        if cur_task is None:
            conv = _convert_global(line, field_map)
            gm = re.match(r"^(\w+)", conv)
            if gm:
                seen_globals.add(gm.group(1))
            out.append(conv)
            i += 1
            continue
        # inside a task: ranges / derived / affinity / arrows / priority
        if line.startswith(":"):
            md = re.match(r"^:\s*(\w+)\s*\((.*)\)\s*$", line)
            if md:
                data_used.add(md.group(1))
                out.append(f"  : {md.group(1)}"
                           f"({convert_expr(md.group(2), field_map)})")
            else:
                out.append(line)
            i += 1
            continue
        if line.startswith(";"):
            out.append(f"  ; {convert_expr(line[1:], field_map)}")
            i += 1
            continue
        if line.startswith("<-") or line.startswith("->") or \
                re.match(r"^(RW|READ|WRITE|CTL)\s", line):
            out.append("  " + _convert_arrow_line(line, field_map,
                                                  task_names, data_used))
            i += 1
            continue
        mr = re.match(r"^(\w+)\s*=\s*(.+)$", line)
        if mr:
            parts = [p.strip() for p in mr.group(2).split("..")]
            conv = " .. ".join(convert_expr(p, field_map) for p in parts)
            out.append(f"  {mr.group(1)} = {conv}")
            i += 1
            continue
        out.append(raw)
        i += 1

    # synthesize [type = data] globals for collections declared only in C
    synth = [name for name in sorted(data_used)
             if name not in seen_globals and name not in task_names]
    header = [f"{name}  [type = data]" for name in synth]
    body_text = "\n".join(out)
    if "DTT_DEFAULT" in body_text and "DTT_DEFAULT" not in seen_globals:
        # NEW arrows allocate at this type: bind a TileType at build()
        header.append("DTT_DEFAULT  [type = object]")
    return "\n".join(header + [body_text])


def _open_ternary(line: str) -> bool:
    """A paren-top-level ``?`` still awaiting its ``:`` — the reference
    wraps guarded arrows across lines (``ep.jdf``'s else branch on its
    own ``: S TASK(i, l-1)`` line)."""
    depth, q = 0, 0
    for ch in line:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif depth == 0:
            if ch == "?":
                q += 1
            elif ch == ":" and q > 0:
                q -= 1
    return q > 0


def _merge_continuations(lines: list[str]) -> list[str]:
    """Join lines whose ``[...]`` dep-property block spans several source
    lines (the reference wraps long property lists), and ternary-else
    continuation lines (``: target`` / ``? target`` under an open
    top-level ``?``); BODY regions are C code and stay untouched."""
    out: list[str] = []
    i, n = 0, len(lines)
    in_body = False
    while i < n:
        line = lines[i]
        s = line.strip()
        if in_body:
            out.append(line)
            if s == "END":
                in_body = False
            i += 1
            continue
        if s == "BODY" or s.startswith("BODY"):
            in_body = True
            out.append(line)
            i += 1
            continue
        merged = True
        while merged and i + 1 < n:
            merged = False
            depth = line.count("[") - line.count("]")
            while depth > 0 and i + 1 < n:
                i += 1
                nxt = lines[i]
                line = line.rstrip() + " " + nxt.strip()
                depth += nxt.count("[") - nxt.count("]")
                merged = True
            if i + 1 < n:
                nxt = lines[i + 1].strip()
                arrowish = "<-" in line or "->" in line
                # `? then` continues an arrow whose guard sat alone on
                # the previous line; `: else` continues an open ternary
                if (nxt.startswith("?") and arrowish) or (
                        nxt.startswith(":") and _open_ternary(line)):
                    i += 1
                    line = line.rstrip() + " " + nxt
                    merged = True
        out.append(line)
        i += 1
    return out


def _convert_arrow_line(line: str, fm, task_names: set[str],
                        data_used: set) -> str:
    """Convert the expressions inside one flow/arrow line, preserving the
    arrow structure the grammar shares with the reference."""
    # split off a trailing [props] block (dep properties)
    props = ""
    pm = re.search(r"\[([^\]]*)\]\s*$", line)
    if pm:
        props_src = pm.group(1)
        line = line[:pm.start()].rstrip()
        kept = [f"{k} = {v}" for k, v in _scan_props_c(props_src)]
        if kept:
            props = "  [" + "  ".join(kept) + "]"

    def conv_target(t: str) -> str:
        t = t.strip()
        if t == "NEW":
            return "NEW"       # [type=] appended at line level below
        if t == "NULL":
            return "NULL"
        mt = re.match(r"^(\w+)\s+(\w+)\s*\((.*)\)$", t)
        if mt:
            args = ", ".join(
                " .. ".join(convert_expr(p, fm) for p in a.split(".."))
                for a in _split_args(mt.group(3)))
            return f"{mt.group(1)} {mt.group(2)}({args})"
        md = re.match(r"^(\w+)\s*\((.*)\)$", t)
        if md:
            if md.group(1) not in task_names:
                data_used.add(md.group(1))
            args = ", ".join(convert_expr(a, fm)
                             for a in _split_args(md.group(2)))
            return f"{md.group(1)}({args})"
        return t

    def conv_segment(seg: str) -> str:
        seg = seg.strip()
        q = _split_top(seg, "?")
        if len(q) == 2:
            guard = convert_expr(q[0].strip(), fm)
            if not guard.startswith("("):
                guard = f"({guard})"
            branches = _split_top(q[1], ":")
            s = f"{guard} ? {conv_target(branches[0])}"
            if len(branches) == 2:
                s += f" : {conv_target(branches[1])}"
            return s
        return conv_target(seg)

    # flow prefix?
    prefix = ""
    mf = re.match(r"^(RW|READ|WRITE|CTL)\s+(\w+)\s*(.*)$", line)
    if mf:
        prefix = f"{mf.group(1)} {mf.group(2)} "
        line = mf.group(3).strip()
    if not line:
        return prefix.rstrip()
    # split arrow chain
    segs = []
    direction = None
    start = 0
    j = 0
    depth = 0
    while j < len(line):
        ch = line[j]
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if depth == 0 and line[j:j + 2] in ("<-", "->"):
            if direction is not None:
                segs.append((direction, line[start:j]))
            direction = line[j:j + 2]
            j += 2
            start = j
            continue
        j += 1
    segs.append((direction, line[start:]))
    parts = []
    for d, seg in segs:
        conv = conv_segment(seg)
        if re.search(r"\bNEW\b", conv):
            conv += "  [type = DTT_DEFAULT]"
        parts.append(f"{d} {conv}")
    return prefix + (" ".join(parts)) + props


def _split_args(s: str) -> list[str]:
    return [a for a in _split_top(s, ",") if a.strip()]


def _split_top(s: str, sep: str) -> list[str]:
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


def _subst_ids(expr: str, mapping: dict[str, str]) -> str:
    """Simultaneous identifier substitution in an expression string; a
    replacement that is itself a compound expression is parenthesized."""
    if not expr:
        return expr

    def rep(m: re.Match) -> str:
        w = m.group(0)
        if w not in mapping:
            return w
        v = mapping[w].strip()
        return v if re.fullmatch(r"\w+", v) else f"({v})"

    # (?<!\.) keeps attribute names out of the substitution: a task
    # parameter named like a collection attribute (descA.nb vs param nb)
    # must not rewrite the attribute access
    return re.sub(r"(?<!\.)\b\w+\b", rep, expr)


def _norm_expr(s: str | None) -> str:
    return re.sub(r"\s+", "", s or "")


def resolve_read_chains(jdf: JDF) -> list[str]:
    """jdf2c's read-chain forwarding, as a post-parse fixpoint
    (``jdf2c.c`` resolves such chains during its symbolic dataflow pass;
    this runtime activates inputs from the producer side, so an input
    arrow with no reciprocal output would never fire).

    For every input arrow whose source is a task flow (S, G) such that
    S.G declares **no output arrow back to the consuming flow**, resolve
    S.G's data *origin* and rewrite the input to read that data
    directly.  An origin exists when S.G is a READ flow whose single
    input collapses — base-case data with arguments invariant under the
    self-chain's index shift (``(r == 0) ? descA(t, 0) : A FANOUT(r-1,
    t)`` resolves to ``descA(t, 0)`` for every r).  Returns a list of
    human-readable rewrite notes (tests assert on them)."""
    from .dsl import READ

    # reciprocity index: (src task, src flow) -> {(dst task, dst flow)}
    recip: set[tuple] = set()
    for t in jdf.tasks.values():
        for fd in t.flows:
            for ar in fd.arrows:
                if ar.direction != "out":
                    continue
                for tgt in (ar.then_tgt, ar.else_tgt):
                    if tgt and tgt[0] == "task":
                        recip.add((t.name, fd.name, tgt[1], tgt[2]))

    def flow_of(tname: str, fname: str):
        t = jdf.tasks.get(tname)
        if t is None:
            return None, None
        return t, next((f for f in t.flows if f.name == fname), None)

    def origin(tname: str, fname: str, depth: int = 0):
        """Data origin of READ flow ``tname.fname`` in its own params:
        ``("data", coll, None, args)`` or None."""
        if depth > 8:
            return None
        t, fd = flow_of(tname, fname)
        if fd is None or fd.access is not READ:
            return None
        ins = [ar for ar in fd.arrows if ar.direction == "in"]
        if len(ins) != 1:
            return None
        ar = ins[0]
        then, els = ar.then_tgt, ar.else_tgt
        if els is None:
            return then if then[0] == "data" else None
        if then[0] != "data":
            return None
        if els[0] == "data":
            if els[1] == then[1] and _norm_expr(els[3]) == _norm_expr(
                    then[3]):
                return then
            return None
        if els[0] != "task":
            return None
        mapping = dict(zip(jdf.tasks[els[1]].params,
                           _split_args(els[3] or "")))
        if (els[1], els[2]) == (tname, fname):
            # self chain: the base data args must be a fixpoint of the
            # index shift (independent of the recurrence variable)
            if _norm_expr(_subst_ids(then[3], mapping)) == _norm_expr(
                    then[3]):
                return then
            return None
        o = origin(els[1], els[2], depth + 1)
        if o is None:
            return None
        resolved_args = _subst_ids(o[3], mapping)
        if o[1] == then[1] and _norm_expr(resolved_args) == _norm_expr(
                then[3]):
            return then
        return None

    notes: list[str] = []
    for t in jdf.tasks.values():
        for fd in t.flows:
            for ar in fd.arrows:
                if ar.direction != "in":
                    continue
                for attr in ("then_tgt", "else_tgt"):
                    tgt = getattr(ar, attr)
                    if not tgt or tgt[0] != "task":
                        continue
                    src_t, src_f = tgt[1], tgt[2]
                    if (src_t, src_f, t.name, fd.name) in recip:
                        continue           # producer forwards; no rewrite
                    o = origin(src_t, src_f)
                    if o is None:
                        continue
                    src_task = jdf.tasks[src_t]
                    mapping = dict(zip(src_task.params,
                                       _split_args(tgt[3] or "")))
                    new_args = _subst_ids(o[3], mapping)
                    setattr(ar, attr, ("data", o[1], None, new_args))
                    notes.append(
                        f"{t.name}.{fd.name} <- {src_t}.{src_f} resolved "
                        f"to {o[1]}({new_args})")
    return notes


def load_c_jdf(path: Any, bodies: dict[str, str] | None = None,
               name: str | None = None,
               field_map: dict[str, str] | None = None,
               forward_read_chains: bool = True) -> JDF:
    """Convert + parse a C-syntax ``.jdf`` file from disk."""
    import pathlib
    p = pathlib.Path(path)
    jdf = parse_jdf(convert_c_jdf(p.read_text(), bodies, field_map),
                    name or p.stem)
    if forward_read_chains:
        jdf.read_chain_notes = resolve_read_chains(jdf)
    return jdf
