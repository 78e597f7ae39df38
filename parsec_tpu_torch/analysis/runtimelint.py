"""runtimelint: AST concurrency and hygiene lint over the port's source.

Port of ``parsec_tpu/analysis/runtimelint.py``.  The hot paths of the
runtime (``core/hbbuffer.py`` StealDeque, ``runtime/context.py``,
``dtd/insert.py``) run *unguarded* on documented GIL-atomicity and
lock-discipline assumptions: verify the structure ahead of time, keep
the serving path fast.  This lint turns those comments into checked
contracts:

**Lock-protected attributes**: a module declares, at top level::

    _LOCK_PROTECTED = {"Context._taskpools": "_lock", ...}
    _LOCK_ALIASES = {"_cond": "_lock"}    # a Condition wrapping the lock

Any mutation of a declared attribute (assignment, ``+=``, ``del``,
subscript store, or a mutating method call such as ``.append``/``.pop``)
must appear lexically inside a ``with <obj>.<lock>:`` block naming the
declared lock (or an alias).  ``__init__`` construction is exempt.  A
helper whose *caller* holds the lock carries a ``# lint: holds(<lock>)``
comment on its ``def`` line, or says "Caller holds ``<lock>``" in its
docstring.  A deliberate unlocked mutation (a GIL-atomic single op) is
waived per line with ``# lint: unlocked-ok``.

**Lock order**: a module declares its acquisition partial order,
outermost first::

    _LOCK_ORDER = ("_insert_lock", "_lock")

Lexically nested ``with`` acquisitions must follow it: acquiring a lock
while holding one the order places *after* it is a deadlock-shaped
inversion.  (Same-name nesting, two instances of one class, is not
ordered by this check.)

**Hygiene**: no bare ``except:`` anywhere (it swallows
``KeyboardInterrupt`` and worker poison; waive with ``# lint:
bare-except-ok``); no ``pickle.loads`` outside the restricted-codec seam
``comm/codec.py`` (the wire trust boundary: network bytes never reach
the bare pickle VM); no top-level import that no code references (waive
with ``# lint: keep-import`` when imported for side effects).

Limitations (by design, it is a lint): the analysis is lexical and per
function, so a lock held across a call needs the ``holds`` annotation,
and a receiver is matched by attribute *name*, not by object.
:func:`lint_self` lints the installed ``parsec_tpu_torch`` package.
"""

from __future__ import annotations

import ast
import os
import re

from .graphcheck import ERROR, WARNING, Finding

# method names that mutate their receiver in place
_MUTATORS = {
    "append", "extend", "insert", "pop", "popleft", "appendleft", "remove",
    "clear", "add", "discard", "update", "setdefault", "sort", "reverse",
}

# modules allowed to call pickle.loads (the restricted-unpickler seam)
_PICKLE_SEAMS = ("comm/codec.py",)

_RE_HOLDS = re.compile(r"#\s*lint:\s*holds\(([^)]*)\)")
_RE_DOC_HOLDS = re.compile(r"[Cc]aller holds ``(\w+)``")
_RE_UNLOCKED_OK = re.compile(r"#\s*lint:\s*unlocked-ok")
_RE_KEEP_IMPORT = re.compile(r"#\s*lint:\s*keep-import")
_RE_BARE_OK = re.compile(r"#\s*lint:\s*bare-except-ok")


class LintReport:
    """Findings over a set of source files."""

    def __init__(self) -> None:
        self.findings: list[Finding] = []
        self.nfiles = 0

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        state = "OK" if self.ok else "FAILED"
        return (f"runtimelint: {state} — {self.nfiles} files, "
                f"{len(self.errors)} errors, {len(self.warnings)} warnings")

    def __repr__(self) -> str:
        return f"<LintReport {self.summary()}>"


def lint_self() -> LintReport:
    """Lint the installed ``parsec_tpu_torch`` package source."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return lint_paths([pkg])


def lint_paths(paths: list[str]) -> LintReport:
    report = LintReport()
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
        else:
            files.append(p)
    base = os.path.commonpath(files) if len(files) > 1 else \
        os.path.dirname(files[0]) if files else ""
    for f in sorted(files):
        rel = os.path.relpath(f, base) if base else f
        report.findings.extend(lint_file(f, rel))
        report.nfiles += 1
    return report


def lint_file(path: str, rel: str | None = None) -> list[Finding]:
    rel = rel or path
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("syntax-error", ERROR, str(e), file=rel,
                        line=e.lineno or 0)]
    lines = src.split("\n")
    out: list[Finding] = []
    protected, aliases, order = _module_contracts(tree)
    _lint_hygiene(tree, lines, rel, out)
    _lint_imports(tree, lines, rel, out)
    if protected or order:
        linter = _LockLinter(rel, lines, protected, aliases, order, out)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                linter.check_function(node)
    return out


# ---------------------------------------------------------------------------
# module contract extraction
# ---------------------------------------------------------------------------


def _module_contracts(tree: ast.Module):
    protected: dict[str, set[str]] = {}   # attr -> allowed lock names
    aliases: dict[str, str] = {}
    order: tuple = ()
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not isinstance(t, ast.Name):
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            continue
        if t.id == "_LOCK_PROTECTED":
            for qual, lock in value.items():
                attr = qual.split(".")[-1]
                protected.setdefault(attr, set()).add(lock)
        elif t.id == "_LOCK_ALIASES":
            aliases = dict(value)
        elif t.id == "_LOCK_ORDER":
            order = tuple(value)
    return protected, aliases, order


# ---------------------------------------------------------------------------
# hygiene rules
# ---------------------------------------------------------------------------


def _line_has(lines: list[str], lineno: int, rx: re.Pattern) -> bool:
    return 0 < lineno <= len(lines) and bool(rx.search(lines[lineno - 1]))


def _lint_hygiene(tree, lines, rel, out: list[Finding]) -> None:
    pickle_ok = any(rel.replace(os.sep, "/").endswith(s)
                    for s in _PICKLE_SEAMS)
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            if not _line_has(lines, node.lineno, _RE_BARE_OK):
                out.append(Finding(
                    "bare-except", ERROR,
                    "bare `except:` swallows KeyboardInterrupt and worker "
                    "poison — catch Exception (or narrower)",
                    file=rel, line=node.lineno))
        elif isinstance(node, ast.Call) and not pickle_ok:
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "loads" \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in ("pickle", "cPickle"):
                out.append(Finding(
                    "bare-pickle-loads", ERROR,
                    "pickle.loads outside the restricted-codec seam "
                    "(comm/codec.py) — wire bytes must decode through the "
                    "find_class allowlist (docs/COMM.md trust boundary)",
                    file=rel, line=node.lineno))


def _lint_imports(tree, lines, rel, out: list[Finding]) -> None:
    """Top-level imports never referenced in the module (dead code).

    ``__init__.py`` files re-export by design and are skipped; so are
    side-effect imports waived with ``# lint: keep-import`` and anything
    listed in ``__all__``."""
    if os.path.basename(rel) == "__init__.py":
        return
    imported: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imported[name] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                imported[a.asname or a.name] = node.lineno
    if not imported:
        return
    exported: set[str] = set()
    used: set[str] = set()
    ann_nodes: list = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and \
                not isinstance(node.ctx, ast.Store):
            used.add(node.id)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    try:
                        exported.update(ast.literal_eval(node.value))
                    except ValueError:
                        pass
        # quoted annotations ('-> "TaskClassBuilder"') hide their names in
        # string constants: harvest identifiers from annotation positions
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ann_nodes.append(node.returns)
            for a in (node.args.args + node.args.posonlyargs
                      + node.args.kwonlyargs
                      + [node.args.vararg, node.args.kwarg]):
                if a is not None:
                    ann_nodes.append(a.annotation)
        elif isinstance(node, ast.AnnAssign):
            ann_nodes.append(node.annotation)
    for ann in ann_nodes:
        if ann is None:
            continue
        for sub in ast.walk(ann):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                used.update(re.findall(r"[A-Za-z_]\w*", sub.value))
    for name, lineno in imported.items():
        if name in used or name in exported or name.startswith("_"):
            continue
        if _line_has(lines, lineno, _RE_KEEP_IMPORT):
            continue
        out.append(Finding(
            "unused-import", WARNING,
            f"{name!r} is imported but never used (dead code; "
            f"`# lint: keep-import` if imported for side effects)",
            file=rel, line=lineno))


# ---------------------------------------------------------------------------
# lock discipline
# ---------------------------------------------------------------------------


class _LockLinter:
    def __init__(self, rel: str, lines: list[str],
                 protected: dict[str, set[str]], aliases: dict[str, str],
                 order: tuple, out: list[Finding]) -> None:
        self.rel = rel
        self.lines = lines
        self.protected = protected
        self.aliases = aliases
        self.order = order
        self.out = out
        # names that count as lock acquisitions when seen in `with`
        self.known_locks = set(order) | set(aliases) | set(aliases.values())
        for locks in protected.values():
            self.known_locks |= locks

    # -- entry ---------------------------------------------------------------
    def check_function(self, fn) -> None:
        held = self._annotated_holds(fn)
        is_init = fn.name == "__init__"
        self._walk(fn.body, held, is_init)

    def _annotated_holds(self, fn) -> frozenset:
        held: set[str] = set()
        # the directive may sit on any line of the (possibly wrapped)
        # signature, def line through the line before the first body stmt
        first_body = fn.body[0].lineno if fn.body else fn.lineno + 1
        for ln in range(fn.lineno, min(first_body, len(self.lines) + 1)):
            m = _RE_HOLDS.search(self.lines[ln - 1])
            if m:
                held |= {s.strip() for s in m.group(1).split(",")
                         if s.strip()}
        doc = ast.get_docstring(fn) or ""
        held |= set(_RE_DOC_HOLDS.findall(doc))
        return frozenset(self._expand(held))

    def _expand(self, names) -> set[str]:
        """Alias closure: a Condition and the lock it wraps are ONE mutex,
        so holding either counts as holding both."""
        out = set(names)
        for n in names:
            if n in self.aliases:
                out.add(self.aliases[n])
            for k, v in self.aliases.items():
                if v == n:
                    out.add(k)
        return out

    # -- traversal -----------------------------------------------------------
    def _walk(self, body: list, held: frozenset, is_init: bool) -> None:
        for node in body:
            self._visit(node, held, is_init)

    def _visit(self, node, held: frozenset, is_init: bool) -> None:
        if isinstance(node, ast.With):
            acquired = [n for n in (self._lock_name(i.context_expr)
                                    for i in node.items) if n]
            # check each item against the locks already held PLUS the
            # earlier items of this same With — `with a, b:` acquires in
            # order and can invert just like lexical nesting
            cur = set(held)
            for name in acquired:
                self._check_order(name, frozenset(cur), node.lineno)
                cur |= self._expand({name})
            self._walk(node.body, frozenset(cur), is_init)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return   # nested defs run later; ast.walk visits them top-level
        # mutations in this statement, then recurse into nested blocks
        # (iter_child_nodes covers body/orelse/finalbody/handlers alike)
        self._check_stmt(node, held, is_init)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.stmt, ast.excepthandler)):
                self._visit(child, held, is_init)

    def _lock_name(self, expr) -> str | None:
        if isinstance(expr, ast.Attribute) and expr.attr in self.known_locks:
            return expr.attr
        if isinstance(expr, ast.Name) and expr.id in self.known_locks:
            return expr.id
        return None

    def _check_order(self, name: str, held: frozenset,
                     lineno: int) -> None:
        if name not in self.order:
            return
        idx = self.order.index(name)
        for h in held:
            if h in self.order and self.order.index(h) > idx:
                self.out.append(Finding(
                    "lock-order", ERROR,
                    f"acquires {name!r} while holding {h!r} — the "
                    f"module's _LOCK_ORDER places {name!r} before "
                    f"{h!r} (deadlock-shaped inversion)",
                    file=self.rel, line=lineno))

    # -- mutation detection ---------------------------------------------------
    def _check_stmt(self, node, held: frozenset, is_init: bool) -> None:
        sites: list[tuple[str, int]] = []     # (attr, lineno)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                sites.extend(self._target_attrs(t))
        elif isinstance(node, ast.AugAssign):
            sites.extend(self._target_attrs(node.target))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                sites.extend(self._target_attrs(t))
        # mutating method calls anywhere in this statement's expressions
        # (`self.x.pop()`, `v = self.x.pop()`, `f(self.x.pop())` alike) —
        # only the statement's OWN expression children are walked; nested
        # statements are visited with their own held set by _visit
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.expr):
                continue
            for sub in ast.walk(child):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in _MUTATORS:
                    v = sub.func.value
                    if isinstance(v, ast.Attribute) \
                            and v.attr in self.protected:
                        sites.append((v.attr, sub.lineno))
        for attr, lineno in sites:
            if is_init:
                continue       # construction precedes sharing
            locks = self.protected[attr]
            if held & locks:
                continue
            if _line_has(self.lines, lineno, _RE_UNLOCKED_OK):
                continue
            need = "/".join(sorted(locks))
            self.out.append(Finding(
                "unlocked-mutation", ERROR,
                f"mutates lock-protected attribute {attr!r} outside "
                f"`with {need}:` (declared in _LOCK_PROTECTED; annotate "
                f"the function with `# lint: holds({need})` if the "
                f"caller locks, or waive the line with "
                f"`# lint: unlocked-ok`)",
                file=self.rel, line=lineno))

    def _target_attrs(self, t) -> list[tuple[str, int]]:
        out: list[tuple[str, int]] = []
        if isinstance(t, ast.Attribute) and t.attr in self.protected:
            out.append((t.attr, t.lineno))
        elif isinstance(t, ast.Subscript):
            v = t.value
            if isinstance(v, ast.Attribute) and v.attr in self.protected:
                out.append((v.attr, t.lineno))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                out.extend(self._target_attrs(e))
        elif isinstance(t, ast.Starred):
            out.extend(self._target_attrs(t.value))
        return out
