"""The port's runtime lint (``parsec_tpu_torch/analysis/runtimelint.py``)
against the JAX package's.

``lint_self()`` is green over the port's own source (no finding at all,
as the JAX package's gate asks of its own), and on the fixture sources
of ``tests/test_analysis.py`` (unlocked mutations with their waivers and
``holds`` annotations, mutating calls with results, lock order on one
``with`` and nested, the Condition alias, the hygiene rules, quoted
annotations) the port's ``lint_file`` gives the JAX findings: code,
severity, message and line.  Then the port's contract tables: each of
the modules that declare one in the JAX package declares one here, naming
only attributes and locks its source has, and a copy of a module whose
locks are stripped fails the lint.
"""

import ast
import os
import pathlib
import re
import textwrap

import pytest

from parsec_tpu.analysis.runtimelint import lint_file as j_lint_file
from parsec_tpu_torch.analysis import lint_file, lint_paths, lint_self
from parsec_tpu_torch.analysis.__main__ import main as cli_main
from parsec_tpu_torch.analysis.runtimelint import _module_contracts

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "parsec_tpu_torch"
JAXPKG = REPO / "parsec_tpu"


def _key(findings):
    return [(f.code, f.severity, f.message, f.line) for f in findings]


FIXTURES = {
    "unlocked_mutation": ("""
        import threading
        _LOCK_PROTECTED = {"Box._items": "_lock"}
        class Box:
            def __init__(self):
                self._items = []          # construction: exempt
                self._lock = threading.Lock()
            def good(self):
                with self._lock:
                    self._items.append(1)
            def bad(self):
                self._items.append(1)
            def waived(self):
                self._items.clear()       # lint: unlocked-ok
            def helper(self):  # lint: holds(_lock)
                self._items.pop()
        """, ["unlocked-mutation"]),
    "mutating_call_with_result": ("""
        _LOCK_PROTECTED = {"Box._items": "_lock"}
        class Box:
            def bad_assign(self):
                v = self._items.pop()
                return v
            def bad_nested(self, f):
                return f(self._items.pop(0))
            def good(self):
                with self._lock:
                    return self._items.pop()
        """, ["unlocked-mutation"] * 2),
    "multi_item_with_order": ("""
        _LOCK_ORDER = ("_outer", "_inner")
        class Box:
            def ok(self):
                with self._outer, self._inner:
                    pass
            def inverted(self):
                with self._inner, self._outer:
                    pass
        """, ["lock-order"]),
    "condition_alias": ("""
        _LOCK_PROTECTED = {"Box._n": "_lock"}
        _LOCK_ALIASES = {"_cond": "_lock"}
        class Box:
            def ok(self):
                with self._cond:
                    self._n += 1
        """, []),
    "lock_order": ("""
        _LOCK_ORDER = ("_outer", "_inner")
        class Box:
            def ok(self):
                with self._outer:
                    with self._inner:
                        pass
            def inverted(self):
                with self._inner:
                    with self._outer:
                        pass
        """, ["lock-order"]),
    "hygiene": ("""
        import pickle
        import os          # never used

        def f(b):
            try:
                return pickle.loads(b)
            except:
                pass
        """, ["bare-except", "bare-pickle-loads", "unused-import"]),
    "quoted_annotation": ("""
        from typing import Sequence

        def f(x) -> "Sequence[int]":
            return [x]
        """, []),
    "docstring_holds_and_waivers": ('''
        import json  # lint: keep-import
        _LOCK_PROTECTED = {"Box._items": "_lock", "Box._n": "_lock"}
        class Box:
            def helper(self):
                """Caller holds ``_lock``."""
                self._items.append(1)
                del self._items[0]
            def swap(self):
                self._items, self._n = [], 0
            def tolerant(self):
                try:
                    pass
                except:  # lint: bare-except-ok
                    pass
        ''', ["unlocked-mutation", "unlocked-mutation"]),
}


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_a_fixture_gives_the_jax_findings(case, tmp_path):
    src, codes = FIXTURES[case]
    p = tmp_path / "probe.py"
    p.write_text(textwrap.dedent(src))
    got = lint_file(str(p))
    assert _key(got) == _key(j_lint_file(str(p)))
    assert sorted(f.code for f in got) == sorted(codes)


def test_the_pickle_seam_is_the_codec_alone(tmp_path):
    """``pickle.loads`` is allowed in ``comm/codec.py`` and nowhere else,
    in both packages: the port's codec (whose allowlisted unpickler the
    seam exists for) with one bare call added."""
    src = (PORT / "comm" / "codec.py").read_text()
    assert "import pickle" in src
    src += "\n\ndef _raw(b):\n    return pickle.loads(b)\n"
    seam = tmp_path / "comm"
    seam.mkdir()
    (seam / "codec.py").write_text(src)
    (tmp_path / "elsewhere.py").write_text(src)
    for path, rel in ((seam / "codec.py", "comm/codec.py"),
                      (tmp_path / "elsewhere.py", "elsewhere.py")):
        got = lint_file(str(path), rel)
        assert _key(got) == _key(j_lint_file(str(path), rel))
        flagged = [f for f in got if f.code == "bare-pickle-loads"]
        assert bool(flagged) == (rel == "elsewhere.py")


def test_self_lint_is_green_over_the_port():
    report = lint_self()
    assert report.nfiles > 80
    assert report.nfiles == len(list(PORT.rglob("*.py")))
    assert not report.findings, [repr(f) for f in report.findings]
    assert report.ok and "OK" in report.summary()


def test_the_cli_self_lint(capsys):
    assert cli_main(["--self-lint"]) == 0
    assert capsys.readouterr().out.startswith("runtimelint: OK")
    assert cli_main(["--self-lint", str(PORT / "core")]) == 0
    assert "runtimelint: OK" in capsys.readouterr().out


CONTRACT_MODULES = ["dtd/insert.py", "runtime/deps.py",
                    "runtime/scheduling.py", "runtime/context.py",
                    "tune/adaptive.py", "tune/db.py", "serve/sharded.py",
                    "llm/prefix_tree.py", "data_dist/kv_tiers.py",
                    "core/hbbuffer.py", "comm/collectives.py",
                    "comm/socket_fabric.py"]


def _contracts(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    # plain assignments only: the lint reads no annotated table
    names = {t.id for n in tree.body if isinstance(n, ast.Assign)
             for t in n.targets if isinstance(t, ast.Name)}
    return names, _module_contracts(tree)


@pytest.mark.parametrize("rel", CONTRACT_MODULES)
def test_each_module_declares_a_contract_of_its_own_names(rel):
    """The port's table names the port's attributes and locks (the ports
    were trimmed: an entry the port has no attribute for is dropped),
    and each entry is one of the JAX table's."""
    names, (protected, aliases, order) = _contracts(PORT / rel)
    assert "_LOCK_PROTECTED" in names
    _jnames, (jprotected, jaliases, jorder) = _contracts(JAXPKG / rel)
    src = (PORT / rel).read_text()
    body = src[src.index("_LOCK_ORDER") if "_LOCK_ORDER" in src
               else src.index("_LOCK_PROTECTED"):]
    for attr, locks in protected.items():
        assert attr in jprotected and locks <= jprotected[attr], attr
        assert re.search(rf"\b{attr}\b", body), attr
        for lock in locks:
            assert re.search(rf"\b{lock}\b", body), lock
    assert set(order) <= set(jorder) and aliases.items() <= jaliases.items()


@pytest.mark.parametrize("rel", ["serve/sharded.py", "llm/prefix_tree.py",
                                 "data_dist/kv_tiers.py",
                                 "core/hbbuffer.py"])
def test_a_module_stripped_of_its_locks_fails(rel, tmp_path):
    src = (PORT / rel).read_text()
    assert "with self._lock:" in src
    p = tmp_path / os.path.basename(rel)
    p.write_text(src.replace("with self._lock:", "if True:"))
    errs = [f for f in lint_paths([str(p)]).findings
            if f.code == "unlocked-mutation"]
    assert errs, rel
    assert [f for f in lint_file(str(PORT / rel))] == []
