"""The port's C-syntax JDF converter against the JAX package's.

``convert_expr``, ``convert_c_body`` and ``_strip_line_comments`` on every
string that ``tests/test_jdf_c.py`` hands them (read out of that file's
source), and ``convert_c_jdf`` on inline C-syntax JDFs in the reference's
own style (an ``extern "C"`` prologue, quoted types, ``%{ return ...; %}``
fragments, ``->`` descriptor fields, ``&&``/``||``, NEW roots, ranged
fan-outs, C bodies inside and outside the mechanical subset): the
converted text must equal the JAX converter's character for character,
and the converted chain must run in both packages to the same values.
``resolve_read_chains`` gives the JAX notes.  The cases on the
reference's own files skip where the reference tree is absent, under the
JAX package's own marker.
"""

import ast
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from parsec_tpu.data.datatype import TileType as JTileType
from parsec_tpu.data_dist.collection import DictCollection as JDict
from parsec_tpu.ptg import jdf_c as jjdf_c
from parsec_tpu.ptg.jdf import parse_jdf as j_parse_jdf
from parsec_tpu.runtime import Context as JContext
from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.ptg import jdf_c
from parsec_tpu_torch.ptg.jdf import parse_jdf
from parsec_tpu_torch.runtime import Context

from test_jdf_c import REF, needs_ref  # the JAX cases' reference tree

SRC = pathlib.Path(__file__).resolve().parent / "test_jdf_c.py"

_FNS = ("convert_expr", "convert_c_body", "_strip_line_comments")


def _calls():
    """(function name, string argument) for every literal call of the
    converter's functions in the JAX package's test file."""
    out = []
    for node in ast.walk(ast.parse(SRC.read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _FNS and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.append((node.func.id, node.args[0].value))
    return out


CALLS = _calls()


@pytest.mark.parametrize("fn,arg", CALLS,
                         ids=[f"{f}{i}" for i, (f, _) in enumerate(CALLS)])
def test_converter_functions_match_the_jax_package(fn, arg):
    assert getattr(jdf_c, fn)(arg) == getattr(jjdf_c, fn)(arg)


def test_every_call_was_found():
    assert {f for f, _ in CALLS} == set(_FNS) and len(CALLS) >= 15


CHAIN_C = r'''
extern "C" %{
/* the reference's Ex02 chain, in its own C syntax */
#include <stdio.h>
%}

%option no_taskpool_instance = true

NB   [type = "int"]
taskdist [type = "parsec_data_collection_t*"]

Task(k)

k = 0 .. NB

: taskdist( k )

RW  A <- (k == 0)  ? NEW : A Task( k-1 )
      -> (k < NB) ? A Task( k+1 )

BODY
{
    int *Aint = (int*)A;
    if ( k == 0 ) {
        *Aint = 0;
    } else {
        *Aint += 1;
    }
    printf("I am element %d in the chain computed on node %d\n", k, rank );
}
END

extern "C" %{
int helper(void) { return 0; }
%}
'''

BCAST_C = r'''
extern "C" %{
#include "parsec/data_dist/matrix/matrix.h"
%}

descA  [type = "parsec_tiled_matrix_t*"]
NB     [type = "int" default = "6"]
last   [type = "int" hidden = on default = "%{ return descA->lmt - 1; %}"]

TaskBcast(k)
  k = 0 .. last
  : descA( k, 0 )
  RW A <- descA( k, 0 )
       -> A TaskRecv( k, 0 .. NB .. 2 )
       -> (k != 0 && !(k > last)) ? descA( k, 0 )
BODY
{
    memcpy(A, A, 1);
}
END

TaskRecv(k, n)
  k = 0 .. last
  n = 0 .. NB .. 2
  loc = %{ return k + n/2; %}
  : descA( loc % (last + 1), 0 )
  READ A <- A TaskBcast( k )
  CTL  c <- (n > 0 || k == 0) ? c TaskRecv( k, n - 2 )
         -> (n < NB) ? c TaskRecv( k, n + 2 )
BODY
{
    int *Aint = (int*)A;
    int x = k + n;
    if ( x > 3 ) { x = 3; }
}
END
'''

READ_CHAIN = """
D  [type = data]
N  [type = int]

GEN(i)
  i = 0 .. N-1
  : D(i)
  READ A <- (i == 0) ? D(0) : A GEN(i-1)
BODY
  pass
END

USE(i)
  i = 0 .. N-1
  : D(i)
  READ X <- A GEN(i)
BODY
  pass
END
"""


@pytest.mark.parametrize("text", [CHAIN_C, BCAST_C], ids=["chain", "bcast"])
@pytest.mark.parametrize("bodies", [None, {"Task": "A[...] = k"}],
                         ids=["c-bodies", "overrides"])
def test_convert_c_jdf_text_equals_the_jax_converter(text, bodies):
    got = jdf_c.convert_c_jdf(text, bodies)
    assert got == jjdf_c.convert_c_jdf(text, bodies)
    # and it parses in both, to the same unparsed text
    from parsec_tpu.ptg.jdf import unparse_jdf as j_unparse
    from parsec_tpu_torch.ptg.jdf import unparse_jdf
    assert unparse_jdf(parse_jdf(got, "c")) == \
        j_unparse(j_parse_jdf(got, "c"))


def _run_chain(port, NB=6):
    mod = jdf_c if port else jjdf_c
    text = mod.convert_c_jdf(CHAIN_C)
    jdf = (parse_jdf if port else j_parse_jdf)(text, "chain")
    jdf.read_chain_notes = mod.resolve_read_chains(jdf)
    tt = TileType((1,), torch.int32) if port else JTileType((1,), np.int32)
    dist = (DictCollection if port else JDict)(
        "taskdist", dtt=tt, init_fn=lambda *k: np.zeros(1, np.int32))
    seen = {}
    jdf.globals_decl["seen"] = {}
    props, code = jdf.tasks["Task"].bodies[0]
    jdf.tasks["Task"].bodies[0] = (
        props, textwrap.dedent(code) + "\nseen[k] = int(A[0])")
    tp = jdf.build(taskdist=dist, NB=NB, DTT_DEFAULT=tt, seen=seen)
    with (Context if port else JContext)(nb_cores=0) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
    return text, seen


def test_converted_chain_runs_like_the_jax_package():
    """The C body converts mechanically in both packages; a probe line
    after it records each task's value (0 at the NEW root, +1 a link)."""
    text, seen = _run_chain(True)
    jtext, jseen = _run_chain(False)
    assert text == jtext
    assert seen == jseen == {k: k for k in range(7)}


def test_read_chain_notes_match():
    notes = jdf_c.resolve_read_chains(parse_jdf(READ_CHAIN, "chain"))
    jnotes = jjdf_c.resolve_read_chains(j_parse_jdf(READ_CHAIN, "chain"))
    assert sorted(notes) == sorted(jnotes) == [
        "GEN.A <- GEN.A resolved to D(0)",
        "USE.X <- GEN.A resolved to D(0)"]


_REF_FILES = ["examples/Ex02_Chain.jdf", "examples/Ex05_Broadcast.jdf",
              "examples/Ex07_RAW_CTL.jdf",
              "tests/runtime/scheduling/ep.jdf",
              "tests/apps/all2all/a2a.jdf"]


@needs_ref
@pytest.mark.parametrize("rel", _REF_FILES)
def test_reference_files_convert_like_the_jax_package(rel):
    text = (REF / rel).read_text()
    assert jdf_c.convert_c_jdf(text) == jjdf_c.convert_c_jdf(text)
