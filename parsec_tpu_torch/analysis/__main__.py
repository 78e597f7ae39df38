"""CLI: ``python -m parsec_tpu_torch.analysis``.

Runs graphcheck over small instances of every model builder of the port
(or one of them) and the runtime lint over the port's own source, and
exits nonzero on any error-severity finding.  Every pool is built for the
host (``devices="cpu"``): the checks run no body and need no card.

Usage::

    python -m parsec_tpu_torch.analysis                 # self-lint + models
    python -m parsec_tpu_torch.analysis --self-lint [PATH ...]
    python -m parsec_tpu_torch.analysis --graph cholesky --nt 6 --ranks 4
    python -m parsec_tpu_torch.analysis --graph x.jdf --bind NT=4
    python -m parsec_tpu_torch.analysis --comm [--ranks 8]  # comm patterns
    python -m parsec_tpu_torch.analysis -v              # warnings too

Port of ``parsec_tpu/analysis/__main__.py``.  ``--graph`` takes a
``.jdf`` path too, parsed by :mod:`parsec_tpu_torch.ptg.jdf` and built
with its ``--bind NAME=INT`` globals (:func:`.graphcheck.check_jdf`).
Nothing of the original is left out.
"""

from __future__ import annotations

import argparse
import sys


def _model_graphs(nt: int, ranks: int = 1):
    """Small instances of every model builder of the port, as
    ``(name, taskpool)``.  ``ranks > 1`` deals the vector-backed pools
    round-robin over that many ranks, so commcheck sees cross-rank edges;
    the dense-matrix and LLM pools stay on one rank (classified ``none``,
    legitimately rank-local)."""
    import torch

    from ..comm.collectives import bcast_taskpool, reduce_taskpool
    from ..data.datatype import TileType
    from ..data_dist.collection import DictCollection
    from ..data_dist.matrix import (SymTwoDimBlockCyclic, TiledMatrix,
                                    TwoDimBlockCyclic, VectorTwoDimCyclic)
    from ..data_dist.paged_kv import PagedKVCollection
    from ..llm import (ToyLM, decode_step_ptg, decode_superpool_ptg,
                       preallocate_decode_steps, prefill_chunks, prefill_ptg,
                       seed_spec_batched_pool, seed_spec_superpool,
                       spec_batched_ptg, spec_superpool_ptg)
    from ..models import (cholesky, ep, irregular, lu, pingpong, reduction,
                          stencil, stencil2d, tiled_gemm)
    nb = 8
    n = nt * nb

    def _vec(name):
        return VectorTwoDimCyclic(name, lm=n, mb=nb, P=ranks)

    yield "cholesky", cholesky.tiled_cholesky_ptg(
        SymTwoDimBlockCyclic("A", n, n, nb, nb), devices="cpu")
    yield "lu", lu.tiled_lu_ptg(
        TiledMatrix.from_dense("A", lu.make_dd(n), nb, nb), devices="cpu")
    yield "pingpong", pingpong.pingpong_ptg(_vec("V"), 2 * nt)
    yield "reduction", reduction.bt_reduction_ptg(_vec("R"))
    yield "stencil1d", stencil.stencil_1d_ptg(_vec("S"), [0.25, 0.5, 0.25],
                                              3)
    yield "stencil2d", stencil2d.stencil_2d_ptg(
        TwoDimBlockCyclic.from_dense("M", torch.zeros(n, n), nb, nb),
        (0.5, 0.15, 0.15, 0.1, 0.1), 3)
    A = TiledMatrix.from_dense("A", torch.zeros(n, n), nb, nb)
    B = TiledMatrix.from_dense("B", torch.zeros(n, n), nb, nb)
    yield "tiled_gemm", tiled_gemm.tiled_gemm_ptg(
        A, B, TiledMatrix("C", n, n, nb, nb), devices="cpu")
    yield "all2all", irregular.all2all_ptg(_vec("IA"), _vec("IB"), 2)
    yield "ep", ep.ep_pool(nt, 4).build()

    model = ToyLM()
    H, D = model.num_heads, model.head_dim
    prompts = {"a": list(range(2 * nt)), "b": [1, 2]}
    kv = PagedKVCollection("KV", page_size=4, num_heads=H, head_dim=D)
    chunks = {}
    for seq, toks in prompts.items():
        kv.alloc_seq(seq)
        chunks.update(prefill_chunks(model, kv, seq, toks[:-1]))
    T = DictCollection("T", dtt=kv.default_dtt,
                       init_fn=lambda *k: chunks[k], keys=list(chunks))
    yield "llm_prefill", prefill_ptg(kv, T, list(prompts), devices="cpu")
    Q = DictCollection("Q", dtt=TileType((3, H, D), torch.float32))
    O = DictCollection("O", dtt=TileType((H, D), torch.float32))
    for seq in prompts:
        kv.ensure_tail_slot(seq)
    yield "llm_decode", decode_step_ptg(kv, Q, O, list(prompts),
                                        devices="cpu")

    kv2 = PagedKVCollection("KVk", page_size=4, num_heads=H, head_dim=D)
    for seq, toks in prompts.items():
        kv2.alloc_seq(seq)
        prefill_chunks(model, kv2, seq, toks[:-1])
    Q2 = DictCollection("Qk", dtt=TileType((3, H, D), torch.float32))
    O2 = DictCollection("Ok", dtt=TileType((H, D), torch.float32))
    TOK = DictCollection("TOKk", dtt=TileType((3,), torch.float32))
    EMB = DictCollection("EMBk", dtt=TileType(tuple(model.q3_table().shape),
                                              torch.float32))
    steps = {"a": max(2, nt // 2), "b": 2}      # mixed step counts
    for seq in prompts:
        preallocate_decode_steps(kv2, seq, steps[seq])
        TOK.data_of(seq, -1)                    # the chain seed tile
    yield "llm_decode_k", decode_superpool_ptg(
        kv2, Q2, O2, TOK, EMB, list(prompts), [steps[s] for s in prompts],
        devices="cpu")

    kv3 = PagedKVCollection("KVs", page_size=4, num_heads=H, head_dim=D)
    DRAFT = DictCollection("DRAFTs", dtt=TileType((3, H, D), torch.float32))
    O3 = DictCollection("Os", dtt=TileType((H, D), torch.float32))
    STOK = DictCollection("STOKs", dtt=TileType((4,), torch.float32))
    DTOK = DictCollection("DTOKs", dtt=TileType((1,), torch.float32))
    EMB3 = DictCollection("EMBs", dtt=TileType(
        tuple(model.q3_table().shape), torch.float32))
    drafts = {"a": [1] * max(2, nt // 2), "b": [2, 3]}  # mixed lengths
    npos = seed_spec_superpool(model, kv3, DRAFT, DTOK, STOK, EMB3,
                               prompts, drafts)
    yield "llm_decode_spec", spec_superpool_ptg(
        kv3, DRAFT, O3, STOK, DTOK, EMB3, list(prompts),
        [npos[s] for s in prompts], devices="cpu")

    kv4 = PagedKVCollection("KVb", page_size=4, num_heads=H, head_dim=D)
    pad = max(len(d) for d in drafts.values()) + 1
    QS = DictCollection("QSb", dtt=TileType((pad, 3, H, D), torch.float32))
    LIM = DictCollection("LIMb", dtt=TileType((pad,), torch.float32))
    DTOKS = DictCollection("DTOKSb", dtt=TileType((pad + 2,), torch.float32))
    VOUT = DictCollection("VOUTb", dtt=TileType((pad + 2,), torch.float32))
    npos_b, pad = seed_spec_batched_pool(model, kv4, QS, LIM, DTOKS, EMB3,
                                         prompts, drafts, pad=pad)
    yield "llm_decode_spec_batched", spec_batched_ptg(
        kv4, QS, LIM, DTOKS, VOUT, EMB3, list(prompts),
        [npos_b[s] for s in prompts], pad=pad, devices="cpu")

    yield "comm_bcast", bcast_taskpool(_vec("CB"), n=nt)
    yield "comm_reduce", reduce_taskpool(_vec("CR"), _vec("CO"), n=nt)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parsec_tpu_torch.analysis",
        description="static dataflow verification of the port's pools "
                    "and the runtime's concurrency lint")
    ap.add_argument("--graph", metavar="MODEL|JDF",
                    help="verify one graph: a model name (cholesky, lu, "
                         "pingpong, reduction, stencil1d, stencil2d, "
                         "tiled_gemm, all2all, ep, "
                         "llm_prefill, llm_decode, llm_decode_k, "
                         "llm_decode_spec, "
                         "llm_decode_spec_batched, comm_bcast, "
                         "comm_reduce) or a .jdf path")
    ap.add_argument("--bind", action="append", default=[],
                    metavar="NAME=INT", help="JDF global binding")
    ap.add_argument("--nt", type=int, default=5,
                    help="tile-grid size of the model graphs (default 5)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="verify for this many ranks (default 1)")
    ap.add_argument("--self-lint", action="store_true",
                    help="run runtimelint over parsec_tpu_torch/ (or PATHs)")
    ap.add_argument("--comm", action="store_true",
                    help="derive every model pool's comm pattern "
                         "statically (commcheck; --ranks defaults to 4 "
                         "here so cross-rank edges exist)")
    ap.add_argument("paths", nargs="*", help="paths for --self-lint")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print warnings")
    args = ap.parse_args(argv)

    from . import check_jdf, check_ptg, lint_paths, lint_self
    failed = False
    run_all = not args.graph and not args.self_lint and not args.comm

    if args.comm:
        from . import check_comm
        ranks = args.ranks if args.ranks > 1 else 4
        for gname, tp in _model_graphs(args.nt, ranks=ranks):
            if args.graph and gname != args.graph:
                continue
            cr = check_comm(tp, nb_ranks=ranks)
            print(cr.summary())
            for f in cr.errors + (cr.warnings if args.verbose else []):
                print("  " + repr(f))
            failed |= not cr.ok
        return 1 if failed else 0

    if args.graph or run_all:
        if args.graph and args.graph.endswith(".jdf"):
            binds = dict((k, int(v)) for k, v in
                         (b.split("=", 1) for b in args.bind))
            reports = [check_jdf(args.graph, **binds)]
        else:
            graphs = list(_model_graphs(args.nt))
            if args.graph:
                graphs = [(g, tp) for g, tp in graphs if g == args.graph]
                if not graphs:
                    ap.error(f"unknown model {args.graph!r}")
            reports = [check_ptg(tp, nb_ranks=args.ranks)
                       for _name, tp in graphs]
        for r in reports:
            print(r.summary())
            for f in r.errors + (r.warnings if args.verbose else []):
                print("  " + repr(f))
            failed |= not r.ok

    if args.self_lint or run_all:
        lr = lint_paths(args.paths) if args.paths else lint_self()
        print(lr.summary())
        for f in lr.errors + (lr.warnings if args.verbose else []):
            print("  " + repr(f))
        failed |= not lr.ok

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
