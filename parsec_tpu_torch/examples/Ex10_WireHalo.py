"""Ex10: partial-tile wire datatypes: halo edges ship ghost regions, not
whole tiles.

Port of the JAX package's ``examples/Ex10_WireHalo.py`` (the reference's
``[type_remote = LR, displ_remote = ...]`` dep properties,
``tests/apps/stencil/stencil_1D.jdf:83-92``): a ring of ranks exchanges
the edge column of an (MB, NB) tile each step; with ``wire=`` the
payload is MB elements instead of MB*NB, and the byte counters prove it.
The consumer branches on shape the way the reference's
``CORE_copydata_stencil_1D`` branches on local against remote buffers.
"""

import torch

from parsec_tpu_torch import ptg
from parsec_tpu_torch.comm.multirank import run_multirank
from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic

MB, NB, STEPS = 32, 64, 4


def _rank_body(ctx, rank, nranks):
    # one tile per rank, in a row: tile j lives on rank j
    M = TwoDimBlockCyclic("M", lm=MB, ln=nranks * NB, mb=MB, nb=NB,
                          P=1, Q=nranks, myrank=rank,
                          init_fn=lambda i, j, s:
                          torch.full(s, float(j)))

    p = ptg.PTGBuilder("ring", M=M, NT=nranks, T=STEPS)
    t = p.task("ST",
               t=ptg.span(0, lambda g, l: g.T - 1),
               j=ptg.span(0, lambda g, l: g.NT - 1))
    t.affinity("M", lambda g, l: (0, l.j))

    fc = t.flow("C", ptg.RW)
    fc.input(data=("M", lambda g, l: (0, l.j)),
             guard=lambda g, l: l.t == 0)
    fc.input(pred=("ST", "C", lambda g, l: {"t": l.t - 1, "j": l.j}),
             guard=lambda g, l: l.t > 0)
    fc.output(succ=("ST", "C", lambda g, l: {"t": l.t + 1, "j": l.j}),
              guard=lambda g, l: l.t < g.T - 1)
    # the halo edge to the right neighbour: only the last column crosses
    # the wire (drop wire= and the whole MB x NB tile ships instead)
    fc.output(succ=("ST", "L",
                    lambda g, l: {"t": l.t + 1,
                                  "j": (l.j + 1) % g.NT}),
              guard=lambda g, l: l.t < g.T - 1,
              wire=(slice(None), slice(-1, None)))
    fc.output(data=("M", lambda g, l: (0, l.j)),
              guard=lambda g, l: l.t == g.T - 1)

    fl = t.flow("L", ptg.READ)
    fl.input(pred=("ST", "C",
                   lambda g, l: {"t": l.t - 1,
                                 "j": (l.j - 1) % g.NT}),
             guard=lambda g, l: l.t > 0)

    def body(es, task, g, l):
        c = task.flow_data("C").value
        left = task.flow_data("L")
        if left is not None:
            ghost = left.value
            # a local neighbour hands the whole tile; a remote one's
            # payload IS the ghost column
            col = ghost if ghost.shape[1] == 1 else ghost[:, -1:]
            c[:, :1] = col

    t.body(body)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=60)
    ctx.comm_barrier()
    tile = M.data_of(0, rank).newest_copy().value
    # after STEPS-1 exchanges, my first column carries my left
    # neighbour's fill value
    left_val = float((rank - 1) % nranks)
    assert float(tile[0, 0]) == left_val, (rank, float(tile[0, 0]),
                                           left_val)
    return ctx.comm_engine.payload_bytes_staged


def main() -> int:
    nranks = 4
    staged = sum(run_multirank(nranks, _rank_body))
    full = MB * NB * 4
    region = MB * 1 * 4
    print(f"ring halo over {nranks} ranks: {staged} payload bytes "
          f"staged ({region}B/edge vs {full}B full tiles — "
          f"{full // region}x cut)")
    assert staged % region == 0 and staged < full
    return staged


if __name__ == "__main__":
    main()
