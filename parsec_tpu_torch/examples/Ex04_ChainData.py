"""Ex04: the chain reading and writing the data collection, textual JDF.

Port of the JAX package's ``examples/Ex04_ChainData.py`` (the
reference's ``Ex04_ChainData.jdf``): each task adds its index to the
running value, which threads from ``A(0)`` through the chain and back.
"""

import torch

from parsec_tpu_torch.data.datatype import TileType
from parsec_tpu_torch.data_dist.collection import DictCollection
from parsec_tpu_torch.ptg.jdf import parse_jdf
from parsec_tpu_torch.runtime import Context

NB = 6

JDF = """
A     [type = data]
NB    [type = int]

Task(i)
  i = 0 .. NB - 1
  : A(i)
  RW  V <- (i == 0) ? A(0) : V Task(i - 1)
        -> (i < NB - 1) ? V Task(i + 1) : A(0)
BODY
  V[...] = V + i
END
"""


def main() -> float:
    coll = DictCollection("A", dtt=TileType((1,), torch.float32),
                          init_fn=lambda *k: torch.zeros(1))
    tp = parse_jdf(JDF, "chaindata").build(A=coll, NB=NB)
    ctx = Context(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    out = float(coll.data_of(0).newest_copy().value[0])
    assert out == sum(range(NB)), out
    return out


if __name__ == "__main__":
    print(f"chain-data summed 0..{NB - 1} = {main():.0f}")
