"""Ex01: one task class, one body, through the textual JDF front-end.

Port of the JAX package's ``examples/Ex01_HelloWorld.py`` (the
reference's ``Ex01_HelloWorld.jdf``): a single HelloWorld task whose body
runs once.  ``SINK`` shows how build-time globals flow into bodies.
"""

from parsec_tpu_torch.ptg.jdf import parse_jdf
from parsec_tpu_torch.runtime import Context

JDF = """
SINK  [type = int]

HelloWorld(k)
  k = 0 .. 0
BODY
  SINK.append("Hello World from task %d" % k)
END
"""


def main() -> list:
    sink: list = []
    tp = parse_jdf(JDF, "hello").build(SINK=sink)
    ctx = Context(nb_cores=0)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    assert sink == ["Hello World from task 0"], sink
    return sink


if __name__ == "__main__":
    print(main()[0])
