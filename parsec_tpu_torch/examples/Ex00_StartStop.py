"""Ex00: runtime lifecycle: init a context, start it, wait, shut down.

Port of the JAX package's ``examples/Ex00_StartStop.py`` (the reference's
``examples/Ex00_StartStop.c``): no taskpool at all, just the init /
start / wait / fini sequence.
"""

from parsec_tpu_torch.runtime import Context


def main() -> str:
    ctx = Context(nb_cores=0)
    ctx.start()
    ctx.wait()      # nothing enqueued: returns immediately
    ctx.fini()
    return "context lifecycle ok"


if __name__ == "__main__":
    print(main())
