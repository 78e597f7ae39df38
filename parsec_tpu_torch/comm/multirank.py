"""N-rank harness: one runtime context per rank over a shared fabric.

Port of ``parsec_tpu/comm/multirank.py`` (the analog of the reference's
oversubscribed-MPI runs, ``mpiexec -np N``): each rank is a thread owning
its own :class:`~parsec_tpu_torch.runtime.context.Context` (rank-local
scheduler, dep table and taskpool registry) attached to one shared
fabric.  The protocol layer (activations, rendezvous GETs, propagation
trees, termdet pending actions) runs as it would across hosts; only the
byte transport is in-process.  A rank that fails poisons the others'
contexts, so their waits raise at once; the first failure is re-raised.
Nothing of the original is left out.

Usage::

    def body(ctx, rank, nranks):
        A = TwoDimBlockCyclic("A", ..., P=2, Q=nranks // 2, myrank=rank)
        ctx.add_taskpool(build_my_ptg(A))
        ctx.wait()
        return A.to_dense()          # this rank's tiles

    parts = run_multirank(4, body)
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from ..runtime.context import Context
from .engine import InprocFabric
from .remote_dep import RemoteDepEngine


def run_multirank(nranks: int, fn: Callable[[Context, int, int], Any],
                  nb_cores: int = 0, timeout: float = 120.0,
                  transport: str = "inproc",
                  devices: list | None = None) -> list[Any]:
    """Run ``fn(ctx, rank, nranks)`` on every rank; returns the per-rank
    results.

    ``nb_cores=0`` ranks drive progress from ``wait()`` (the caller-driven
    mode), the default.  ``transport="device"`` attaches the device-backed
    engine (:mod:`.device_fabric`): rank *i* owns ``devices[i]`` (every
    visible card, one a rank, when ``devices`` is None; the fabric raises
    without a card or with fewer devices than ranks) and payloads move
    device to device.
    """
    if transport == "device":
        from .device_fabric import DeviceFabric
        fabric: InprocFabric = DeviceFabric(nranks, devices)
    elif transport == "inproc":
        fabric = InprocFabric(nranks)
    else:
        raise ValueError(f"transport must be 'inproc' or 'device', got "
                         f"{transport!r}")
    results: list[Any] = [None] * nranks
    errors: list[BaseException | None] = [None] * nranks
    contexts = [Context(nb_cores=nb_cores, nb_ranks=nranks, my_rank=r)
                for r in range(nranks)]
    engines = [RemoteDepEngine(ctx, fabric.attach(r))
               for r, ctx in enumerate(contexts)]
    order: list[int] = []          # ranks in the order they failed
    order_lock = threading.Lock()

    def rank_main(rank: int) -> None:
        ctx = contexts[rank]
        try:
            ctx.start()
            results[rank] = fn(ctx, rank, nranks)
            # every rank stays responsive until the whole fabric is silent
            # (late write-backs and acks), then tears down
            engines[rank].quiesce(timeout=timeout / 2)
            ctx.fini()
        except BaseException as e:  # surfaced to the caller below
            errors[rank] = e
            with order_lock:
                order.append(rank)
            # a failed rank never answers its peers: poison them, so their
            # waits raise now instead of at their deadlines (a device task
            # the failed rank's thread managed may never complete)
            for peer in contexts:
                if peer is not ctx:
                    peer.record_failure(
                        RuntimeError(f"rank {rank} failed: {e!r}"))
            try:
                ctx.abort()
            except Exception:
                pass

    threads = [threading.Thread(target=rank_main, args=(r,),
                                name=f"rank{r}", daemon=True)
               for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"{t.name} did not finish within {timeout}s "
                               f"(errors so far: {errors})")
    if order:       # the first failure, not the ones it poisoned
        raise RuntimeError(f"rank {order[0]} failed") from errors[order[0]]
    return results
