"""Collection operator taskpools: map, reduce and broadcast.

Port of ``parsec_tpu/data_dist/operators.py`` (the reference's
``map_operator.c``, ``apply.jdf``, ``reduce*.jdf`` and ``broadcast.jdf``):
PTG pools that apply a user callable to every tile of a collection, reduce
every tile along a binomial tree, or copy one tile into every tile of a
destination.  On several ranks map runs where each tile lives, the
reduce's cross-rank hops ride the remote-dep activations, and the
broadcast's one-producer fan-out rides the runtime's propagation trees.

Where the bodies run.  With ``devices="cuda"`` (the default) each class
carries only a CUDA chore: the device module stages the tiles and the
callable gets each tile's tensor on the card; the chore bumps the version
of what it wrote, so the newest copy stays there until a write-back.
With no CUDA device registered such a pool fails with no runnable chore.
``devices="cpu"`` takes host bodies over the home tiles.  A reduce's
partials are detached from the collection's tiles (the chain rebinds its
accumulator and must not write a source tile); its result lands in
``out["value"]`` as a tensor on the device it was reduced on.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .. import ptg
from ..data.data import (ACCESS_WRITE, COHERENCY_OWNED, Data, DataCopy,
                         data_create)
from .collection import DataCollection
from .collection import enumerate_keys as _all_keys


def _chore(t: Any, devices: str, fn: Callable) -> None:
    """Attach ``fn(task, l, device)`` as the class's one chore: a CUDA
    chore that bumps the versions it wrote, or a host body."""
    if devices not in ("cuda", "cpu"):
        raise ValueError(f"devices must be 'cuda' or 'cpu', got {devices!r}")
    if devices == "cpu":
        t.body(lambda es, task, g, l: fn(task, l, None))
        return

    def on_card(es: Any, task: Any, device: Any) -> None:
        before = [None if c is None else c.value for c in task.data]
        fn(task, ptg.dsl._ns(task.locals), device)
        for f in task.task_class.flows:
            c = task.data[f.flow_index]
            if f.is_ctl or c is None or not f.access & ACCESS_WRITE:
                continue
            if c.device_index == device.device_index \
                    or c.value is not before[f.flow_index]:
                c.version += 1

    t.body(on_card, device="cuda")


def _detached(value: torch.Tensor, device: Any, key: Any) -> DataCopy:
    """A copy of ``value`` that belongs to no collection: on the device
    the chore runs on (the device module's index), else the host."""
    if device is None:
        return data_create(value.clone(), key=key).get_copy(0)
    d = Data(key=key)
    c = DataCopy(d, device.device_index, value=value.clone())
    c.coherency = COHERENCY_OWNED
    c.version = 1
    d.attach_copy(c)
    d.owner_device = device.device_index
    return c


def map_taskpool(dc: DataCollection, fn: Callable[..., Any],
                 name: str = "map", devices: str = "cuda") -> Any:
    """Apply ``fn(key, tile) -> tile | None`` to every tile, in place or by
    returning a replacement (``parsec_map_operator`` / ``apply.jdf``)."""
    keys = _all_keys(dc)
    p = ptg.PTGBuilder(name, DC=dc, KEYS=keys, FN=fn)
    t = p.task("MAP", i=ptg.span(0, lambda g, l: len(g.KEYS) - 1))
    t.affinity("DC", lambda g, l: g.KEYS[l.i])
    f = t.flow("T", ptg.RW)
    f.input(data=("DC", lambda g, l: g.KEYS[l.i]))
    f.output(data=("DC", lambda g, l: g.KEYS[l.i]))

    def body(task: Any, l: Any, device: Any) -> None:
        copy = task.flow_data("T")
        out = fn(keys[l.i], copy.value)
        if out is not None:
            copy.value = out

    _chore(t, devices, body)
    return p.build()


def reduce_taskpool(dc: DataCollection, op: Callable[[Any, Any], Any],
                    out: dict | None = None,
                    transform: Callable[[Any], Any] | None = None,
                    name: str = "reduce", devices: str = "cuda") -> Any:
    """Binomial-tree reduction of every tile into ``out['value']`` on the
    rank owning the first key (``reduce*.jdf``).

    ``op(acc, partial) -> acc`` must be associative.  ``transform`` maps
    each tile to its level-0 partial (identity by default): needed when
    tiles are ragged and ``op`` is elementwise (``torch.sum`` for a
    scalar total).  Level ``s`` combines partial ``i`` with partial
    ``i + 2**s``."""
    keys = _all_keys(dc)
    n = len(keys)
    levels = max(1, (n - 1).bit_length())
    result = out if out is not None else {}
    tf = transform or (lambda x: x)
    p = ptg.PTGBuilder(name, DC=dc, KEYS=keys, N=n, LVL=levels)

    t = p.task("RED",
               s=ptg.span(0, lambda g, l: g.LVL - 1),
               i=ptg.span(0, lambda g, l: max(0, (g.N + (1 << (l.s + 1)) - 1)
                                              // (1 << (l.s + 1)) - 1)))
    t.affinity("DC", lambda g, l: g.KEYS[l.i << (l.s + 1)])

    fa = t.flow("ACC", ptg.RW)
    fa.input(data=("DC", lambda g, l: g.KEYS[l.i * 2 * (1 << l.s)]),
             guard=lambda g, l: l.s == 0)
    fa.input(pred=("RED", "ACC", lambda g, l: {"s": l.s - 1, "i": l.i * 2}),
             guard=lambda g, l: l.s > 0)
    fa.output(succ=("RED", "ACC",
                    lambda g, l: {"s": l.s + 1, "i": l.i // 2}),
              guard=lambda g, l: l.s < g.LVL - 1 and l.i % 2 == 0)
    fa.output(succ=("RED", "RHS",
                    lambda g, l: {"s": l.s + 1, "i": l.i // 2}),
              guard=lambda g, l: l.s < g.LVL - 1 and l.i % 2 == 1)

    fb = t.flow("RHS", ptg.READ)
    fb.input(data=("DC", lambda g, l: g.KEYS[(l.i * 2 + 1) * (1 << l.s)]),
             guard=lambda g, l: l.s == 0
             and (l.i * 2 + 1) * (1 << l.s) < g.N)
    fb.input(pred=("RED", "ACC",
                   lambda g, l: {"s": l.s - 1, "i": l.i * 2 + 1}),
             guard=lambda g, l: l.s > 0
             and (l.i * 2 + 1) * (1 << l.s) < g.N)

    def body(task: Any, l: Any, device: Any) -> None:
        a = task.flow_data("ACC").value
        rhs = task.flow_data("RHS")
        b = None if rhs is None else rhs.value
        if l.s == 0:        # raw tiles map through the level-0 transform
            a = tf(a)
            b = tf(b) if b is not None else None
        val = op(a, b) if b is not None else a
        if l.s == 0:
            task.set_flow_data("ACC", _detached(torch.as_tensor(val),
                                                device, (name, "part", l.i)))
        else:
            task.flow_data("ACC").value = val
        if l.s == levels - 1:
            result["value"] = task.flow_data("ACC").value

    _chore(t, devices, body)
    return p.build()


def broadcast_taskpool(src: DataCollection, src_key: tuple,
                       dst: DataCollection, name: str = "bcast",
                       devices: str = "cuda") -> Any:
    """Copy tile ``src(src_key)`` into every tile of ``dst``
    (``broadcast.jdf``, the ``Ex05`` shape).  Over several ranks the
    one-producer many-consumer flow rides the propagation tree."""
    dst_keys = _all_keys(dst)
    p = ptg.PTGBuilder(name, SRC=src, DST=dst, KEY=src_key, DKEYS=dst_keys)
    nodes = len(dst_keys)

    w = p.task("ROOT", z=ptg.span(0, 0))
    w.affinity("SRC", lambda g, l: g.KEY)
    fw = w.flow("A", ptg.RW)
    fw.input(data=("SRC", lambda g, l: g.KEY))
    for r in range(nodes):
        fw.output(succ=("COPY", "X", lambda g, l, r=r: {"r": r}))
    _chore(w, devices, lambda task, l, device: None)

    if nodes == 0:      # an empty destination: ROOT alone
        return p.build()

    t = p.task("COPY", r=ptg.span(0, nodes - 1))
    t.affinity("DST", lambda g, l: g.DKEYS[l.r])
    fx = t.flow("X", ptg.READ)
    fx.input(pred=("ROOT", "A", lambda g, l: {"z": 0}))
    fy = t.flow("Y", ptg.RW)
    fy.input(data=("DST", lambda g, l: g.DKEYS[l.r]))
    fy.output(data=("DST", lambda g, l: g.DKEYS[l.r]))

    def body(task: Any, l: Any, device: Any) -> None:
        y = task.flow_data("Y")
        if device is not None and not y.value.is_cuda:
            # the host stand-in's device copy aliases the home tile
            y.value = y.value.clone()
        y.value.copy_(task.flow_data("X").value)     # broadcasts

    _chore(t, devices, body)
    return p.build()
