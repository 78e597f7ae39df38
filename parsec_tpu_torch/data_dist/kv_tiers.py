"""Tiered residency for paged KV: card -> host -> peer rank.

Port of ``parsec_tpu/data_dist/kv_tiers.py``.  KV pages are plain
:class:`~parsec_tpu_torch.data.data.Data`, so the CUDA device module's
tile cache already evicts them (a write-back to the host copy,
``device/cuda.py``); this module keeps the books and the way back:

- :class:`KVTierMap` subscribes to the device's write-backs
  (:func:`~parsec_tpu_torch.device.cuda.register_spill_hook`) and keeps
  the host-tier ledger: which of its collection's pages live on the host
  alone and how many bytes they hold (``host_tier_bytes``, also in
  ``PagedKVCollection.stats()``).
- :meth:`KVTierMap.prefetch_seqs` stages spilled pages back toward the
  card ahead of the decode wavefront
  (:meth:`~parsec_tpu_torch.device.cuda.CUDADevice.prefetch_data`: one
  batch of async H2D copies on the copy stream).  It finds the ``cuda``
  device and never falls back to the host: with no such device nothing
  is prefetched.  The batcher calls it before it builds an iteration's
  pools; a failed prefetch is advisory (on-demand stage-in still serves
  the page) and counted.
- Cold host-tier pages can spill one hop further, to a **peer rank**:
  :meth:`KVTierMap.attach_peer` wires a comm engine; a spill pushes the
  page's bytes by an AM, the peer holds them in a :class:`PeerKVStore`
  under a registered handle, and the way back is a prefetch GET
  (``CommEngine.prefetch_get``, fragmented under the credit window for
  large pages).  The local bytes drop only once the peer acknowledges
  custody.  Where the peer's engine lives in this process (an in-process
  or device fabric), the tier map progresses the fabric's engines
  itself; across processes each rank progresses its own.

A landed page's host copy is a CPU tensor: the tier's pages come home to
the host and go on to the card by the prefetch like any other
host-tier page.

Locking: the tier lock is a leaf, never held across calls into the
collection, the device or the engine; the runtimelint contract tables
(``_LOCK_PROTECTED``, ``_LOCK_ORDER``) check it.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Sequence

import torch

from ..core.params import params as _params
from ..data.data import COHERENCY_INVALID, COHERENCY_SHARED, nbytes_of
from .paged_kv import PagedKVCollection

# the runtime lint's contract (analysis/runtimelint.py)
_LOCK_PROTECTED = {
    "KVTierMap._host": "_lock",
    "KVTierMap._peer": "_lock",
    "KVTierMap._spill_ref": "_lock",
    "KVTierMap._issued": "_lock",
    "KVTierMap.prefetch_inflight": "_lock",
    "KVTierMap.prefetched_pages": "_lock",
    "KVTierMap.spills": "_lock",
    "KVTierMap.peer_spills": "_lock",
    "KVTierMap.peer_fetches": "_lock",
    "PeerKVStore._held": "_lock",
    "PeerKVStore.pages_held": "_lock",
    "PeerKVStore.bytes_held": "_lock",
}
_LOCK_ORDER = ("_lock",)

_params.register("kv_host_tier_bytes", 0,
                 "byte budget for host-tier (device-evicted) KV pages; "
                 "past it, cold pages spill one hop further to the "
                 "attached peer rank (0 = unbounded host tier)")

# AM tags of the peer tier (the user tag space of comm/engine.py)
AM_TAG_KV_SPILL = 24        # (key, version, tensor) -> the peer holds it
AM_TAG_KV_SPILL_ACK = 25    # (key, handle wire) -> the spiller records it


def _on_host(value: Any) -> bool:
    return isinstance(value, torch.Tensor) and value.device.type == "cpu"


class KVTierMap:
    """Residency ledger and prefetcher of one :class:`PagedKVCollection`
    (see the module docstring)."""

    def __init__(self, kv: PagedKVCollection) -> None:
        self.kv = kv
        kv.tier = self        # stats() answers the tier keys through us
        self._lock = threading.Lock()
        # host tier: data key -> (weakref(Data), nbytes) for pages the
        # device wrote back; pruned when re-staged or freed
        self._host: dict[Any, tuple[Any, int]] = {}
        # peer tier: data key -> (rwire, version, nbytes); _spill_ref holds
        # the Data weakly between the spill and its ACK
        self._peer: dict[Any, tuple[Any, int, int]] = {}
        self._spill_ref: dict[Any, Any] = {}
        self._issued: set = set()    # peer GETs in flight (keys)
        self._engine: Any = None
        self._peer_rank: int | None = None
        self.prefetch_inflight = 0
        self.prefetched_pages = 0
        self.prefetch_failures = 0
        self.spills = 0               # device -> host write-backs seen
        self.peer_spills = 0
        self.peer_fetches = 0
        from ..device.cuda import register_spill_hook
        register_spill_hook(self)

    # -- the device write-back hook --------------------------------------
    def note_spill(self, data: Any, nbytes: int) -> None:
        """Called by the device module after every write-back that left a
        datum on the host alone; filters to this map's collection."""
        if getattr(data, "dc", None) is not self.kv:
            return
        with self._lock:
            self._host[data.key] = (weakref.ref(data), int(nbytes))
            self.spills += 1
        self._maybe_spill_to_peer()

    def _host_pages_locked(self) -> list[tuple[Any, Any, int]]:  # lint: holds(_lock)
        """Live, still host-resident-only entries; prunes the rest."""
        out, dead = [], []
        for key, (ref, nb) in self._host.items():
            d = ref()
            host = None if d is None else d.get_copy(0)
            if host is None or not _on_host(host.value) \
                    or host.coherency == COHERENCY_INVALID:
                dead.append(key)      # freed, recycled, or peer-spilled
                continue
            with d._lock:
                restaged = any(i != 0 and c.coherency != COHERENCY_INVALID
                               for i, c in d.device_copies.items())
            if restaged:
                dead.append(key)      # back on the card
                continue
            out.append((key, d, nb))
        for key in dead:
            self._host.pop(key, None)
        return out

    @property
    def host_tier_bytes(self) -> int:
        with self._lock:
            return sum(nb for _, _, nb in self._host_pages_locked())

    # -- device prefetch (the way back) ----------------------------------
    def _device(self) -> Any:
        from ..device.device import registry
        for dev in registry.by_type("cuda"):
            if hasattr(dev, "prefetch_data"):
                return dev
        return None

    def prefetch_seqs(self, seqs: Sequence[Any]) -> int:
        """Stage the listed sequences' pages that live off the card back
        toward it, one superpool ahead of the decode wavefront: peer-tier
        pages come home first (prefetch GETs), then the host-tier pages
        move in one batch of async H2D copies.  Advisory: a failure is
        counted in ``prefetch_failures`` and stages nothing (the pool's
        own stage-in still serves every page).  Returns the number of
        pages staged to the card."""
        try:
            return self._prefetch(seqs)
        except Exception:             # noqa: BLE001 — advisory, counted
            with self._lock:
                self.prefetch_failures += 1
            return 0

    def _prefetch(self, seqs: Sequence[Any]) -> int:
        if self._engine is not None:
            self._progress()          # spill ACKs land: custody settles
        with self._lock:
            if not self._host and not self._peer:
                return 0      # nothing ever spilled: stay off the hot path
        self._pull_peer_pages(seqs)
        dev = self._device()
        if dev is None:
            return 0
        datas = []
        for seq in seqs:
            try:
                table = self.kv.block_table(seq)
            except KeyError:
                continue               # retired meanwhile
            for page in range(len(table)):
                d = self.kv.data_of(seq, page)
                host = d.get_copy(0)
                if host is None or not _on_host(host.value) \
                        or host.coherency == COHERENCY_INVALID:
                    continue
                cur = d.get_copy(dev.device_index)
                if cur is not None and cur.version >= host.version \
                        and cur.coherency != COHERENCY_INVALID:
                    continue
                datas.append(d)
        if not datas:
            return 0
        with self._lock:
            self.prefetch_inflight += len(datas)
        try:
            n = dev.prefetch_data(datas)
        finally:
            with self._lock:
                self.prefetch_inflight -= len(datas)
        with self._lock:
            self.prefetched_pages += n
        return n

    # -- the peer tier ----------------------------------------------------
    def attach_peer(self, engine: Any, peer_rank: int) -> None:
        """Wire a comm engine: host-tier pages past ``kv_host_tier_bytes``
        spill to ``peer_rank`` (which runs a :class:`PeerKVStore` on its
        engine), and the prefetch pulls them back by GETs."""
        self._engine = engine
        self._peer_rank = int(peer_rank)
        engine.tag_register(AM_TAG_KV_SPILL_ACK, self._on_spill_ack)

    def _engines(self) -> list:
        fab = getattr(self._engine, "fabric", None)
        return [e for e in getattr(fab, "engines", []) if e is not None] \
            or [self._engine]

    def _progress(self) -> None:
        for e in self._engines():
            e.progress()

    def _maybe_spill_to_peer(self) -> None:
        budget = _params.get("kv_host_tier_bytes")
        if not budget or self._engine is None:
            return
        with self._lock:
            pages = self._host_pages_locked()
            total = sum(nb for _, _, nb in pages)
            victims = []
            for key, d, nb in pages:        # insertion order: coldest
                if total <= budget:
                    break
                if key in self._peer:
                    continue    # its spill is in flight: one at a time
                victims.append((key, d, nb))
                total -= nb
            for key, _, _ in victims:
                self._host.pop(key, None)
        for key, d, nb in victims:
            self._spill_page_to_peer(key, d)

    def _spill_page_to_peer(self, key: Any, d: Any) -> None:
        host = d.get_copy(0)
        if host is None or not _on_host(host.value):
            return
        value = host.value.clone()
        with self._lock:
            # the handle arrives with the ACK; until then the local host
            # copy is the page's only copy and stays
            self._peer[key] = (None, int(host.version), nbytes_of(value))
            self._spill_ref[key] = weakref.ref(d)
            self.peer_spills += 1
        self._engine.send_am(AM_TAG_KV_SPILL, self._peer_rank,
                             {"key": key, "version": int(host.version),
                              "reply_to": self._engine.rank,
                              "value": value})

    def _on_spill_ack(self, eng: Any, src: int, msg: dict) -> None:
        key = msg["key"]
        with self._lock:
            ent = self._peer.get(key)
            ref = self._spill_ref.pop(key, None)
            if ent is None:
                return
            self._peer[key] = (tuple(msg["rwire"]), ent[1], ent[2])
        # the peer holds the bytes: drop the local copy, unless the page
        # was rewritten since the spill (its peer replica is then stale:
        # the entry goes and the handle is drained by one GET)
        d = ref() if ref is not None else None
        stale = True
        if d is not None:
            with d._lock:
                host = d.device_copies.get(0)
                if host is not None and _on_host(host.value) \
                        and host.version == ent[1] \
                        and len(d.device_copies) == 1:
                    host.value = None
                    host.coherency = COHERENCY_INVALID
                    stale = False
        if stale:
            with self._lock:
                rwire = self._peer.pop(key, (None,))[0]
            if rwire is not None:
                self._engine.get(rwire, lambda _v: None)

    def _pull_peer_pages(self, seqs: Sequence[Any],
                         drain_timeout: float = 30.0) -> int:
        """Pull the listed sequences' peer-resident pages home and wait
        (bounded) until they landed: the pool about to run reads them.
        The wait progresses the engines, which may settle the custody of
        other pages of these sequences (their local bytes then drop): it
        goes on until none of their pages is on the peer, or awaits its
        ACK, or is in flight.  A page's peer address stays until its bytes
        land, so a transfer that dies leaves it addressable."""
        if self._engine is None:
            return 0
        keys = set()
        for seq in seqs:
            try:
                for phys in self.kv.block_table(seq):
                    keys.add((self.kv.name, phys))
            except KeyError:
                continue
        issued = 0
        deadline = time.monotonic() + drain_timeout
        while True:
            with self._lock:
                mine = [k for k in keys if k in self._peer]
                todo = [(k, self._peer[k]) for k in mine
                        if self._peer[k][0] is not None
                        and k not in self._issued]
                for k, _ in todo:
                    self._issued.add(k)
                    self.prefetch_inflight += 1
            if not mine:
                return issued
            for key, (rwire, version, _) in todo:
                try:
                    self._engine.prefetch_get(
                        rwire,
                        lambda v, _k=key, _v=version: self._land(_k, _v, v))
                except Exception:     # noqa: BLE001 — the address survives
                    with self._lock:
                        self._issued.discard(key)
                        self.prefetch_inflight -= 1
                        self.prefetch_failures += 1
                    continue
                issued += 1
            if time.monotonic() >= deadline:
                with self._lock:
                    for key in list(self._issued & keys):
                        self._issued.discard(key)
                        self.prefetch_inflight -= 1
                        self.prefetch_failures += 1
                return issued
            self._progress()
            time.sleep(0.0002)

    def _land(self, key: Any, version: int, value: Any) -> None:
        with self._lock:
            if key in self._issued:
                self._issued.discard(key)
                self.prefetch_inflight -= 1
            self._peer.pop(key, None)
            self.peer_fetches += 1
        with self.kv._lock:
            d = self.kv._pages.get(key[1])
        if d is None:
            return                      # freed while remote
        value = value.to("cpu")
        with d._lock:
            host = d.device_copies.get(0)
            if host is None or host.version > version:
                return                  # recycled meanwhile: stale
            host.value = value
            host.version = version
            host.coherency = COHERENCY_SHARED
        with self._lock:
            self._host[key] = (weakref.ref(d), nbytes_of(value))

    # -- introspection ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            host_pages = self._host_pages_locked()
            return {
                "host_tier_pages": len(host_pages),
                "host_tier_bytes": sum(nb for _, _, nb in host_pages),
                "peer_tier_pages": len(self._peer),
                "peer_tier_bytes": sum(e[2] for e in self._peer.values()),
                "prefetch_inflight": self.prefetch_inflight,
                "prefetched_pages": self.prefetched_pages,
                "prefetch_failures": self.prefetch_failures,
                "spills": self.spills,
                "peer_spills": self.peer_spills,
                "peer_fetches": self.peer_fetches,
            }


class PeerKVStore:
    """The serving side of the peer tier: holds spilled pages under
    registered handles, so the owner can pull them back by a GET.  One per
    engine, on the rank that lends its memory."""

    def __init__(self, engine: Any) -> None:
        self.engine = engine
        self._lock = threading.Lock()
        self._held: dict[tuple[int, Any], Any] = {}   # (src, key) -> handle
        self.pages_held = 0
        self.bytes_held = 0
        engine.tag_register(AM_TAG_KV_SPILL, self._on_spill)

    def _on_spill(self, eng: Any, src: int, msg: dict) -> None:
        value = msg["value"]
        nb = nbytes_of(value)
        hkey = (msg["reply_to"], msg["key"])

        def drained() -> None:
            with self._lock:
                self._held.pop(hkey, None)
                self.pages_held -= 1
                self.bytes_held -= nb

        # owned: the message handed us a tensor of our own
        h = self.engine.mem_register(value, refcount=1, owned=True)
        h.on_drained = drained
        with self._lock:
            self._held[hkey] = h
            self.pages_held += 1
            self.bytes_held += nb
        self.engine.send_am(AM_TAG_KV_SPILL_ACK, msg["reply_to"],
                            {"key": msg["key"], "rwire": h.wire()})

    def stats(self) -> dict:
        with self._lock:
            return {"pages_held": self.pages_held,
                    "bytes_held": self.bytes_held}
