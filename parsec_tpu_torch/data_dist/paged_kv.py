"""Paged KV cache as a :class:`DataCollection`: the LLM serving datum.

Port of ``parsec_tpu/data_dist/paged_kv.py``: a transformer KV cache laid
out as fixed-size pages.  Logical keys are ``(seq_id, page_idx)``; a
per-sequence block table maps them to physical pages allocated from a
free list, so sequences grow ragged without reallocation, a fork shares
prompt pages copy-on-write, and the physical page is the residency unit:
each page is an ordinary :class:`~parsec_tpu_torch.data.data.Data`, so
the CUDA device module's tile cache caches, evicts and writes back pages
like matrix tiles.

Page layout: one ``(3, page_size, heads, head_dim)`` tensor per page —
channel 0 the keys, channel 1 the values, channel 2 metadata with
``page[2, 0, 0, 0]`` the fill count.  The fill rides in the tensor, so
every live sequence's pages share one shape and the device batches them
into one kernel launch.

**The recycle-detach discipline** (:meth:`PagedKVCollection._scrub_copies`):
a page that is recycled or privatized may still have a copy on the card
that runs ahead of the host copy, sitting in the device's tile cache or
in its deferred-eviction queue.  Such a copy is invalidated and detached
before the host copy is rewritten, and the new host version jumps past
every version any copy reached: the device's stage-in then misses it,
and its write-back skips it (``device/cuda.py``), so it can neither
satisfy a stage-in nor write over the rewritten host page.

The prefix cache shares whole prompt pages through :meth:`fork_prefix`;
speculative decode stages draft k/v through :meth:`update_page_host` and
truncates a rejected tail through :meth:`rollback_tail`.  The newest
bytes of a tail page often live only on the card (K2's pool and the OUT
and PF appends write them there), so both rewrite from the newest copy,
brought home by one D2H, and leave the host copy on the CPU, versioned
past every device copy they detach: a deferred write-back of a rejected
draft's k/v is then skipped, never written over the rolled-back page.
A :class:`~parsec_tpu_torch.data_dist.kv_tiers.KVTierMap` attaches as
``tier`` and answers the tier keys of :meth:`PagedKVCollection.stats`.
Every page is rank 0's unless ``rank_of_fn(seq, page)`` names another
(the sharded server pins a rank's cache to that rank).

Left out: the JAX package's distribution of sequences over ``nodes``
ranks by a hash of the sequence id (the port's caches live on one rank
each).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from ..data.data import COHERENCY_INVALID, COHERENCY_SHARED, Data, data_create
from ..data.datatype import TileType, torch_dtype
from .collection import DataCollection

K_CH, V_CH, META_CH = 0, 1, 2


def _home(value: torch.Tensor) -> torch.Tensor:
    """A host tensor of its own with ``value``'s bytes: a D2H of a card's
    tensor, else a copy."""
    return value.to("cpu") if value.device.type != "cpu" else value.clone()


class PagedKVCollection(DataCollection):
    """Block-table-backed paged KV cache on one rank."""

    def __init__(self, name: str = "KV", page_size: int = 16,
                 num_heads: int = 4, head_dim: int = 8,
                 dtype: Any = torch.float32, max_pages: int = 4096,
                 rank_of_fn: Callable | None = None) -> None:
        super().__init__(name)
        self._rank_of_fn = rank_of_fn
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = torch_dtype(dtype)
        self.max_pages = int(max_pages)
        self.default_dtt = TileType(
            (3, self.page_size, self.num_heads, self.head_dim), self.dtype)
        self._lock = threading.RLock()
        self._pages: dict[int, Data] = {}        # phys id -> page Data
        self._refs: dict[int, int] = {}          # phys id -> sharers
        self._free: list[int] = []               # recycled phys ids
        self._next_phys = 0
        self._tables: dict[Any, list[int]] = {}  # phys ids per seq
        self._lens: dict[Any, int] = {}          # seq -> appended tokens
        self.pages_allocated = 0
        self.pages_recycled = 0
        self.cow_copies = 0
        # the prefix cache's counters (llm/prefix_tree.py bumps them)
        self.prefix_hits = 0
        self.prefix_pages_reused = 0
        # speculative-decode rollback tallies (rollback_tail)
        self.tail_rollbacks = 0
        self.slots_rolled_back = 0
        self.tier: Any = None         # data_dist/kv_tiers.py sets it

    # -- the DataCollection vtable --------------------------------------
    def rank_of(self, *key) -> int:
        return 0 if self._rank_of_fn is None else self._rank_of_fn(*key)

    def data_of(self, *key) -> Data:
        seq, page = key
        with self._lock:
            return self._pages[self._tables[seq][page]]

    def has_key(self, *key) -> bool:
        """A ``(seq, page)`` key exists iff the sequence is live and the
        page is inside its block table."""
        if len(key) != 2:
            return False
        seq, page = key
        with self._lock:
            table = self._tables.get(seq)
            return table is not None and isinstance(page, int) \
                and 0 <= page < len(table)

    # -- page lifecycle --------------------------------------------------
    @staticmethod
    def _scrub_copies(d: Data) -> int:
        """Invalidate and detach every device copy of one page, and
        return the highest version any copy reached, which the caller's
        new host version must jump past."""
        with d._lock:
            maxv = max(c.version for c in d.device_copies.values())
            for idx in [i for i in d.device_copies if i != 0]:
                d.detach_copy(idx).coherency = COHERENCY_INVALID
        return maxv

    def _rewrite_host(self, d: Data, value: torch.Tensor) -> None:
        """Make ``value`` the page's one true version: every device copy
        detached, the host copy versioned past them all."""
        host = d.get_copy(0)
        maxv = self._scrub_copies(d)
        host.value = value
        host.version = maxv + 1
        host.coherency = COHERENCY_SHARED
        d.owner_device = 0

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.default_dtt.shape, dtype=self.dtype)

    def _new_page_locked(self) -> int:  # holds(_lock)
        if self._free:
            phys = self._free.pop()
            self.pages_recycled += 1
            # recycle the Data in place: fresh zeros, stale copies
            # scrubbed, host version jumped past every copy
            self._rewrite_host(self._pages[phys], self._zeros())
        else:
            if self._next_phys >= self.max_pages:
                raise MemoryError(
                    f"{self.name}: out of KV pages "
                    f"({self.max_pages} x {self.page_bytes} B)")
            phys = self._next_phys
            self._next_phys += 1
            self._pages[phys] = data_create(
                self._zeros(), key=(self.name, phys), dtt=self.default_dtt,
                dc=self)
        self._refs[phys] = 1
        self.pages_allocated += 1
        return phys

    def alloc_seq(self, seq: Any) -> None:
        """Register a sequence with an empty block table."""
        with self._lock:
            if seq in self._tables:
                raise KeyError(f"sequence {seq!r} already allocated")
            self._tables[seq] = []
            self._lens[seq] = 0

    def alloc_page(self, seq: Any) -> int:
        """Append one fresh physical page to ``seq``'s table; returns the
        new logical page index."""
        with self._lock:
            table = self._tables[seq]
            table.append(self._new_page_locked())
            return len(table) - 1

    def ensure_tail_slot(self, seq: Any) -> tuple[int, int]:
        """Make the next token's write slot real and writable: allocate a
        tail page when the table is empty or the tail is full, and
        copy-on-write a tail shared with a forked sibling.  Returns
        ``(page_idx, slot)``."""
        with self._lock:
            table = self._tables[seq]
            page, slot = divmod(self._lens[seq], self.page_size)
            if page >= len(table):
                table.append(self._new_page_locked())
            elif self._refs[table[page]] > 1:
                self._privatize_locked(table, page)
            return page, slot

    def _privatize_locked(self, table: list[int],
                          page: int) -> int:  # holds(_lock)
        """Replace ``table[page]`` with a private copy of its bytes, the
        CoW divergence point.  The copy sources the NEWEST live copy (a
        sibling's on-device writes run ahead of the host copy), and the
        private page's host version jumps past every version the shared
        page reached."""
        old = table[page]
        old_d = self._pages[old]
        src = old_d.newest_copy()
        if src is None or src.value is None:
            raise RuntimeError(
                f"{self.name}: page {old} has no live copy to privatize from")
        self._refs[old] -= 1
        phys = self._new_page_locked()
        with old_d._lock:
            maxv = max((c.version for c in old_d.device_copies.values()),
                       default=0)
        dst = self._pages[phys].get_copy(0)
        dst.value = _home(src.value)
        dst.version = max(dst.version, maxv) + 1
        table[page] = phys
        self.cow_copies += 1
        return phys

    def note_appended(self, seq: Any, n: int = 1) -> None:
        """Advance the host-side length ledger after ``n`` tokens' K/V
        landed (the task bodies update the in-tensor fill counts)."""
        with self._lock:
            self._lens[seq] += n

    def fork(self, parent: Any, child: Any) -> None:
        """Copy-on-write fork: the child shares every parent page; a
        shared tail is privatized lazily by :meth:`ensure_tail_slot`."""
        with self._lock:
            if child in self._tables:
                raise KeyError(f"sequence {child!r} already allocated")
            table = list(self._tables[parent])
            for phys in table:
                self._refs[phys] += 1
            self._tables[child] = table
            self._lens[child] = self._lens[parent]

    def fork_prefix(self, parent: Any, child: Any, pages: int) -> None:
        """Prefix fork: the child shares only the parent's first ``pages``
        pages, and its ledger starts at the page boundary — the prefix
        cache's adoption seam (``llm/prefix_tree.py``).  Only whole pages
        are shared, so a prefix fork never leaves a shared partial tail."""
        with self._lock:
            if child in self._tables:
                raise KeyError(f"sequence {child!r} already allocated")
            table = self._tables[parent]
            if not 0 <= pages <= len(table):
                raise ValueError(
                    f"prefix fork of {pages} pages from {parent!r} "
                    f"({len(table)} pages)")
            if pages * self.page_size > self._lens[parent]:
                raise ValueError(
                    f"prefix fork of {pages} pages exceeds {parent!r}'s "
                    f"{self._lens[parent]}-token ledger (partial page)")
            shared = table[:pages]
            for phys in shared:
                self._refs[phys] += 1
            self._tables[child] = list(shared)
            self._lens[child] = pages * self.page_size

    def _newest(self, d: Data, phys: int, what: str) -> torch.Tensor:
        src = d.newest_copy()
        if src is None or src.value is None:
            raise RuntimeError(
                f"{self.name}: page {phys} has no live copy to {what} from "
                f"(spilled beyond the host tier?)")
        return src.value

    def update_page_host(self, seq: Any, page: int,
                         fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Host-side page rewrite under the recycle-detach discipline: the
        speculative seed-time staging path.  ``fn`` gets a private host
        copy of the NEWEST bytes (a device copy may be ahead of the host
        copy: it comes home by one D2H) and returns the page's new
        contents; every device copy is then detached and the host version
        jumps past the highest version any copy reached."""
        with self._lock:
            phys = self._tables[seq][page]
            d = self._pages[phys]
        val = fn(_home(self._newest(d, phys, "stage a host write")))
        self._rewrite_host(d, val)

    def rollback_tail(self, seq: Any, new_len: int) -> int:
        """Truncate ``seq``'s speculatively written tail back to
        ``new_len`` tokens, so a rejected draft's k/v never reaches the
        next pool.  Every slot in ``[new_len, seq_len)`` is zeroed and
        each touched page's fill reset to its kept slots; the boundary
        page's kept slots come from the newest copy, and each touched
        page is rewritten under the recycle-detach discipline.  Pages
        preallocated past the ledger stay in the table, zeroed.  A shared
        page in the range is refused (the ledger and the block table
        would disagree).  Returns the number of slots rolled back."""
        with self._lock:
            table = self._tables[seq]
            old_len = self._lens[seq]
            if not 0 <= new_len <= old_len:
                raise ValueError(
                    f"rollback of {seq!r} to {new_len} outside its "
                    f"[0, {old_len}] ledger")
            if new_len == old_len:
                return 0
            P = self.page_size
            pages = range(new_len // P,
                          min((old_len - 1) // P + 1, len(table)))
            for page in pages:
                phys = table[page]
                if self._refs[phys] > 1:
                    raise RuntimeError(
                        f"{self.name}: rollback range page {phys} of "
                        f"{seq!r} is shared ({self._refs[phys]} refs)")
            for page in pages:
                phys = table[page]
                d = self._pages[phys]
                keep = max(0, min(new_len - page * P, P))
                if keep == 0:
                    val = self._zeros()
                else:
                    val = _home(self._newest(d, phys, "roll back"))
                    val[K_CH, keep:] = 0.0
                    val[V_CH, keep:] = 0.0
                    val[META_CH, 0, 0, 0] = keep
                self._rewrite_host(d, val)
            self._lens[seq] = new_len
            self.tail_rollbacks += 1
            self.slots_rolled_back += old_len - new_len
            return old_len - new_len

    def has_seq(self, seq: Any) -> bool:
        with self._lock:
            return seq in self._tables

    def free_seq(self, seq: Any) -> int:
        """Release a sequence; pages drop to the free list when their
        last sharer leaves.  Returns the number of pages freed."""
        freed = 0
        with self._lock:
            for phys in self._tables.pop(seq, ()):
                self._refs[phys] -= 1
                if self._refs[phys] == 0:
                    del self._refs[phys]
                    self._free.append(phys)
                    freed += 1
            self._lens.pop(seq, None)
        return freed

    # -- geometry / introspection ---------------------------------------
    @property
    def page_bytes(self) -> int:
        return self.default_dtt.nbytes

    def seq_len(self, seq: Any) -> int:
        with self._lock:
            return self._lens[seq]

    def npages(self, seq: Any) -> int:
        with self._lock:
            return len(self._tables[seq])

    def block_table(self, seq: Any) -> list[int]:
        with self._lock:
            return list(self._tables[seq])

    def live_seqs(self) -> list:
        with self._lock:
            return list(self._tables)

    def page_fill(self, seq: Any, page: int) -> int:
        """Valid slots of one logical page, from the length ledger."""
        with self._lock:
            n = self._lens[seq] - page * self.page_size
            return max(0, min(n, self.page_size))

    def stats(self) -> dict:
        with self._lock:
            in_use = sum(len(t) for t in self._tables.values())
            phys = len(self._refs)
            return {
                "seqs": len(self._tables),
                "tokens": sum(self._lens.values()),
                "logical_pages": in_use,
                "physical_pages": phys,
                "shared_pages": in_use - phys,
                "free_pages": len(self._free),
                "page_bytes": self.page_bytes,
                "bytes_in_use": phys * self.page_bytes,
                "pages_allocated": self.pages_allocated,
                "pages_recycled": self.pages_recycled,
                "cow_copies": self.cow_copies,
                "prefix_hits": self.prefix_hits,
                "prefix_pages_reused": self.prefix_pages_reused,
                "tail_rollbacks": self.tail_rollbacks,
                "slots_rolled_back": self.slots_rolled_back,
                "host_tier_bytes": (self.tier.host_tier_bytes
                                    if self.tier is not None else 0),
                "prefetch_inflight": (self.tier.prefetch_inflight
                                      if self.tier is not None else 0),
            }
