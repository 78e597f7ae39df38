"""The automatic prefix cache: a radix tree over prompt-token runs.

Port of ``parsec_tpu/llm/prefix_tree.py``.  ``PagedKVCollection.fork``
shares prompt pages copy-on-write only when a caller names the stream to
fork; the :class:`PrefixTree` makes the sharing automatic, for traffic
where many requests carry the same system prompt.

- **Page-granular radix tree.**  Every edge is one page of tokens (a
  ``page_size``-tuple); a node at depth ``d`` names a ``d``-page token
  prefix, so a hit only ever covers FULL pages and the tail (a partial
  page included) prefills normally.
- **Donation.**  When a stream retires cleanly, the batcher donates its
  prompt pages: the trie forks the full pages its cacheable run covers
  into a retained sequence (:meth:`PagedKVCollection.fork_prefix`, no
  bytes move) before ``free_seq`` drops the stream's own references.  A
  later adopter forks from the retained sequence the same way; eviction
  is ``free_seq`` of the retained id.
- **LRU under a byte budget** (``llm_prefix_budget_bytes``): entries
  weigh ``pages * page_bytes`` (sharing between entries is not
  discounted), and :meth:`PrefixTree.donate` evicts the coldest past it.
- **Pinning.**  :meth:`PrefixTree.adopt` matches and forks under the tree
  lock, so an entry cannot be evicted between the two; after the fork the
  child's refcounts keep the shared pages alive.

One RLock; the lock order is tree -> collection, and the runtimelint
contract tables (``_LOCK_PROTECTED``, ``_LOCK_ORDER``) check it.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Any, Sequence

from ..core.params import params as _params
from ..data_dist.paged_kv import PagedKVCollection

# the runtime lint's contract (analysis/runtimelint.py)
_LOCK_PROTECTED = {
    "_Node.children": "_lock",
    "_Node.entries": "_lock",
    "PrefixTree._lru": "_lock",
    "PrefixTree._clock": "_lock",
    "PrefixTree._bytes": "_lock",
    "PrefixTree.hits": "_lock",
    "PrefixTree.misses": "_lock",
    "PrefixTree.donations": "_lock",
    "PrefixTree.evictions": "_lock",
}
_LOCK_ORDER = ("_lock",)

_params.register("llm_prefix_cache", False,
                 "automatic prefix cache: match every incoming prompt "
                 "against a radix tree of retained prompt pages and fork "
                 "the longest full-page prefix copy-on-write instead of "
                 "re-prefilling it")
_params.register("llm_prefix_budget_bytes", 64 << 20,
                 "byte budget for retained prefix pages (pages * "
                 "page_bytes per entry); the coldest entries evict past "
                 "it and their pages recycle unless still shared")

_entry_ids = itertools.count()


class _Entry:
    """One retained prefix: a synthetic sequence in the KV collection
    whose first ``pages`` pages hold k/v of exactly ``tokens``."""

    __slots__ = ("seq", "tokens", "pages", "nbytes", "path", "touch")

    def __init__(self, seq: Any, tokens: tuple, pages: int,
                 nbytes: int) -> None:
        self.seq = seq
        self.tokens = tokens
        self.pages = pages
        self.nbytes = nbytes
        self.path: list[_Node] = []      # nodes depth 1..pages
        self.touch = 0                   # LRU clock stamp (tree._clock)

    def __repr__(self) -> str:
        return f"<prefix {self.seq} pages={self.pages}>"


class _Node:
    __slots__ = ("children", "entries")

    def __init__(self) -> None:
        self.children: dict[tuple, _Node] = {}
        self.entries: list[_Entry] = []


class PrefixTree:
    """Radix tree of retained prompt-page runs over one
    :class:`PagedKVCollection` (see module docstring)."""

    def __init__(self, kv: PagedKVCollection,
                 budget_bytes: int | None = None) -> None:
        self.kv = kv
        self.budget_bytes = (_params.get("llm_prefix_budget_bytes")
                             if budget_bytes is None else int(budget_bytes))
        self._lock = threading.RLock()
        self._root = _Node()
        # LRU over retained entries: cold end first.  Touched on donate
        # and on every adoption hit.
        self._lru: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._clock = 0          # monotonic touch stamps (O(1) _pick)
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.donations = 0
        self.evictions = 0

    # -- matching ---------------------------------------------------------
    def _runs(self, tokens: Sequence[int]):
        P = self.kv.page_size
        for d in range(len(tokens) // P):
            yield tuple(int(t) for t in tokens[d * P:(d + 1) * P])

    def _descend(self, tokens: Sequence[int]) -> tuple["_Node", int]:
        """Deepest node reachable along ``tokens``' page runs (depth in
        pages).  Callers hold the lock."""
        node, depth = self._root, 0
        for run in self._runs(tokens):
            child = node.children.get(run)
            if child is None:
                break
            node, depth = child, depth + 1
        return node, depth

    def match(self, tokens: Sequence[int]) -> tuple[Any, int]:
        """Longest retained full-page prefix of ``tokens``: returns
        ``(retained seq, pages)`` or ``(None, 0)``.  Pure lookup — use
        :meth:`adopt` to actually fork (match + fork are atomic there)."""
        with self._lock:
            node, depth = self._descend(tokens)
            while depth > 0 and not node.entries:
                # an interior node whose entries all evicted: back up
                node, depth = self._descend(tokens[:(depth - 1)
                                                   * self.kv.page_size])
            if depth == 0 or not node.entries:
                return None, 0
            return self._pick(node).seq, depth

    def _pick(self, node: "_Node") -> _Entry:
        """Of the entries passing through a node, fork from the most
        recently used (highest touch stamp) — matches the LRU's idea of
        who stays warm, in O(entries at this node)."""
        return max(node.entries, key=lambda e: e.touch)

    def _touch_locked(self, entry: _Entry) -> None:  # lint: holds(_lock)
        self._clock += 1
        entry.touch = self._clock
        if entry.seq in self._lru:
            self._lru.move_to_end(entry.seq)

    # -- adoption (match + CoW fork, atomic) ------------------------------
    def adopt(self, child_seq: Any, tokens: Sequence[int]) -> int:
        """Materialize ``child_seq`` in the collection, sharing the
        longest retained full-page prefix of ``tokens`` copy-on-write.
        Returns the number of pages reused (0 = miss; the child is then
        a plain empty sequence).  ``tokens`` are the CACHEABLE tokens —
        the batcher passes ``prompt[:-1]``, the run prefill would cache.

        Match and fork happen under the tree lock: a matched entry
        cannot be evicted before its pages are shared (the
        eviction-aware pin), and after the fork the child's own
        refcounts keep the shared pages alive whatever the LRU does."""
        with self._lock:
            node, depth = self._descend(tokens)
            while depth > 0 and not node.entries:
                node, depth = self._descend(tokens[:(depth - 1)
                                                   * self.kv.page_size])
            if depth == 0 or not node.entries:
                self.misses += 1
                self.kv.alloc_seq(child_seq)
                return 0
            e = self._pick(node)
            self.kv.fork_prefix(e.seq, child_seq, depth)
            self._touch_locked(e)
            self.hits += 1
            self.kv.prefix_hits += 1
            self.kv.prefix_pages_reused += depth
            return depth

    # -- donation ---------------------------------------------------------
    def donate(self, seq: Any, prompt: Sequence[int]) -> Any | None:
        """Retain ``seq``'s prompt pages before it is freed: the pages
        fully covered by ``prompt[:-1]`` (the cacheable run — decode
        never wrote them) fork into a synthetic retained sequence.
        Idempotent per path: if a live entry already covers this exact
        prefix at full depth, it is touched instead of duplicated.
        Returns the retained seq id, or None when nothing was retained
        (short prompt, duplicate path, or a zero budget)."""
        P = self.kv.page_size
        cacheable = len(prompt) - 1
        pages = cacheable // P
        if pages <= 0 or self.budget_bytes <= 0:
            return None
        tokens = tuple(int(t) for t in prompt[:pages * P])
        nbytes = pages * self.kv.page_bytes
        with self._lock:
            node, depth = self._descend(tokens)
            if depth == pages and any(e.pages >= pages
                                      for e in node.entries):
                # this exact prefix is already retained: refresh it
                for e in node.entries:
                    if e.pages >= pages and e.seq in self._lru:
                        self._touch_locked(e)
                        break
                return None
            retained = ("~prefix", next(_entry_ids))
            self.kv.fork_prefix(seq, retained, pages)
            entry = _Entry(retained, tokens, pages, nbytes)
            node = self._root
            for run in self._runs(tokens):
                node = node.children.setdefault(run, _Node())
                node.entries.append(entry)
                entry.path.append(node)
            self._lru[retained] = entry
            self._touch_locked(entry)
            self._bytes += nbytes
            self.donations += 1
            self._evict_over_budget_locked()
            return retained

    # -- eviction ---------------------------------------------------------
    def _evict_over_budget_locked(self) -> None:  # lint: holds(_lock)
        while self._bytes > self.budget_bytes and len(self._lru) > 1:
            self._evict_one_locked()

    def _evict_one_locked(self) -> bool:  # lint: holds(_lock)
        if not self._lru:
            return False
        seq, entry = self._lru.popitem(last=False)   # coldest first
        self._bytes -= entry.nbytes
        for node in entry.path:
            try:
                node.entries.remove(entry)
            except ValueError:
                pass
        # prune now-empty leaves bottom-up so the tree stays O(live)
        for d in range(len(entry.path), 0, -1):
            node = entry.path[d - 1]
            if node.entries or node.children:
                break
            parent = entry.path[d - 2] if d > 1 else self._root
            run = tuple(entry.tokens[(d - 1) * self.kv.page_size:
                                     d * self.kv.page_size])
            parent.children.pop(run, None)
        self.kv.free_seq(seq)
        self.evictions += 1
        return True

    def evict(self, n: int = 1) -> int:
        """Force-evict up to ``n`` cold entries (tests / pressure)."""
        done = 0
        with self._lock:
            for _ in range(n):
                if not self._evict_one_locked():
                    break
                done += 1
        return done

    def clear(self) -> None:
        with self._lock:
            while self._evict_one_locked():
                pass

    # -- introspection ----------------------------------------------------
    def live_entries(self) -> dict:
        """``{retained seq: (tokens, pages)}`` — the oracle surface the
        property tests compare against a brute-force LCP scan."""
        with self._lock:
            return {seq: (e.tokens, e.pages)
                    for seq, e in self._lru.items()}

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._lru),
                "retained_pages": sum(e.pages for e in self._lru.values()),
                "retained_bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "donations": self.donations,
                "evictions": self.evictions,
            }
