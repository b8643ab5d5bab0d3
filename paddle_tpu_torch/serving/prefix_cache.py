"""Prefix cache — content-addressed sharing of immutable prompt-prefix
KV pages across requests (a copy of ``paddle_tpu/serving/
prefix_cache.py``; stdlib only).

Serving traffic repeats prompt prefixes constantly (system prompts,
few-shot preambles, retry storms).  Once a request's prompt KV is
resident in pages, any later request whose prompt starts with the same
tokens can ATTEND to those pages instead of recomputing them — prefill
FLOPs drop to the unshared tail.

Correctness constraints baked in:

* only FULL pages are shared (a partially-filled page is still being
  appended to by its owner);
* only position-0-anchored prefixes are shared — KV depends on
  absolute position, and a chained key (each page's key folds in the
  previous page's key) makes "same tokens at the same positions" the
  identity;
* a hash hit is never trusted by itself: the entry stores the page's
  exact token tuple and its predecessor key, and both must match —
  a colliding hash can only cost a miss, never a wrong share
  (``hash_fn`` is injectable so tests can prove it);
* ownership is refcounted through :class:`~.scheduler.PagePool`: the
  cache holds one reference per entry, every using sequence holds its
  own, and ``reclaim()`` frees LRU cache-only pages (refcount 1) under
  pool pressure.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "chained_page_keys"]


def _default_hash(prev_key: str, tokens: Tuple[int, ...]) -> str:
    h = hashlib.sha256()
    h.update(prev_key.encode())
    h.update(",".join(str(t) for t in tokens).encode())
    return h.hexdigest()


def chained_page_keys(prompt: Sequence[int], page_size: int,
                      hash_fn: Optional[Callable] = None):
    """Yield ``(key, page_tokens)`` for each FULL page of ``prompt``
    with the chained content hash (each page's key folds in the
    previous page's).  This IS the cache identity."""
    hash_fn = hash_fn or _default_hash
    ps = int(page_size)
    key = ""
    for i in range(len(prompt) // ps):
        chunk = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
        key = hash_fn(key, chunk)
        yield key, chunk


class _Entry:
    __slots__ = ("prev_key", "tokens", "page", "lru", "hits")

    def __init__(self, prev_key: str, tokens: Tuple[int, ...],
                 page: int, lru: int):
        self.prev_key = prev_key
        self.tokens = tokens
        self.page = page
        self.lru = lru
        self.hits = 0


class PrefixCache:
    """Maps chained page-content keys to resident page ids."""

    def __init__(self, pool, hash_fn: Optional[Callable] = None):
        self.pool = pool
        self.page_size = pool.page_size
        self._hash = hash_fn or _default_hash
        self._entries: Dict[str, _Entry] = {}
        self._clock = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.collisions = 0
        self.reclaimed = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _keys_for(self, prompt: Sequence[int]):
        """Yield (key, page_tokens) for each FULL page of the prompt."""
        return chained_page_keys(prompt, self.page_size, self._hash)

    # -- lookup ----------------------------------------------------------
    def match(self, prompt: Sequence[int]) -> List[int]:
        """Page ids of the longest cached full-page prefix of
        ``prompt`` (possibly empty).  Does NOT take references — the
        scheduler refs exactly the pages it decides to use."""
        pages: List[int] = []
        prev = ""
        for key, chunk in self._keys_for(prompt):
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                break
            if entry.prev_key != prev or entry.tokens != chunk:
                # hash collision: same key, different content — never
                # share, count it (the collision-safety contract)
                self.collisions += 1
                self.misses += 1
                break
            entry.lru = next(self._clock)
            entry.hits += 1
            self.hits += 1
            pages.append(entry.page)
            prev = key
        return pages

    # -- insertion -------------------------------------------------------
    def insert(self, prompt: Sequence[int], pages: Sequence[int],
               shared: Optional[set] = None) -> int:
        """Register every full prompt page not yet cached.  ``pages``
        is the owning sequence's page list; pages the sequence itself
        obtained FROM the cache (``shared``) are already entries and
        are skipped.  The cache takes one pool reference per new
        entry; returns how many entries were added."""
        shared = shared or set()
        added = 0
        prev = ""
        for i, (key, chunk) in enumerate(self._keys_for(prompt)):
            page = pages[i]
            if key not in self._entries and page not in shared:
                self.pool.ref(page)
                self._entries[key] = _Entry(prev, chunk, page,
                                            next(self._clock))
                added += 1
            prev = key
        return added

    # -- pressure --------------------------------------------------------
    def reclaim(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` least-recently-used entries whose
        page only the cache still holds (pool refcount 1) — returning
        them to the free list.  Entries some sequence is actively
        attending to are untouchable."""
        freed = 0
        for key, entry in sorted(self._entries.items(),
                                 key=lambda kv: kv[1].lru):
            if freed >= n_pages:
                break
            if self.pool.refcount(entry.page) != 1:
                continue
            del self._entries[key]
            self.pool.unref(entry.page)
            freed += 1
            self.reclaimed += 1
        return freed

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "collisions": self.collisions,
                "reclaimed": self.reclaimed}
