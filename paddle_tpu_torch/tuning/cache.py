"""Persistent on-disk tuning cache (JSON-lines, atomic rename); a copy
of ``paddle_tpu/tuning/cache.py``.

One ``TuningCache`` manages a directory (``FLAGS_tuning_cache_dir``)
holding one ``<kind>.jsonl`` file per entry kind; every line is an
independent record

    {"v": SCHEMA_VERSION, "t": <unix time>, "key": {...}, "value": {...}}

keyed by the canonical JSON of ``key``.  Failure model:

* **atomicity** — writes go to a unique temp file in the same
  directory, then ``os.replace`` (atomic on POSIX): readers never see a
  half-written file.  Concurrent writers race at whole-file granularity
  (last rename wins) but each writer merges the disk state it last read
  with every entry it has produced itself, so a surviving file is
  always internally consistent.
* **corruption** — unparsable lines (truncation, bit rot) and records
  with a mismatched schema version are counted and skipped; the cache
  degrades to a miss, never an exception.  The next ``store`` rewrites
  the file clean.
* **observability** — per-kind hit/miss/store/drop counters
  (``stats()``), mirrored into the process metrics registry
  (``paddle_tuning_cache_events_total{kind,event}``) and, when
  ``FLAGS_observability_dir`` is set, emitted as ``tuning_cache``
  event-log records.

The same directory holds the learned performance model
(``perf_model.json``, ``tuning.learned``) that ``python -m
paddle_tpu_torch.tuning fit --from-events`` trains from the cache and
the event logs, and the default output of ``merge``.  The reference's
flag also wires JAX's persistent compilation cache under the
directory; the port compiles no XLA programs (its kernels are cached in
``paddle_tpu_torch/_build/`` by source hash), so that wiring is not
copied.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

SCHEMA_VERSION = 1

_KIND_OK = set("abcdefghijklmnopqrstuvwxyz0123456789_")


def _obs():
    """(counter_family, events_module) of the observability mirror."""
    from ..observability import events, metrics
    fam = metrics.counter(
        "paddle_tuning_cache_events_total",
        "tuning-cache traffic by kind (hits/misses/stores/"
        "corrupt_lines/version_skew)",
        labels=("kind", "event"))
    return fam, events


def canonical_key(key: Dict[str, Any]) -> str:
    """Order-independent stable identity for a key dict."""
    return json.dumps(key, sort_keys=True, separators=(",", ":"))


def _check_kind(kind: str) -> str:
    if not kind or set(kind) - _KIND_OK:
        raise ValueError(f"invalid cache kind {kind!r} "
                         "(lowercase [a-z0-9_] only)")
    return kind


class TuningCache:
    """Read-through/write-through JSONL store for one directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        # entries this process has loaded or produced, per kind — the
        # merge base that makes concurrent whole-file rewrites safe
        self._mem: Dict[str, Dict[str, dict]] = {}
        self._mtime: Dict[str, float] = {}
        self._stats: Dict[str, Dict[str, int]] = {}

    # -- internals --------------------------------------------------------
    def _path(self, kind: str) -> str:
        return os.path.join(self.directory, f"{_check_kind(kind)}.jsonl")

    def _kind_stats(self, kind: str) -> Dict[str, int]:
        return self._stats.setdefault(kind, {
            "hits": 0, "misses": 0, "stores": 0,
            "corrupt_lines": 0, "version_skew": 0})

    def _bump(self, kind: str, event: str) -> None:
        """Count into the instance dict AND the shared observability
        surfaces (metrics registry + event log)."""
        self._kind_stats(kind)[event] += 1
        fam, events = _obs()
        fam.labels(kind=kind, event=event).inc()
        events.emit("tuning_cache", cache_kind=kind, event=event)

    def _load(self, kind: str) -> Dict[str, dict]:
        """Merge the on-disk file into the in-memory index (newest ``t``
        wins) when its mtime moved; tolerate any corruption."""
        mem = self._mem.setdefault(kind, {})
        path = self._path(kind)
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return mem
        if self._mtime.get(kind) == mtime:
            return mem
        try:
            # errors="replace": binary corruption becomes unparsable
            # text and is counted line-by-line below, never raised
            with open(path, "r", encoding="utf-8",
                      errors="replace") as fh:
                lines = fh.readlines()
        except OSError:
            return mem
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if rec.get("v") != SCHEMA_VERSION:
                    self._bump(kind, "version_skew")
                    continue
                k = canonical_key(rec["key"])
                rec["value"]  # noqa: B018 — KeyError => corrupt record
            except Exception:
                self._bump(kind, "corrupt_lines")
                continue
            have = mem.get(k)
            if have is None or rec.get("t", 0) >= have.get("t", 0):
                mem[k] = rec
        self._mtime[kind] = mtime
        return mem

    def _flush(self, kind: str) -> None:
        """Atomic whole-file rewrite of the merged index; transient
        OSErrors (NFS/GCS-fuse hiccups — the shared-storage deployments
        the cache targets) are retried with deterministic backoff via
        the shared resilience helper."""
        from ..resilience.retry import with_retries
        mem = self._load(kind)       # merge latest disk state first
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(kind)

        def _write():
            tmp = f"{path}.{os.getpid()}.{os.urandom(4).hex()}.tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as fh:
                    for rec in mem.values():
                        fh.write(json.dumps(rec, sort_keys=True) + "\n")
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

        with_retries(_write, attempts=3, retry_on=(OSError,),
                     label=f"tuning_cache:{kind}")
        try:
            self._mtime[kind] = os.stat(path).st_mtime
        except OSError:
            pass

    # -- public API -------------------------------------------------------
    def lookup(self, kind: str, key: Dict[str, Any]) -> Optional[dict]:
        """The stored value dict, or None (counted as hit/miss)."""
        rec = self._load(kind).get(canonical_key(key))
        if rec is None:
            self._bump(kind, "misses")
            return None
        self._bump(kind, "hits")
        return rec["value"]

    def store(self, kind: str, key: Dict[str, Any],
              value: Dict[str, Any]) -> None:
        rec = {"v": SCHEMA_VERSION,
               "t": time.time(),  # noqa: PTL501 — record timestamp
               # (newest-wins merge key), not a reported timing
               "key": dict(key), "value": dict(value)}
        self._mem.setdefault(kind, {})[canonical_key(key)] = rec
        self._bump(kind, "stores")
        self._flush(kind)

    def entries(self, kind: Optional[str] = None) -> Iterator[dict]:
        """All records (full ``{"v","t","key","value"}`` dicts)."""
        kinds = [kind] if kind else self.kinds()
        for k in kinds:
            yield from self._load(k).values()

    def kinds(self) -> List[str]:
        found = set(self._mem)
        try:
            found |= {f[:-6] for f in os.listdir(self.directory)
                      if f.endswith(".jsonl")}
        except OSError:
            pass
        return sorted(found)

    def prune(self, kind: Optional[str] = None,
              max_age_s: Optional[float] = None) -> int:
        """Drop entries (all of them, or those older than ``max_age_s``).
        Returns the number removed."""
        removed = 0
        now = time.time()  # noqa: PTL501 — age cutoff vs stored record
        # timestamps, not a reported timing
        for k in ([kind] if kind else self.kinds()):
            mem = self._load(k)
            if max_age_s is None:
                removed += len(mem)
                mem.clear()
            else:
                stale = [ck for ck, rec in mem.items()
                         if now - rec.get("t", 0) > max_age_s]
                for ck in stale:
                    del mem[ck]
                removed += len(stale)
            path = self._path(k)
            if mem:
                self._flush(k)
            elif os.path.exists(path):
                os.unlink(path)
                self._mtime.pop(k, None)
        return removed

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-kind counters (a copy; mutate-safe)."""
        return {k: dict(v) for k, v in self._stats.items()}

    def reset_stats(self) -> None:
        self._stats.clear()


# ---------------------------------------------------------------------------
# flag-bound singleton
# ---------------------------------------------------------------------------

_active: Optional[TuningCache] = None


def get_cache() -> Optional[TuningCache]:
    """The process cache for FLAGS_tuning_cache_dir, or None when the
    flag is empty.  A flag change swaps the instance (fresh counters)."""
    global _active
    from ..flags import get_flag
    directory = get_flag("tuning_cache_dir")
    if not directory:
        _active = None
        return None
    directory = os.path.abspath(directory)
    if _active is None or _active.directory != directory:
        _active = TuningCache(directory)
    return _active
