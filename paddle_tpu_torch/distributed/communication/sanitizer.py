"""Runtime collective sanitizer (``FLAGS_collective_sanitizer``); the
stdlib part is a copy of
``paddle_tpu/distributed/communication/sanitizer.py``.

The failure mode this exists for: two ranks disagree about the next
collective — different op, shape, dtype or reduce op — and the job does
not crash, it **hangs**: every rank sits in its own NCCL call waiting
for peers that are in a different one, until the watchdog kills the job
minutes later with no diagnostic.

Mechanism: when the flag is on, every collective entry point in
``collective_ops`` records an order/shape/dtype/reduce-op
:class:`Fingerprint` and the sanitizer cross-checks each row of the
per-rank streams as soon as every rank has recorded it, **before** the
collective launches.  On disagreement it emits a ``collective_mismatch``
event and raises :class:`CollectiveMismatchError` carrying both ranks'
streams.

The JAX package has one controller that fans a call out into every
rank's fingerprint (:meth:`CollectiveSanitizer.observe`).  The port runs
one process per rank, so :meth:`CollectiveSanitizer.exchange` publishes
this rank's fingerprint to the group's store under ``(group, sequence
number, rank)``, waits (bounded by :data:`EXCHANGE_TIMEOUT_S`) for its
peers' and checks the row.  Every rank sees the same row, so every rank
raises together; a peer that never publishes raises ``TimeoutError``.

Chaos integration: ``FLAGS_fault_schedule`` entries like
``collective@2=truncate`` / ``collective@2=corrupt`` queue payload damage
in ``resilience.faults``; the sanitizer consumes it and applies it to the
last rank's fingerprint (truncate halves the leading dim, corrupt flips
the dtype), so an injected torn collective payload surfaces as a raised
mismatch, not a hang.  Every rank consumes its queued damage (they run
one schedule); only the last rank of the group applies it.
"""
from __future__ import annotations

import json
import threading
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["Fingerprint", "CollectiveMismatchError", "CollectiveSanitizer",
           "get_sanitizer", "reset_sanitizer", "observe_collective",
           "EXCHANGE_TIMEOUT_S"]

# how long a rank waits for a peer's fingerprint of the same call
EXCHANGE_TIMEOUT_S = 60.0


@dataclass(frozen=True)
class Fingerprint:
    """One rank's view of one collective call, in program order."""
    seq: int                       # 0-based call index within the group
    op: str                        # all_reduce / broadcast / ...
    shape: Tuple[int, ...]
    dtype: str
    reduce_op: str                 # "" for ops without a reduction
    group: str
    nranks: int

    def render(self) -> str:
        red = f", reduce={self.reduce_op}" if self.reduce_op else ""
        return (f"#{self.seq} {self.op}(shape={list(self.shape)}, "
                f"dtype={self.dtype}{red}) @{self.group}/{self.nranks}")

    def agrees_with(self, other: "Fingerprint") -> bool:
        return (self.seq == other.seq and self.op == other.op
                and self.shape == other.shape
                and self.dtype == other.dtype
                and self.reduce_op == other.reduce_op)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, text) -> "Fingerprint":
        d = json.loads(text)
        d["shape"] = tuple(d["shape"])
        return cls(**d)


class CollectiveMismatchError(RuntimeError):
    """Two ranks disagree on a collective fingerprint — the diagnostic
    raised *instead of* the hang the disagreement would cause.  Carries
    both ranks' full streams for post-mortems."""

    def __init__(self, group: str, rank_a: int, rank_b: int,
                 stream_a: List[Fingerprint], stream_b: List[Fingerprint],
                 seq: int):
        self.group = group
        self.rank_a = rank_a
        self.rank_b = rank_b
        self.stream_a = list(stream_a)
        self.stream_b = list(stream_b)
        self.seq = seq
        a = "\n    ".join(fp.render() for fp in self.stream_a) or "(empty)"
        b = "\n    ".join(fp.render() for fp in self.stream_b) or "(empty)"
        super().__init__(
            f"collective mismatch in group {group!r} at call #{seq}: "
            f"rank {rank_a} and rank {rank_b} disagree — on hardware "
            "this hangs until the stage timeout.  "
            f"rank {rank_a} stream:\n    {a}\n"
            f"rank {rank_b} stream:\n    {b}")


class CollectiveSanitizer:
    """Per-process fingerprint recorder + cross-rank agreement check."""

    def __init__(self):
        self._lock = threading.RLock()
        # group name -> rank -> fingerprint stream (program order)
        self._streams: Dict[str, Dict[int, List[Fingerprint]]] = {}
        # group name -> next unchecked row index
        self._checked: Dict[str, int] = {}
        self._seq: Dict[str, int] = {}

    # -- recording -------------------------------------------------------
    def record(self, group: str, nranks: int, rank: int,
               fp: Fingerprint) -> None:
        """Record one rank's fingerprint; cross-check every row all
        ranks have reached.  Raises :class:`CollectiveMismatchError`
        on the first disagreement."""
        with self._lock:
            ranks = self._streams.setdefault(group, {})
            ranks.setdefault(rank, []).append(fp)
            row = self._checked.get(group, 0)
            while len(ranks) == nranks and \
                    all(len(s) > row for s in ranks.values()):
                base_rank = min(ranks)
                base = ranks[base_rank][row]
                for r in sorted(ranks):
                    if not ranks[r][row].agrees_with(base):
                        self._report(group, base_rank, r, row)
                row += 1
                self._checked[group] = row

    def _next_seq(self, group: str) -> int:
        with self._lock:
            seq = self._seq.get(group, 0)
            self._seq[group] = seq + 1
            return seq

    @staticmethod
    def _damaged(fp: Fingerprint, damage: Optional[str]) -> Fingerprint:
        shape, dtype = fp.shape, fp.dtype
        if damage == "truncate" and shape:
            shape = (max(shape[0] // 2, 0),) + tuple(shape[1:])
        elif damage == "corrupt":
            dtype = f"corrupt<{dtype}>"
        return Fingerprint(fp.seq, fp.op, tuple(shape), dtype, fp.reduce_op,
                           fp.group, fp.nranks)

    def observe(self, op: str, group: str, nranks: int,
                shape: Tuple[int, ...], dtype: str,
                reduce_op: str = "") -> None:
        """Single-process entry: fan one call out into per-rank
        fingerprints (each rank sees the same program, so their views
        agree unless injected damage made one diverge)."""
        damage = _take_damage()
        seq = self._next_seq(group)
        for rank in range(nranks):
            fp = Fingerprint(seq, op, tuple(shape), dtype, reduce_op, group,
                             nranks)
            if rank == nranks - 1:
                fp = self._damaged(fp, damage)
            self.record(group, nranks, rank, fp)

    def exchange(self, op: str, group: str, nranks: int, rank: int, store,
                 shape: Tuple[int, ...], dtype: str, reduce_op: str = "",
                 timeout: float = EXCHANGE_TIMEOUT_S) -> None:
        """Multi-process entry: publish this rank's fingerprint of the
        call to ``store``, wait for every peer's and cross-check the
        row."""
        damage = _take_damage()
        seq = self._next_seq(group)
        fp = Fingerprint(seq, op, tuple(shape), dtype, reduce_op, group,
                         nranks)
        if rank == nranks - 1:
            fp = self._damaged(fp, damage)
        prefix = f"collective_sanitizer/{_GENERATION[0]}/{group}/{seq}/"
        store.set(prefix + str(rank), fp.to_json())
        for r in range(nranks):
            key = prefix + str(r)
            try:
                got = fp if r == rank else Fingerprint.from_json(
                    store.get(key, timeout=timeout))
            except TimeoutError as e:
                raise TimeoutError(
                    f"collective sanitizer: rank {r} of group {group!r} did "
                    f"not reach call #{seq} ({fp.render()}) within "
                    f"{timeout} s") from e
            self.record(group, nranks, r, got)

    # -- mismatch --------------------------------------------------------
    def _report(self, group: str, rank_a: int, rank_b: int,
                row: int) -> None:
        ranks = self._streams[group]
        fp_a, fp_b = ranks[rank_a][row], ranks[rank_b][row]
        # telemetry BEFORE the raise: the watchdog and flight recorder
        # must see the would-be hang even if the raise is swallowed
        from ...observability import events
        events.emit("collective_mismatch", op=fp_a.op, group=group,
                    seq=row, rank_a=rank_a, rank_b=rank_b,
                    fingerprint_a=fp_a.render(),
                    fingerprint_b=fp_b.render(), nranks=fp_a.nranks)
        raise CollectiveMismatchError(
            group, rank_a, rank_b, ranks[rank_a], ranks[rank_b], row)

    def reset(self) -> None:
        with self._lock:
            self._streams.clear()
            self._checked.clear()
            self._seq.clear()


def _take_damage() -> Optional[str]:
    """Consume one queued collective@N truncate/corrupt chaos entry."""
    from ...resilience.faults import take_collective_damage
    return take_collective_damage()


# ---------------------------------------------------------------------------
# flag-gated singleton
# ---------------------------------------------------------------------------

_SANITIZER: Optional[CollectiveSanitizer] = None
# bumped by every reset, so the store keys of a reset sanitizer's calls
# never meet those before it (every rank resets at the same points)
_GENERATION = [0]


def get_sanitizer() -> Optional[CollectiveSanitizer]:
    """The process sanitizer iff ``FLAGS_collective_sanitizer`` is on
    (read on every call, so it can be toggled mid-run)."""
    global _SANITIZER
    from ...flags import get_flag
    if not get_flag("collective_sanitizer"):
        return None
    if _SANITIZER is None:
        _SANITIZER = CollectiveSanitizer()
    return _SANITIZER


def reset_sanitizer() -> None:
    """Drop all recorded streams (tests, and between chaos runs)."""
    global _SANITIZER
    _SANITIZER = None
    _GENERATION[0] += 1


# ReduceOp constants (group.py) -> stream-readable names
_REDUCE_NAMES = {0: "SUM", 1: "MAX", 2: "MIN", 3: "PROD", 4: "AVG"}


def observe_collective(op: str, group, tensor=None,
                       reduce_op=None) -> None:
    """The hook ``collective_ops`` entry points call (after group
    resolution): a no-op unless the flag is on.  A group of this
    process's runtime exchanges through its store; anything else (a
    stand-in group with no process group) fans out in process."""
    san = get_sanitizer()
    if san is None:
        return
    shape: Tuple[int, ...] = ()
    dtype = ""
    if tensor is not None:
        shape = tuple(int(d) for d in tensor.shape)
        dtype = str(tensor.dtype).replace("torch.", "")
    red = "" if reduce_op is None \
        else _REDUCE_NAMES.get(reduce_op, str(reduce_op))
    from ..env import runtime
    rt = runtime()
    if rt is not None and getattr(group, "process_group", None) is not None:
        san.exchange(op, group.key, group.nranks, group.rank, rt.store,
                     shape, dtype, red)
    else:
        san.observe(op, str(getattr(group, "name", None) or "default"),
                    int(getattr(group, "nranks", 1) or 1), shape, dtype, red)
