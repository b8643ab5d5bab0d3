"""Process-wide metrics registry (counters, gauges, histograms); a copy
of ``paddle_tpu/observability/metrics.py`` (stdlib only).

ref role: the reference scatters operational counters across subsystems
(executor stats, allocator stats, profiler accumulators) with no uniform
read surface; production TPU serving (and the MPK/learned-cost-model
work in PAPERS.md) needs ONE registry every layer writes to and every
operator — CLI, ``/metrics`` endpoint, bench — reads from.

Design (prometheus client model, stdlib-only):

* a **family** is registered once per (name, kind): ``counter(name)``,
  ``gauge(name)``, ``histogram(name, buckets=...)``.  Re-registering
  with the same kind returns the same family; a kind/label/bucket
  conflict raises (two subsystems silently sharing a mistyped metric is
  how numbers go wrong).
* each family has labelled **children**: ``family.labels(server="3")``.
  A child holds the actual value(s) and a lock — increments are atomic
  under thread hammering (the serving-handler race this registry
  exists to kill).
* **histograms** use fixed cumulative buckets (prometheus ``le``
  semantics) plus sum/count, so percentile estimates and the text
  exposition both fall out of one structure.  :class:`HistogramValue`
  is the bare accumulator, reused by ``profiler/timer.py`` instead of
  its own ad-hoc ``_Stat`` sums.
* exporters: :meth:`MetricsRegistry.snapshot` (JSON-able dict) and
  :meth:`MetricsRegistry.prometheus_text` (text exposition format v0,
  what ``GET /metrics`` serves).
* **near-zero cost when disabled**: :func:`set_enabled` (False) turns
  every ``inc``/``set``/``observe`` into one attribute check + return.
  Default is enabled — a locked float add is cheap and the serving
  counters are load-bearing for ``/health``.

Stdlib-only on purpose: the serving engine, the HTTP server and the
lock sanitizer all import it.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "HistogramValue", "default_registry",
    "counter", "gauge", "histogram", "set_enabled", "enabled",
    "DEFAULT_BUCKETS", "TIME_BUCKETS",
]

# prometheus client defaults — general-purpose magnitudes
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)
# latency-shaped: sub-millisecond dispatch up to multi-minute compiles
TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_enabled = True


def set_enabled(on: bool) -> None:
    """Global kill switch: metric writes become no-ops when off."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class HistogramValue:
    """Bare fixed-bucket histogram accumulator (no labels, no registry).

    Cumulative-``le`` bucket counts + sum + count; thread-safe.  This is
    the shared implementation behind registered histogram children AND
    ``profiler.timer``'s streaming stats.
    """

    __slots__ = ("buckets", "bucket_counts", "sum", "count", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs                      # finite upper bounds
        self.bucket_counts = [0] * (len(bs) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        v = float(value)
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.bucket_counts[i] += 1
            self.sum += v
            self.count += 1

    @property
    def avg(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 <= q <= 1)."""
        with self._lock:
            counts = list(self.bucket_counts)
            total = self.count
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= target:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                if c == 0:
                    return hi
                frac = (target - prev) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            lo = self.buckets[i] if i < len(self.buckets) else lo
        return self.buckets[-1]

    def summary(self) -> Dict[str, float]:
        """Compact stats for reports/bench JSON."""
        return {"count": self.count, "sum": round(self.sum, 6),  # noqa: PTL902 — report-time snapshot: one stale observation is acceptable in bench JSON

                "avg": round(self.avg, 6),
                "p50": round(self.quantile(0.5), 6),
                "p90": round(self.quantile(0.9), 6),
                "p99": round(self.quantile(0.99), 6)}

    def merge_counts(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs, +Inf last — exposition order."""
        out = []
        cum = 0
        with self._lock:
            for b, c in zip(self.buckets, self.bucket_counts):
                cum += c
                out.append((b, cum))
            out.append((math.inf, cum + self.bucket_counts[-1]))
        return out


class _Child:
    """One labelled series of a family."""

    __slots__ = ("kind", "_lock", "_value", "_hist")

    def __init__(self, kind: str, buckets: Optional[Sequence[float]]):
        self.kind = kind
        self._lock = threading.Lock()
        self._value = 0.0
        self._hist = HistogramValue(buckets) if kind == "histogram" \
            else None

    # counters + gauges -------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if self.kind == "counter" and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self.kind != "gauge":
            raise TypeError(f"dec() on a {self.kind}")
        self.inc(-amount)

    def set(self, value: float) -> None:
        if self.kind != "gauge":
            raise TypeError(f"set() on a {self.kind}")
        if not _enabled:
            return
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        if self._hist is not None:
            return self._hist.sum
        with self._lock:
            return self._value

    # histograms --------------------------------------------------------
    def observe(self, value: float) -> None:
        if self._hist is None:
            raise TypeError(f"observe() on a {self.kind}")
        self._hist.observe(value)

    def time(self) -> "_HistTimer":
        """``with child.time(): ...`` — observe the block's wall seconds.
        The sanctioned way to report a timing (PTL501) without touching
        ``time.perf_counter`` at the call site."""
        if self._hist is None:
            raise TypeError(f"time() on a {self.kind}")
        return _HistTimer(self._hist)

    @property
    def hist(self) -> Optional[HistogramValue]:
        return self._hist


class _HistTimer:
    __slots__ = ("_hist", "_t0", "seconds")

    def __init__(self, hist: HistogramValue):
        self._hist = hist
        self._t0 = None
        self.seconds = 0.0

    def __enter__(self):
        import time
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        self.seconds = time.perf_counter() - self._t0
        self._hist.observe(self.seconds)
        return False


class _Family:
    """All series of one metric name."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Sequence[float]]):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self.buckets = tuple(buckets) if buckets else None
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: Any) -> _Child:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"metric {self.name!r} takes labels "
                f"{sorted(self.label_names)}, got {sorted(labels)}")
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self.kind, self.buckets)
                self._children[key] = child
            return child

    def child(self) -> _Child:
        """The unlabelled series (only for label-less families)."""
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labelled; use .labels()")
        return self.labels()

    # convenience passthroughs on label-less families
    def inc(self, amount: float = 1.0) -> None:
        self.child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.child().dec(amount)

    def set(self, value: float) -> None:
        self.child().set(value)

    def observe(self, value: float) -> None:
        self.child().observe(value)

    def time(self) -> _HistTimer:
        return self.child().time()

    @property
    def value(self) -> float:
        return self.child().value

    def series(self) -> List[Tuple[Dict[str, str], _Child]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.label_names, key)), child)
                for key, child in items]


_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or set(name) - _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


class MetricsRegistry:
    """A set of metric families with a uniform export surface."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: str, help: str,
                  labels: Sequence[str],
                  buckets: Optional[Sequence[float]]) -> _Family:
        _check_name(name)
        label_names = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != label_names or \
                        (kind == "histogram" and buckets is not None
                         and fam.buckets != tuple(buckets)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels "
                        f"{list(fam.label_names)}")
                return fam
            fam = _Family(name, kind, help, label_names, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register(name, "counter", help, labels, None)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._register(name, "gauge", help, labels, None)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._register(name, "histogram", help, labels, buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    # -- exporters --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump of every series (the CLI ``snapshot`` body)."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            rows = []
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    h = child.hist
                    rows.append({"labels": labels, "count": h.count,
                                 "sum": round(h.sum, 9),
                                 "buckets": {str(b): c for b, c in
                                             zip(h.buckets,
                                                 h.bucket_counts)},
                                 "inf": h.bucket_counts[-1]})
                else:
                    rows.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": rows}
        return out

    def prometheus_text(self) -> str:
        """Text exposition format (``GET /metrics`` body)."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} "
                             + fam.help.replace("\\", "\\\\")
                             .replace("\n", "\\n"))
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            series = fam.series() or (
                [] if fam.label_names else [({}, fam.child())])
            for labels, child in series:
                lab = _fmt_labels(labels)
                if fam.kind == "histogram":
                    h = child.hist
                    for le, cum in h.merge_counts():
                        le_s = "+Inf" if math.isinf(le) else _fmt_num(le)
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(dict(labels, le=le_s))} {cum}")
                    lines.append(f"{fam.name}_sum{lab} "
                                 f"{_fmt_num(h.sum)}")
                    lines.append(f"{fam.name}_count{lab} {h.count}")
                else:
                    lines.append(f"{fam.name}{lab} "
                                 f"{_fmt_num(child.value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every family (tests only — live handles go stale)."""
        with self._lock:
            self._families.clear()


def _fmt_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{k}="' + str(v).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n") + '"'
        for k, v in sorted(labels.items()))
    return "{" + body + "}"


# ---------------------------------------------------------------------------
# process default registry
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def counter(name: str, help: str = "",
            labels: Sequence[str] = ()) -> _Family:
    return _DEFAULT.counter(name, help, labels)


def gauge(name: str, help: str = "",
          labels: Sequence[str] = ()) -> _Family:
    return _DEFAULT.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
    return _DEFAULT.histogram(name, help, labels, buckets)


def snapshot_json(indent: Optional[int] = None) -> str:
    return json.dumps(_DEFAULT.snapshot(), indent=indent, sort_keys=True)
