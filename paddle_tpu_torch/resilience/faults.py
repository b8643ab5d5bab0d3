"""Deterministic fault injection; a copy of
``paddle_tpu/resilience/faults.py`` (stdlib only).

The failure modes are first-class and *scheduled*, so a chaos run is
exactly reproducible: the same ``FLAGS_fault_schedule`` against the same
script fires the same faults at the same occurrence counts, every time.

Named fault points (zero-cost when no schedule is installed).  The
schedule grammar keeps all of the reference's points, so one schedule
string parses alike in both packages; the port plants four of them:

================ ======================================================
``serving_step`` top of each serving-engine dispatch (single step AND
                 fused window — ``serving.engine``), before any launch
``step``         end of a training step (``resilience.driver``
                 ``ResilientTrainLoop.end_step``)
``ckpt_write``   inside ``distributed.checkpoint.save_state_dict`` —
                 after this rank's data file lands, *before* the
                 ``_COMMIT`` manifest is written (the torn window)
``collective``   entry of every ``distributed`` collective (host side,
                 before the sanitizer and the launch)
``compile``      a compile-cache miss (not planted in the port)
================ ======================================================

Schedule syntax (``FLAGS_fault_schedule`` / the env var of the same
name)::

    point@N=kind[:arg] [; point@N=kind[:arg] ...]

``N`` is the 1-based occurrence count of that point *in one process* at
which the fault fires.  Kinds:

* ``crash``          — SIGKILL this process (simulated host loss)
* ``exit[:CODE]``    — ``os._exit(CODE)`` (default 1)
* ``stall[:SECS]``   — block ``SECS`` (default 3600) — wedges past any
  sane timeout so a watchdog must fire
* ``exc[:TypeName]`` — raise a transient exception (a builtin exception
  name, default :class:`InjectedFault`)
* ``truncate`` / ``corrupt`` — at ``ckpt_write``: damage the largest
  data file under the fault point's ``path``; at ``collective``: queue
  payload damage (``take_collective_damage``)
* ``nan``            — only at ``serving_step``: poison one request's
  logits with NaN on the device, so the engine's NaN-logits sentinel
  (not the host) must attribute and quarantine the offender

``serving_step`` faults are STICKY poisons for the ``exc`` and ``nan``
kinds: firing queues a poison directive (``take_serving_poison``) that
the engine pins to one member request of the in-flight plan, and every
subsequent batch containing that request fails the same way — which is
what makes quarantine-by-bisection converge on the offender
deterministically.  ``stall`` (and ``crash``/``exit``) execute directly
at the dispatch, exactly once: a stalled dispatch is the hung-step
watchdog's target, and recovery must not re-stall.

Cross-relaunch semantics: occurrence counters are per-process, but when
``PADDLE_FAULT_STATE_FILE`` is set each schedule entry fires at most
once per *job* — the fired set is persisted to that file before the
fault executes, so a relaunched process does not re-fire the fault that
killed its predecessor.

Stdlib-only on purpose: this module is imported from ``flags.py`` at
package-import time (env ingestion).
"""
from __future__ import annotations

import builtins
import os
import re
import signal
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["FaultSpec", "FaultInjector", "InjectedFault", "POINTS",
           "KINDS", "parse_schedule", "install_schedule", "get_injector",
           "maybe_fault", "queue_collective_damage",
           "take_collective_damage", "queue_serving_poison",
           "take_serving_poison"]

POINTS = ("step", "ckpt_write", "collective", "compile", "serving_step")
KINDS = ("crash", "exit", "stall", "exc", "truncate", "corrupt", "nan")

STATE_FILE_ENV = "PADDLE_FAULT_STATE_FILE"


class InjectedFault(RuntimeError):
    """Default transient exception raised by ``exc`` faults."""


@dataclass
class FaultSpec:
    point: str            # one of POINTS
    occurrence: int       # 1-based per-process hit count at which to fire
    kind: str             # one of KINDS
    arg: Optional[str] = None
    fired: bool = False

    @property
    def key(self) -> str:
        """Stable identity used by the cross-relaunch fired-state file."""
        return f"{self.point}@{self.occurrence}={self.kind}" + (
            f":{self.arg}" if self.arg is not None else "")


_SPEC_RE = re.compile(
    r"^(?P<point>[a-z_]+)@(?P<occ>[0-9]+)=(?P<kind>[a-z_]+)"
    r"(?::(?P<arg>.*))?$")


def parse_schedule(text: str) -> List[FaultSpec]:
    """Parse ``point@N=kind[:arg]`` items (';' or ',' separated).

    Raises ``ValueError`` on unknown points/kinds or a malformed item —
    a typo'd chaos schedule must fail loudly, not silently not-inject.
    """
    specs: List[FaultSpec] = []
    for item in re.split(r"[;,]", text or ""):
        item = item.strip()
        if not item:
            continue
        m = _SPEC_RE.match(item)
        if m is None:
            raise ValueError(
                f"malformed fault spec {item!r} "
                "(expected 'point@N=kind[:arg]')")
        point, occ, kind = m["point"], int(m["occ"]), m["kind"]
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(known: {', '.join(POINTS)})")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {', '.join(KINDS)})")
        if occ < 1:
            raise ValueError(f"occurrence must be >= 1 in {item!r}")
        if kind in ("truncate", "corrupt") and \
                point not in ("ckpt_write", "collective"):
            raise ValueError(
                f"{kind!r} only applies to the ckpt_write and "
                f"collective points ({item!r})")
        if kind == "nan" and point != "serving_step":
            raise ValueError(
                f"'nan' only applies to the serving_step point "
                f"({item!r})")
        specs.append(FaultSpec(point, occ, kind, m["arg"]))
    return specs


# checkpoint-layout metadata: damaging these models a torn DIRECTORY
# (restore fails outright); damaging a payload chunk models bit rot
# that only a content digest can see — prefer the payload
_CKPT_META_NAMES = {"_COMMIT", "_METADATA", "_CHECKPOINT_METADATA",
                    "_sharding", "manifest.ocdbt", "checkpoint"}


def _largest_file(root: str) -> Optional[str]:
    """Deterministic pick: the largest regular PAYLOAD file under
    ``root`` (size desc, then path asc — ties cannot flap between
    runs); falls back to checkpoint metadata when no payload exists."""
    best: Optional[Tuple[int, str]] = None
    best_meta: Optional[Tuple[int, str]] = None
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            p = os.path.join(dirpath, name)
            try:
                size = os.path.getsize(p)
            except OSError:
                continue
            cand = (-size, p)
            if name in _CKPT_META_NAMES:
                if best_meta is None or cand < best_meta:
                    best_meta = cand
            elif best is None or cand < best:
                best = cand
    pick = best or best_meta
    return pick[1] if pick else None


def damage_checkpoint(path: str, mode: str) -> Optional[str]:
    """Deterministically damage the largest data file under ``path``.

    ``truncate`` halves the file (torn write); ``corrupt`` flips 8 bytes
    in the middle without changing the size (bit rot — only a digest can
    see it).  Returns the damaged file's path, or None if nothing to hit.
    """
    target = _largest_file(path)
    if target is None:
        return None
    size = os.path.getsize(target)
    if mode == "truncate":
        with open(target, "r+b") as fh:
            fh.truncate(max(size // 2, 0))
    elif mode == "corrupt":
        if size == 0:
            return None
        with open(target, "r+b") as fh:
            fh.seek(size // 2)
            chunk = fh.read(8)
            fh.seek(size // 2)
            fh.write(bytes((b ^ 0xFF) for b in chunk))
    else:
        raise ValueError(f"unknown damage mode {mode!r}")
    return target


class FaultInjector:
    """Executes a parsed schedule against named fault points.

    Occurrence counters are per-instance (i.e. per-process under the
    flag-bound singleton); ``fired_log`` records ``(point, occurrence,
    kind)`` tuples in firing order for assertions and post-mortems.
    """

    def __init__(self, specs: List[FaultSpec],
                 state_file: Optional[str] = None):
        self.specs = list(specs)
        self.state_file = state_file if state_file is not None \
            else os.environ.get(STATE_FILE_ENV) or None
        self.counts: Dict[str, int] = {}
        self.fired_log: List[Tuple[str, int, str]] = []
        for spec in self.specs:
            if spec.key in self._persisted_fired():
                spec.fired = True

    # -- cross-relaunch fired state --------------------------------------
    def _persisted_fired(self) -> set:
        if not self.state_file:
            return set()
        try:
            with open(self.state_file, "r", encoding="utf-8") as fh:
                return {ln.strip() for ln in fh if ln.strip()}
        except OSError:
            return set()

    def _persist(self, spec: FaultSpec) -> None:
        if not self.state_file:
            return
        try:
            with open(self.state_file, "a", encoding="utf-8") as fh:
                fh.write(spec.key + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        except OSError:
            # a lost fired-record degrades to a re-fire on relaunch —
            # loud in the fired_log, never silently skipped
            pass

    # -- firing ----------------------------------------------------------
    def fire(self, point: str, path: Optional[str] = None,
             **ctx: Any) -> None:
        """Count a hit of ``point``; execute any spec scheduled for this
        occurrence.  ``path`` feeds the checkpoint-damage kinds."""
        n = self.counts[point] = self.counts.get(point, 0) + 1
        for spec in self.specs:
            if spec.fired or spec.point != point or spec.occurrence != n:
                continue
            spec.fired = True
            self.fired_log.append((point, n, spec.kind))
            # the record must survive the fault itself (crash/exit never
            # return) so a relaunched process sees it as already-fired
            self._persist(spec)
            # telemetry likewise BEFORE execution — a crash fault would
            # never come back to log itself (lazy import: this module
            # loads from flags.py during package bootstrap)
            try:
                from ..observability import events
                events.emit("fault", point=point, occurrence=n,
                            fault_kind=spec.kind, arg=spec.arg)
            except ImportError:
                pass
            self._execute(spec, path)

    def _execute(self, spec: FaultSpec, path: Optional[str]) -> None:
        if spec.point == "serving_step" and spec.kind in ("exc", "nan"):
            # sticky poison: the engine pins this to ONE member request
            # of the in-flight plan and re-fails every batch containing
            # it — the determinism quarantine-by-bisection relies on.
            # (stall falls through to the direct sleep below: a hung
            # dispatch is the watchdog's target and must not re-stall
            # after recovery.)
            queue_serving_poison(spec.kind, spec.arg)
            return
        if spec.kind in ("crash", "exit"):
            # the process never returns from these: dump the flight
            # recorder FIRST so the post-mortem ring survives (SIGKILL
            # gives no atexit; lazy import mirrors the emit above)
            try:
                from ..observability import tracing
                tracing.dump_flight(f"fault:{spec.kind}")
            except ImportError:
                pass
        if spec.kind == "crash":
            os.kill(os.getpid(), signal.SIGKILL)
        elif spec.kind == "exit":
            os._exit(int(spec.arg or 1))
        elif spec.kind == "stall":
            time.sleep(float(spec.arg or 3600.0))
        elif spec.kind == "exc":
            exc_type: type = InjectedFault
            if spec.arg:
                cand = getattr(builtins, spec.arg, None)
                if isinstance(cand, type) and \
                        issubclass(cand, BaseException):
                    exc_type = cand
                else:
                    raise ValueError(
                        f"fault schedule names unknown exception type "
                        f"{spec.arg!r}")
            raise exc_type(
                f"injected fault: {spec.point}@{spec.occurrence}")
        elif spec.kind in ("truncate", "corrupt"):
            if spec.point == "collective":
                # no file to damage: queue payload damage for the
                # collective sanitizer to apply to one rank's
                # fingerprint (how a real torn/bit-rotten collective
                # payload manifests: shapes/dtypes stop agreeing)
                queue_collective_damage(spec.kind)
            elif path is not None:
                damage_checkpoint(path, spec.kind)


# ---------------------------------------------------------------------------
# collective payload damage (truncate/corrupt at the collective point)
# ---------------------------------------------------------------------------

# pending damage kinds queued by _execute for the collective sanitizer;
# bounded so an unconsumed queue (sanitizer off) cannot grow
_COLLECTIVE_DAMAGE: List[str] = []
_COLLECTIVE_DAMAGE_CAP = 8


def queue_collective_damage(kind: str) -> None:
    if len(_COLLECTIVE_DAMAGE) < _COLLECTIVE_DAMAGE_CAP:
        _COLLECTIVE_DAMAGE.append(kind)


def take_collective_damage() -> Optional[str]:
    """Pop the oldest queued collective damage kind, or None."""
    return _COLLECTIVE_DAMAGE.pop(0) if _COLLECTIVE_DAMAGE else None


# ---------------------------------------------------------------------------
# serving-step poison (exc/nan at the serving_step point)
# ---------------------------------------------------------------------------

# pending (kind, arg) poison directives queued by _execute for the
# serving engine; bounded like the collective queue so an unconsumed
# directive (engine stopped) cannot grow
_SERVING_POISON: List[Tuple[str, Optional[str]]] = []
_SERVING_POISON_CAP = 8


def queue_serving_poison(kind: str, arg: Optional[str] = None) -> None:
    if len(_SERVING_POISON) < _SERVING_POISON_CAP:
        _SERVING_POISON.append((kind, arg))


def take_serving_poison() -> Optional[Tuple[str, Optional[str]]]:
    """Pop the oldest queued serving poison ``(kind, arg)``, or None."""
    return _SERVING_POISON.pop(0) if _SERVING_POISON else None


# ---------------------------------------------------------------------------
# flag-bound singleton (FLAGS_fault_schedule installs it)
# ---------------------------------------------------------------------------

_INSTALLED: Optional[FaultInjector] = None


def install_schedule(text: Optional[str]) -> Optional[FaultInjector]:
    """(Re)install the process injector from a schedule string; empty or
    None uninstalls.  Called by the ``FLAGS_fault_schedule`` on_change
    hook, so env ingestion at import wires workers automatically."""
    global _INSTALLED
    specs = parse_schedule(text) if text else []
    _COLLECTIVE_DAMAGE.clear()       # stale damage must not leak across
    _SERVING_POISON.clear()          # schedules — both queues reset
    _INSTALLED = FaultInjector(specs) if specs else None
    return _INSTALLED


def get_injector() -> Optional[FaultInjector]:
    return _INSTALLED


def maybe_fault(point: str, path: Optional[str] = None,
                **ctx: Any) -> None:
    """The planted fault point: a no-op unless a schedule is installed."""
    inj = _INSTALLED
    if inj is not None:
        inj.fire(point, path=path, **ctx)
