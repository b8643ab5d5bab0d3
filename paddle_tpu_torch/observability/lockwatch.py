"""Runtime lock-graph sanitizer; a copy of
``paddle_tpu/observability/lockwatch.py`` (the JAX package's dynamic
twin of its PTL9xx static concurrency rules).

The hang→diagnostic contract, applied to locks: on real traffic a
lock-order inversion is a deadlock that wedges a serving replica until
the fleet router drains it, with nothing to debug but a stuck process.
Under ``FLAGS_lock_sanitizer`` the serving tier builds its locks
through :func:`make_lock` / :func:`make_rlock` / :func:`make_condition`
and gets instrumented wrappers that

* record the per-thread **held-lock stack** (who holds what, acquired
  where);
* maintain a global **lock-order graph**: holding ``A`` while
  acquiring ``B`` records the edge ``A -> B`` with the establishing
  thread's name and hold stack.  At every acquire the graph is checked
  *before blocking*: if a path ``B ->* A`` already exists, this
  acquisition closes a wait-for cycle and raises :class:`LockOrderError`
  naming **both** threads' full hold stacks — deterministically, even
  when the interleaving that would actually deadlock never fires in
  the test run (same fingerprint idea as the collective sanitizer);
* emit ``lock_contention`` events into the JSONL envelope when a wait
  or hold crosses :data:`WAIT_THRESHOLD_S` / :data:`HOLD_THRESHOLD_S`;
* export ``paddle_lock_acquisitions_total``,
  ``paddle_lock_contention_seconds`` and ``paddle_lock_held_seconds``
  metric families, labelled by lock name.

Ordering is keyed by lock **name**, not object identity: every
``ServingEngine`` instance shares the ``serving.engine`` ordering
discipline, so a cycle found on one engine indicts the code path, not
the object.  Same-name edges are ignored (RLock reentrancy, sibling
instances).

With the flag off the factories return stdlib primitives — production
pays a single flag read at construction time and nothing per acquire.
The flag is read lazily (no on_change hook) so observability never
loads during flag bootstrap; set it before constructing the engine.
"""
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderError", "make_lock", "make_rlock", "make_condition",
    "reset_lockwatch", "lockwatch_enabled",
    "WAIT_THRESHOLD_S", "HOLD_THRESHOLD_S",
]

# contention-event thresholds (seconds); tests shrink these to force
# emission, chaos CI keeps the defaults to stay quiet on healthy runs
WAIT_THRESHOLD_S = 0.1
HOLD_THRESHOLD_S = 0.5


class LockOrderError(RuntimeError):
    """A lock acquisition would close a wait-for cycle.

    Carries both sides of the inversion: the acquiring thread's hold
    stack and the hold stack recorded when the conflicting edge was
    established — the two interleavings that deadlock each other.
    """

    def __init__(self, lock: str, this_thread: str,
                 this_stack: List[str], other_thread: str,
                 other_stack: List[str], path: List[str]):
        self.lock = lock
        self.this_thread = this_thread
        self.this_stack = list(this_stack)
        self.other_thread = other_thread
        self.other_stack = list(other_stack)
        self.path = list(path)
        super().__init__(
            "lock-order cycle at acquire of '%s': %s\n"
            "  thread %r holds:\n    %s\n"
            "  thread %r established the reverse order holding:\n    %s"
            % (lock, " -> ".join(path),
               this_thread, "\n    ".join(this_stack) or "(nothing)",
               other_thread, "\n    ".join(other_stack) or "(nothing)"))


def _enabled() -> bool:
    from ..flags import get_flag
    return bool(get_flag("lock_sanitizer"))


def lockwatch_enabled() -> bool:
    return _enabled()


# ---------------------------------------------------------------------------
# global order graph + per-thread hold stacks
# ---------------------------------------------------------------------------

class _Graph:
    """name -> name edges with the establishing (thread, stack)."""

    def __init__(self):
        # the sanitizer's own mutex is a raw stdlib lock: it must not
        # instrument itself
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], Tuple[str, List[str]]] = {}

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()

    def check_and_add(self, held: List[Tuple[str, str, float]],
                      lock: str, stack: List[str]) -> None:
        """Raise LockOrderError if acquiring *lock* while holding
        *held* closes a cycle; otherwise record the new edges."""
        if not held:
            return
        me = threading.current_thread().name
        held_names = [h[0] for h in held if h[0] != lock]
        if not held_names:
            return
        with self._mu:
            # path lock ->* h for any held h == cycle through h -> lock
            reach = self._reachable(lock)
            for h in held_names:
                if h in reach:
                    other_thread, other_stack = self._edges.get(
                        (lock, h), self._first_edge_from(lock))
                    path = [h, lock] + self._path(lock, h)[1:]
                    raise LockOrderError(
                        lock, me, stack, other_thread, other_stack,
                        path)
            for h in held_names:
                self._edges.setdefault((h, lock), (me, list(stack)))

    def _reachable(self, start: str):
        seen = {start}
        frontier = [start]
        while frontier:
            cur = frontier.pop()
            for (a, b) in self._edges:
                if a == cur and b not in seen:
                    seen.add(b)
                    frontier.append(b)
        seen.discard(start)
        return seen

    def _path(self, start: str, goal: str) -> List[str]:
        prev: Dict[str, Optional[str]] = {start: None}
        frontier = [start]
        while frontier:
            cur = frontier.pop(0)
            if cur == goal:
                break
            for (a, b) in self._edges:
                if a == cur and b not in prev:
                    prev[b] = cur
                    frontier.append(b)
        if goal not in prev:
            return [start, goal]
        out = [goal]
        cur = prev[goal]
        while cur is not None:
            out.append(cur)
            cur = prev[cur]
        out.reverse()
        return out

    def _first_edge_from(self, lock: str) -> Tuple[str, List[str]]:
        for (a, _b), meta in self._edges.items():
            if a == lock:
                return meta
        return ("<unknown>", [])


_GRAPH = _Graph()
_TLS = threading.local()


def _held_stack() -> List[Tuple[str, str, float]]:
    """This thread's [(lock name, acquire site, t_acquired)]."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _caller_site() -> str:
    import sys
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith(
            "lockwatch.py"):
        f = f.f_back
    if f is None:
        return "<unknown>"
    return "%s:%d" % (f.f_code.co_filename, f.f_lineno)


def reset_lockwatch() -> None:
    """Clear the global order graph (tests; a fresh chaos scenario)."""
    _GRAPH.reset()


# ---------------------------------------------------------------------------
# telemetry (lazy: must survive flag bootstrap and import cheaply)
# ---------------------------------------------------------------------------

_metric_cache: dict = {}


def _metrics():
    fams = _metric_cache.get("fams")
    if fams is None:
        from . import metrics
        fams = (
            metrics.counter(
                "paddle_lock_acquisitions_total",
                "lock acquisitions through the lock sanitizer",
                labels=("lock",)),
            metrics.histogram(
                "paddle_lock_contention_seconds",
                "time spent blocked waiting for an instrumented lock",
                labels=("lock",), buckets=metrics.TIME_BUCKETS),
            metrics.histogram(
                "paddle_lock_held_seconds",
                "time an instrumented lock was held per acquisition",
                labels=("lock",), buckets=metrics.TIME_BUCKETS),
        )
        _metric_cache["fams"] = fams
    return fams


def _emit_contention(lock: str, phase: str, site: str,
                     wait_s: Optional[float] = None,
                     held_s: Optional[float] = None) -> None:
    try:
        from . import events as _events
        _events.emit("lock_contention", lock=lock, phase=phase,
                     site=site, wait_s=wait_s, held_s=held_s,
                     thread=threading.current_thread().name)
    except Exception:
        pass                      # telemetry must never take the tier down


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------

class _WatchedLock:
    """Lock wrapper: order-graph check at acquire, hold accounting at
    release.  Exposes ``_is_owned``/``_release_save``/
    ``_acquire_restore`` so a stdlib ``threading.Condition`` can wrap
    it (wait() releases and re-acquires through the wrapper, keeping
    the held-stack honest across the sleep)."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()
        self._owner: Optional[int] = None
        self._depth = 0

    @staticmethod
    def _make_inner():
        return threading.Lock()

    # -- core protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._depth += 1
            return got
        stack = _held_stack()
        site = _caller_site()
        _GRAPH.check_and_add(
            stack, self.name,
            ["%s (acquired at %s)" % (n, s) for n, s, _ in stack])
        t0 = time.monotonic()
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return got
        wait_s = time.monotonic() - t0
        self._owner = me
        self._depth = 1
        stack.append((self.name, site, time.monotonic()))
        acq, contended, _held = _metrics()
        acq.labels(lock=self.name).inc()
        contended.labels(lock=self.name).observe(wait_s)
        if wait_s >= WAIT_THRESHOLD_S:
            _emit_contention(self.name, "wait", site, wait_s=wait_s)
        return got

    def release(self):
        me = threading.get_ident()
        if self._reentrant and self._owner == me and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        stack = _held_stack()
        held_s = None
        site = "<unknown>"
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == self.name:
                _, site, t_acq = stack.pop(i)
                held_s = time.monotonic() - t_acq
                break
        self._owner = None
        self._depth = 0
        self._inner.release()
        if held_s is not None:
            *_ignored, held_fam = _metrics()
            held_fam.labels(lock=self.name).observe(held_s)
            if held_s >= HOLD_THRESHOLD_S:
                _emit_contention(self.name, "hold", site,
                                 held_s=held_s)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked()

    # -- Condition integration ---------------------------------------------
    def _is_owned(self):
        return self._owner == threading.get_ident()

    def _release_save(self):
        # Condition.wait: drop the lock (and the held-stack entry)
        depth = self._depth if self._reentrant else 1
        state = depth
        for _ in range(depth - 1):
            self._inner.release()
        self._depth = 1
        self.release()
        return state

    def _acquire_restore(self, state):
        self.acquire()
        if self._reentrant:
            for _ in range(state - 1):
                self._inner.acquire()
            self._depth = state

    def __repr__(self):
        return "<%s %r held=%r>" % (type(self).__name__, self.name,
                                    self._inner.locked())


class _WatchedRLock(_WatchedLock):
    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()


# ---------------------------------------------------------------------------
# the factory the serving tier builds its locks through
# ---------------------------------------------------------------------------

def make_lock(name: str):
    """``threading.Lock()`` — instrumented when FLAGS_lock_sanitizer."""
    if _enabled():
        return _WatchedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """``threading.RLock()`` — instrumented when FLAGS_lock_sanitizer."""
    if _enabled():
        return _WatchedRLock(name)
    return threading.RLock()


def make_condition(name: str, lock=None):
    """``threading.Condition(lock)``.

    With the sanitizer on and no *lock*, the condition wraps a fresh
    instrumented lock named *name*; an instrumented *lock* (the
    engine's ``_wake`` over ``_lock``) is wrapped as-is — stdlib
    Condition drives it through acquire/release/_is_owned, so waits
    keep the held-stack and order graph honest.
    """
    if lock is None and _enabled():
        lock = _WatchedLock(name)
    return threading.Condition(lock)
