"""Pipeline schedules FThenB / 1F1B / VPP / ZBH1; counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_schedules.py`` (ref:
``fleet/meta_parallel/pipeline_parallel.py``,
``distributed/passes/pipeline_scheduler_pass.py``).

A schedule is a per-stage order of events over M micro-batches: ``F``
(forward), ``B`` (backward) or, under ZBH1, ``Bd`` (the input gradient,
on the critical path) and ``Bw`` (the weight gradient, deferred into the
drain).  The timetables ``_order_fthenb`` / ``_order_1f1b`` /
``_order_zbh1`` are the JAX package's; VPP is 1F1B over P x V virtual
stages, virtual stage k on stage k % P (``PipelineLayer.
virtual_stage_bounds``: the JAX package's ``_virtual_bounds``).
:func:`global_order` runs the JAX package's dependency-driven tick loop
without computing anything: at every tick each stage takes its next
event if its inputs are ready (an activation produced earlier in the
same tick counts).  Both schedules
below execute events in that order, so each stage's order is the
timetable's and equals the JAX package's ``event_log``.

* :class:`HostPipelineSchedule` runs every stage in this process (the
  JAX package's way): the tests on the CPU, and the one-card run with
  every stage on ``cuda:0``.
* :class:`P2PPipelineSchedule` is one rank of a pipeline (one process a
  stage, as in the reference): it runs its own stage's events (under VPP
  its virtual stages') in the global order and exchanges activations
  and gradients with its neighbours over the topology's p2p channels
  (``HybridCommunicateGroup.get_p2p_groups``), one two-rank group per
  direction and kind.  A channel carries its messages in the order its
  sender makes them; the receiver posts its receives in that order
  (it knows every rank's order), so no two ranks wait on each other.
  Receive buffers take the shape and dtype the sender announces on a
  channel's first message (every message unless ``p2p_cache_shape``).

An event's residuals are its stage's autograd graph.  ``F`` runs the
stage's layers on a detached copy of its input that requires a gradient;
``B`` runs ``torch.autograd.backward`` from its output (the last stage:
from ``loss / M``, as a step that accumulates ``loss / M`` a micro-batch
does; times the loss scale when ``amp.GradScaler`` scales it), which
accumulates the parameters' gradients and the input's;
``Bd`` is ``torch.autograd.grad`` on the input, keeping the graph, and
``Bw`` the same on the parameters, added to their gradients (the first
stage's ``Bd`` has no input gradient to take; its ``Bw`` is the whole
backward).  So every schedule adds the same per-micro-batch gradients in
the same order: their parameters agree bit for bit.
``peak_live_residuals`` counts the graphs between ``F`` and ``B`` /
``Bd``, as the JAX package counts its vjps; ZBH1's graphs kept from
``Bd`` to ``Bw`` are counted in ``peak_retained_graphs``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...communication.collective_ops import recv, send

__all__ = ["FWD", "BWD", "BWD_D", "BWD_W", "global_order",
           "HostPipelineSchedule", "P2PPipelineSchedule"]

FWD, BWD, BWD_D, BWD_W = "F", "B", "Bd", "Bw"


# ---------------------------------------------------------------------------
# schedule timetables (per-stage event order: this is the schedule)
# ---------------------------------------------------------------------------

def _order_fthenb(stage: int, n_stages: int, m: int):
    return [(FWD, i) for i in range(m)] + [(BWD, i) for i in range(m)]


def _order_1f1b(stage: int, n_stages: int, m: int):
    """ref: PipelineParallel 1F1B — warmup forwards, steady forward /
    backward pairs, cooldown backwards."""
    warmup = min(n_stages - stage - 1, m)
    ev: List[Tuple[str, int]] = [(FWD, i) for i in range(warmup)]
    b = 0
    for f in range(warmup, m):
        ev.append((FWD, f))
        ev.append((BWD, b))
        b += 1
    ev += [(BWD, i) for i in range(b, m)]
    return ev


def _order_zbh1(stage: int, n_stages: int, m: int):
    """ZBH1 (ref: pipeline_scheduler_pass zero-bubble H1): 1F1B with the
    backward split into Bd and Bw, the earlier stages' Bw deferred into
    the drain."""
    warmup = min(n_stages - stage - 1, m)
    ev: List[Tuple[str, int]] = [(FWD, i) for i in range(warmup)]
    b = 0
    for f in range(warmup, m):
        ev.append((FWD, f))
        ev.append((BWD_D, b))
        if stage == n_stages - 1:
            ev.append((BWD_W, b))
        b += 1
    for i in range(b, m):
        ev.append((BWD_D, i))
    if stage != n_stages - 1:
        ev += [(BWD_W, i) for i in range(m)]
    else:
        ev += [(BWD_W, i) for i in range(b, m)]
    return ev


_ORDERS = {"FThenB": _order_fthenb, "F-then-B": _order_fthenb,
           "1F1B": _order_1f1b, "ZBH1": _order_zbh1, "ZBpp": _order_zbh1}


def _order_fn(mode: str):
    fn = _ORDERS.get("1F1B" if mode == "VPP" else mode)
    if fn is None:
        raise ValueError(f"unknown schedule_mode {mode!r} "
                         f"(have {sorted(_ORDERS)} + VPP)")
    return fn


def global_order(mode: str, n_virtual: int, m: int
                 ) -> List[Tuple[int, str, int]]:
    """Every event ``(virtual stage, kind, micro)`` in the order the JAX
    package's tick loop runs them (module docstring)."""
    order_fn = _order_fn(mode)
    s_n = n_virtual
    queues = [list(order_fn(s, s_n, m)) for s in range(s_n)]
    qpos = [0] * s_n
    done = set()

    def ready(s, kind, i):
        if kind == FWD:
            return s == 0 or (s - 1, FWD, i) in done
        if kind in (BWD, BWD_D):
            if (s, FWD, i) not in done:
                return False
            return s == s_n - 1 or (s + 1, BWD, i) in done \
                or (s + 1, BWD_D, i) in done
        return (s, BWD_D, i) in done

    out = []
    remaining = sum(len(q) for q in queues)
    while remaining:
        progressed = False
        for s in range(s_n):
            if qpos[s] >= len(queues[s]):
                continue
            kind, i = queues[s][qpos[s]]
            if ready(s, kind, i):
                out.append((s, kind, i))
                done.add((s, kind, i))
                qpos[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            stuck = [(s, queues[s][qpos[s]]) for s in range(s_n)
                     if qpos[s] < len(queues[s])]
            raise RuntimeError(f"pipeline schedule deadlock (mode={mode}): "
                               f"waiting on {stuck[:4]}")
    return out


# ---------------------------------------------------------------------------
# one (virtual) stage and one step's events
# ---------------------------------------------------------------------------

class _StageRunner:
    """One (virtual) stage: its layers in order, ``recompute_every`` > 0
    groups them in runs of that many, each recomputed in the backward
    (``fleet.recompute``: the JAX package's ``jax.checkpoint`` chunks);
    ``loss_fn`` on the last stage."""

    def __init__(self, layers: Sequence, device=None, loss_fn=None,
                 recompute_every: int = 0):
        self.layers = list(layers)
        self.device = torch.device(device) if device is not None else None
        self.loss_fn = loss_fn
        seen, params = set(), []
        for layer in self.layers:
            for p in layer.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    params.append(p)
        self.params = params
        k = int(recompute_every) if recompute_every else 0
        self.chunks = [self.layers[i:i + k]
                       for i in range(0, len(self.layers), k)] if k > 0 \
            else [self.layers]
        self.recompute = k > 0

    @staticmethod
    def _run_chunk(chunk, *h):
        x = h if len(h) > 1 else h[0]
        for layer in chunk:
            x = layer(*x) if isinstance(x, tuple) else layer(x)
        return x

    def forward(self, h, labels=None):
        from ..recompute import recompute
        for chunk in self.chunks:
            args = h if isinstance(h, tuple) else (h,)
            if self.recompute:
                h = recompute(self._run_chunk, chunk, *args)
            else:
                h = self._run_chunk(chunk, *args)
        if self.loss_fn is not None:
            return self.loss_fn(h, labels)
        return h


def _to(x, device):
    if device is None:
        return x
    if isinstance(x, tuple):
        return tuple(_to(t, device) for t in x)
    return x.to(device)


class _Step:
    """One step's residuals: the graph of each (virtual stage, micro)
    between its F and its B / Bd, ZBH1's graphs between Bd and Bw, and
    the last stage's losses."""

    def __init__(self, runners: Dict[int, _StageRunner], n_virtual: int,
                 m: int, loss_scale: Optional[torch.Tensor] = None):
        self.runners = runners
        self.last = n_virtual - 1
        self.m = m
        self.loss_scale = loss_scale
        self.saved: Dict[Tuple[int, int], tuple] = {}
        self.retained: Dict[Tuple[int, int], tuple] = {}
        self.losses: Dict[int, torch.Tensor] = {}
        self.peak_live = 0
        self.peak_retained = 0

    def forward(self, k, i, h, labels=None):
        r = self.runners[k]
        # a later stage's input (the previous one's output) is a leaf of
        # its graph, whose gradient goes back
        h_in = h.detach().requires_grad_(True) if k > 0 else h
        with torch.enable_grad():
            out = r.forward(h_in, labels if k == self.last else None)
            if k == self.last:
                self.losses[i] = out.detach()
                out = out / self.m
                if self.loss_scale is not None:
                    out = out * self.loss_scale.to(out.device, out.dtype)
        self.saved[(k, i)] = (h_in, out)
        self.peak_live = max(self.peak_live, len(self.saved))
        return None if k == self.last else out.detach()

    def backward(self, k, i, cot, kind):
        """B or Bd of ``(k, i)`` from the output gradient ``cot`` (the
        last stage: none, its output is ``loss / M``); returns the input
        gradient (``None`` on the first stage)."""
        h_in, out = self.saved.pop((k, i))
        leaf = h_in if k > 0 else None
        if kind == BWD or leaf is None:
            if kind == BWD_D:
                # the first stage has no input gradient: its Bw is the
                # whole backward
                self.retained[(k, i)] = (out, cot, None)
                self.peak_retained = max(self.peak_retained,
                                         len(self.retained))
                return None
            torch.autograd.backward(out, cot)
            return None if leaf is None else leaf.grad
        (g,) = torch.autograd.grad(out, leaf, cot, retain_graph=True)
        self.retained[(k, i)] = (out, cot, leaf)
        self.peak_retained = max(self.peak_retained, len(self.retained))
        return g

    def weight_backward(self, k, i):
        out, cot, leaf = self.retained.pop((k, i))
        if leaf is None:
            torch.autograd.backward(out, cot)
            return
        params = [p for p in self.runners[k].params if p.requires_grad]
        grads = torch.autograd.grad(out, params, cot, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if g is None:
                    continue
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad += g

    def mean_loss(self):
        """The micro-batches' mean loss, summed in fp32 in micro-batch
        order (an O2 loss is bf16, whose spacing at 10 is 0.0625)."""
        total = None
        for i in range(self.m):
            loss = self.losses[i].float()
            total = loss if total is None else total + loss
        return total / self.m


def _runners(pl, n_virtual: int, ks, devices=None) -> Dict[int, _StageRunner]:
    bounds = pl.virtual_stage_bounds(n_virtual)
    rc = getattr(pl, "_recompute_interval", 0) or 0
    n_stages = pl.get_num_stages()
    out = {}
    for k in ks:
        a, b = bounds[k]
        out[k] = _StageRunner(
            pl.layers_of(a, b),
            devices[k % n_stages] if devices is not None else None,
            loss_fn=pl._loss_fn if k == n_virtual - 1 else None,
            recompute_every=rc)
    return out


def _n_virtual(pl, mode: str) -> int:
    v = getattr(pl, "_num_virtual_pipeline_stages", 1) or 1
    if mode == "VPP":
        if v <= 1:
            raise ValueError("schedule_mode='VPP' needs "
                             "num_virtual_pipeline_stages > 1 on the "
                             "PipelineLayer")
        return pl.get_num_stages() * v
    return pl.get_num_stages()


# ---------------------------------------------------------------------------
# every stage in this process
# ---------------------------------------------------------------------------

class HostPipelineSchedule:
    """Drive a segmented :class:`PipelineLayer` that this process holds
    whole through an explicit schedule (``schedule_mode``: FThenB |
    1F1B | VPP | ZBH1); VPP runs ``num_virtual_pipeline_stages`` chunks
    a stage, virtual stage k on ``devices[k % P]``.  ``devices`` (one a
    stage) default to where the layers' parameters are; activations move
    between them.  ``dp_degree`` above 1 raises ``NotImplementedError``:
    data parallelism runs across processes
    (``PipelineParallel``, :class:`P2PPipelineSchedule`)."""

    def __init__(self, pipeline_layer, schedule_mode: str = "1F1B",
                 devices: Optional[Sequence] = None, dp_degree: int = 1):
        if dp_degree and int(dp_degree) > 1:
            raise NotImplementedError(
                "dp x pp in one process: data parallelism runs one "
                "process a rank (PipelineParallel under fleet.init)")
        self.pl = pipeline_layer
        self.mode = schedule_mode
        n_stages = pipeline_layer.get_num_stages()
        self.n_virtual = _n_virtual(pipeline_layer, schedule_mode)
        self.n_devices = n_stages
        self.dp_degree = 1
        if devices is not None and len(devices) != n_stages:
            raise ValueError(f"{len(devices)} devices for {n_stages} stages")
        self.runners = _runners(pipeline_layer, self.n_virtual,
                                range(self.n_virtual), devices)
        if devices is not None:
            with torch.no_grad():
                for r in self.runners.values():
                    for p in r.params:
                        p.data = p.data.to(r.device)
        self.event_log: List[Tuple[int, str, int]] = []
        self.peak_live_residuals = 0
        self.peak_retained_graphs = 0
        # amp.GradScaler's scale for the step (PipelineParallel sets it)
        self.loss_scale: Optional[torch.Tensor] = None

    def forward_backward(self, micro_inputs, micro_labels):
        """Run every micro-batch through the schedule, accumulating the
        stages' gradients into their parameters' ``.grad`` (each
        micro-batch's ``loss / M`` times ``self.loss_scale`` when set);
        returns the mean loss."""
        m = len(micro_inputs)
        s_n = self.n_virtual
        order = global_order(self.mode, s_n, m)
        step = _Step(self.runners, s_n, m, self.loss_scale)
        acts: Dict[Tuple[int, int], torch.Tensor] = {}
        gin: Dict[Tuple[int, int], torch.Tensor] = {}
        self.event_log = []
        for k, kind, i in order:
            self.event_log.append((k, kind, i))
            dev = self.runners[k].device
            if kind == FWD:
                h = micro_inputs[i] if k == 0 else acts.pop((k - 1, i))
                labels = _to(micro_labels[i], dev) if k == s_n - 1 \
                    else None
                out = step.forward(k, i, _to(h, dev), labels)
                if out is not None:
                    acts[(k, i)] = out
            elif kind in (BWD, BWD_D):
                cot = None if k == s_n - 1 else _to(gin.pop((k + 1, i)), dev)
                g = step.backward(k, i, cot, kind)
                if k > 0:
                    gin[(k, i)] = g
            else:
                step.weight_backward(k, i)
        self.peak_live_residuals = step.peak_live
        self.peak_retained_graphs = step.peak_retained
        return step.mean_loss()


# ---------------------------------------------------------------------------
# one rank of a pipeline over p2p
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_META_LEN = 8


class _Channel:
    """One direction of one kind between two ranks: the messages in the
    sender's order, each announced by its shape and dtype on the first
    message (every message without ``cache_shape``)."""

    def __init__(self, group, src: int, dst: int, cache_shape: bool,
                 device):
        self.group, self.src, self.dst = group, src, dst
        self.cache_shape = cache_shape
        self.device = device
        self.meta: Optional[Tuple[tuple, torch.dtype]] = None
        self.posted: List[Tuple[torch.Tensor, object]] = []
        self.works: List[object] = []

    def _announce(self) -> bool:
        return self.meta is None or not self.cache_shape

    def send(self, t: torch.Tensor) -> None:
        t = t.contiguous()
        if self._announce():
            meta = torch.zeros(_META_LEN, dtype=torch.int64,
                               device=self.device)
            meta[0] = t.dim()
            meta[1] = _DTYPES.index(t.dtype)
            meta[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
            self.works.append((meta, send(meta, self.dst, self.group,
                                          sync_op=False)))
            self.meta = (tuple(t.shape), t.dtype)
        # the tensor stays referenced until the send has finished
        self.works.append((t, send(t, self.dst, self.group, sync_op=False)))

    def _post_next(self) -> None:
        if self._announce():
            meta = torch.zeros(_META_LEN, dtype=torch.int64,
                               device=self.device)
            recv(meta, self.src, self.group)
            got = meta.tolist()                 # one host read
            self.meta = (tuple(got[2:2 + got[0]]), _DTYPES[got[1]])
        shape, dtype = self.meta
        buf = torch.empty(shape, dtype=dtype, device=self.device)
        self.posted.append((buf, recv(buf, self.src, self.group,
                                      sync_op=False)))

    def get(self, index: int) -> torch.Tensor:
        """Message ``index`` (receives posted in order up to it)."""
        while len(self.posted) <= index:
            self._post_next()
        buf, work = self.posted[index]
        if work is not None:
            work.wait()
            self.posted[index] = (buf, None)
        return buf

    def finish(self) -> None:
        for _, w in self.works:
            w.wait()
        self.works = []
        self.posted = []


class P2PPipelineSchedule:
    """One rank of a pipeline (module docstring): the events of its
    stage (under VPP its virtual stages ``s, s + P, ...``) of ``pl``, a
    :class:`PipelineLayer` built under the fleet topology, over the
    topology's p2p channels.  ``runners`` replaces the stages built from
    ``pl`` (``{virtual stage: _StageRunner}``, the rank's own), for
    callers whose stages are not a ``PipelineLayer``'s."""

    def __init__(self, pipeline_layer=None, schedule_mode: str = "1F1B",
                 hcg=None, cache_shape: bool = True, n_stages=None,
                 n_virtual=None, runners=None, device=None):
        from ..base.topology import get_hybrid_communicate_group
        self.hcg = hcg or get_hybrid_communicate_group()
        h = self.hcg
        self.mode = schedule_mode
        self.n_stages = n_stages or pipeline_layer.get_num_stages()
        if self.n_stages != h.get_pipe_parallel_world_size():
            raise ValueError(f"{self.n_stages} stages on a pipeline degree "
                             f"of {h.get_pipe_parallel_world_size()}")
        if runners is None:
            v = pipeline_layer.get_num_virtual_stages()
            if v > 1 and schedule_mode != "VPP":
                raise ValueError(
                    f"num_virtual_pipeline_stages={v} builds the "
                    "interleaved chunks on each rank: use "
                    "schedule_mode='VPP'")
            self.n_virtual = _n_virtual(pipeline_layer, schedule_mode)
            ks = [k for k in range(self.n_virtual)
                  if k % self.n_stages == h.get_stage_id()]
            runners = _runners(pipeline_layer, self.n_virtual, ks)
        else:
            _order_fn(schedule_mode)
            self.n_virtual = n_virtual or self.n_stages
        self.runners = runners
        self.stage = h.get_stage_id()
        self.device = torch.device(device) if device is not None else \
            next(p.device for r in runners.values() for p in r.params)
        me = h.get_global_rank()
        self._rank_of = [h.get_rank_from_stage(s)
                         for s in range(self.n_stages)]
        self._channels: Dict[Tuple[str, int, int], _Channel] = {}
        for kind, src, dst, g in h.p2p_channels():
            if me in (src, dst):
                self._channels[(kind, src, dst)] = _Channel(
                    g, src, dst, cache_shape, self.device)
        self._warm(h)
        self.event_log: List[Tuple[int, str, int]] = []
        self.peak_live_residuals = 0
        self.peak_retained_graphs = 0
        self.timing = False
        self.busy_ms = 0.0
        self.step_ms = 0.0
        # amp.GradScaler's scale for the step (the callers set it)
        self.loss_scale: Optional[torch.Tensor] = None

    def _warm(self, h) -> None:
        """Open every channel of the world in one order (each rank its
        own): a communicator is made on first use, and making one waits
        for both ranks."""
        me = h.get_global_rank()
        one = torch.zeros(1, device=self.device)
        for kind, src, dst, g in h.p2p_channels():
            if me == src:
                send(one, dst, g)
            elif me == dst:
                recv(one, src, g)
        if one.is_cuda:
            torch.cuda.synchronize(one.device)

    def _stage_of(self, k: int) -> int:
        return k % self.n_stages

    def _channel(self, kind: str, k_from: int, k_to: int) -> _Channel:
        return self._channels[(kind, self._rank_of[self._stage_of(k_from)],
                               self._rank_of[self._stage_of(k_to)])]

    def _message_index(self, order, kind, k_from, i) -> int:
        """The position of ``(k_from, micro i)``'s message among those
        its channel carries, in the sender's order."""
        s_n = self.n_virtual
        src = self._stage_of(k_from)
        if kind == "act":
            dst = self._stage_of(k_from + 1)
            sent = [(k, j) for k, e, j in order
                    if e == FWD and k < s_n - 1 and self._stage_of(k) == src
                    and self._stage_of(k + 1) == dst]
        else:
            dst = self._stage_of(k_from - 1)
            sent = [(k, j) for k, e, j in order
                    if e in (BWD, BWD_D) and k > 0
                    and self._stage_of(k) == src
                    and self._stage_of(k - 1) == dst]
        return sent.index((k_from, i))

    def _plan(self, m: int):
        """This rank's events of a step of ``m`` micro-batches in order,
        and the channel position of each message it receives."""
        s_n = self.n_virtual
        order = global_order(self.mode, s_n, m)
        mine = [(k, e, i) for k, e, i in order if k in self.runners]
        index = {}
        for k, e, i in mine:
            if e == FWD and k > 0 and self._stage_of(k - 1) != self.stage:
                index[("act", k - 1, i)] = self._message_index(
                    order, "act", k - 1, i)
            if e in (BWD, BWD_D) and k < s_n - 1 and \
                    self._stage_of(k + 1) != self.stage:
                index[("grad", k + 1, i)] = self._message_index(
                    order, "grad", k + 1, i)
        return mine, index

    def exchange_only(self, m: int, like: torch.Tensor) -> None:
        """One step's p2p traffic of this rank and nothing else: every
        message its events of ``m`` micro-batches receive and send, each
        ``like``'s shape and dtype, in the step's order (the exchange
        measured alone)."""
        s_n = self.n_virtual
        mine, index = self._plan(m)
        for k, kind, i in mine:
            if kind == FWD:
                if k > 0 and self._stage_of(k - 1) != self.stage:
                    self._channel("act", k - 1, k).get(
                        index[("act", k - 1, i)])
                if k < s_n - 1 and self._stage_of(k + 1) != self.stage:
                    self._channel("act", k, k + 1).send(like)
            elif kind in (BWD, BWD_D):
                if k < s_n - 1 and self._stage_of(k + 1) != self.stage:
                    self._channel("grad", k + 1, k).get(
                        index[("grad", k + 1, i)])
                if k > 0 and self._stage_of(k - 1) != self.stage:
                    self._channel("grad", k, k - 1).send(like)
        for ch in self._channels.values():
            ch.finish()

    def forward_backward(self, micro_inputs, micro_labels):
        """This rank's events of one step over its micro-batches
        (``micro_inputs`` are read on the first stage, ``micro_labels`` on
        the last; the others may be ``None``); gradients accumulate into
        the rank's parameters (the last stage's losses times
        ``self.loss_scale`` when set).  Returns the mean loss on the last
        stage, else ``None``."""
        m = len(micro_inputs) if micro_inputs is not None \
            else len(micro_labels)
        s_n = self.n_virtual
        mine, index = self._plan(m)
        step = _Step(self.runners, s_n, m, self.loss_scale)
        local: Dict[Tuple[str, int, int], torch.Tensor] = {}
        timing = self.timing and self.device.type == "cuda"
        spans = []
        if timing:
            t_start = torch.cuda.Event(enable_timing=True)
            t_start.record()
        self.event_log = []
        for k, kind, i in mine:
            self.event_log.append((k, kind, i))
            if kind == FWD:
                if k == 0:
                    h = micro_inputs[i]
                elif self._stage_of(k - 1) == self.stage:
                    h = local.pop(("act", k - 1, i))
                else:
                    h = self._channel("act", k - 1, k).get(
                        index[("act", k - 1, i)])
                labels = micro_labels[i] if k == s_n - 1 else None
                ev = self._span(timing, spans)
                out = step.forward(k, i, h, labels)
                self._close(ev)
                if out is None:
                    continue
                if self._stage_of(k + 1) == self.stage:
                    local[("act", k, i)] = out
                else:
                    self._channel("act", k, k + 1).send(out)
            elif kind in (BWD, BWD_D):
                if k == s_n - 1:
                    cot = None
                elif self._stage_of(k + 1) == self.stage:
                    cot = local.pop(("grad", k + 1, i))
                else:
                    cot = self._channel("grad", k + 1, k).get(
                        index[("grad", k + 1, i)])
                ev = self._span(timing, spans)
                g = step.backward(k, i, cot, kind)
                self._close(ev)
                if k == 0:
                    continue
                if self._stage_of(k - 1) == self.stage:
                    local[("grad", k, i)] = g
                else:
                    self._channel("grad", k, k - 1).send(g)
            else:
                ev = self._span(timing, spans)
                step.weight_backward(k, i)
                self._close(ev)
        for ch in self._channels.values():
            ch.finish()
        if timing:
            t_end = torch.cuda.Event(enable_timing=True)
            t_end.record()
            t_end.synchronize()
            self.step_ms = t_start.elapsed_time(t_end)
            self.busy_ms = sum(a.elapsed_time(b) for a, b in spans)
        self.peak_live_residuals = step.peak_live
        self.peak_retained_graphs = step.peak_retained
        return step.mean_loss() if (s_n - 1) in self.runners else None

    @staticmethod
    def _span(timing, spans):
        if not timing:
            return None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        spans.append((a, b))
        return b

    @staticmethod
    def _close(ev):
        if ev is not None:
            ev.record()
