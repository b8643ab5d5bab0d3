"""The semi-auto ``Engine``; counterpart of
``paddle_tpu/distributed/auto_parallel/engine.py`` (ref:
``python/paddle/distributed/auto_parallel/static/engine.py`` —
``Engine.fit`` / ``evaluate`` / ``predict`` / ``prepare`` / ``cost`` /
``tune``).

The Engine wraps the port's eager ``jit.TrainStep`` over the installed
mesh: a ``ProcessMesh`` (``auto_parallel.set_mesh``), else the global
rank grid (``fleet.init``'s), so ``fit`` takes the **global** batch and
returns the global-mean loss, as the JAX Engine does under GSPMD.  It
adds no math: a step is the training step's.  ``fit`` reads batches
from ``io.DataLoader`` and records each step's host seconds waiting for
the loader (``data_seconds``) and in the step (``step_seconds``).

* ``cost()`` is the reference's ``(time_ms, max_memory_bytes)`` of one
  step, ``None`` before the first.  The port counts for itself: the
  first step's FLOPs, the aten ops' (``torch.utils.flop_counter``) plus
  what the hand-written kernels add (``ops.flops``); the time is those
  FLOPs at half the card's dense bf16 peak (989 TFLOP/s).  The memory
  is that of a step that holds the optimizer's state throughout, as the
  JAX package's count of the jitted step's arguments, outputs and temps
  does: on the card ``torch.cuda.max_memory_allocated`` over the second
  step (after the first alone, its peak plus the state it made), on the
  CPU the bytes of the parameters, their gradients and the optimizer's
  state.
* ``tune()`` keeps the JAX package's policy (candidates, the roofline
  pre-rank, ``top_k``, ``budget_s``, an explicit list never truncated,
  the plan cache and the learned ``plan`` head).  Each rank times its
  trial steps and the ranks take the slowest rank's time, and agree on a
  candidate's error and on the budget, so every rank installs the same
  winner.  Around each trial the parameters, buffers, the optimizer's
  state and torch's generators are cloned and copied back, and the
  trial's DataParallel is taken off the model.
* ``save`` writes global values with ``paddle_tpu_torch.save`` (rank 0;
  split parameters gathered first): the model's state dict and the
  optimizer's state in the JAX package's format (``param_<i>_moment1``,
  ``..._beta1_pow``, ``master_weights``, ``global_step``), so either
  package's ``Engine.load`` reads the other's files.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import api
from .strategy import Strategy

__all__ = ["Engine"]

PEAK_BF16 = 989e12          # H100 SXM, dense bf16 (jit/__main__.py)


def _card_backend() -> bool:
    """Whether tune() runs on CUDA cards (tests monkeypatch this to
    exercise the card's defaults on the CPU)."""
    return torch.cuda.is_available()


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _world():
    from ..env import get_rank, get_world_size
    return get_rank(), get_world_size()


def _agree(value: float, device) -> float:
    """The largest of every rank's ``value`` (one all-reduce over the
    world; the value itself in a world of one)."""
    from ..communication import ReduceOp, all_reduce
    if _world()[1] == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    all_reduce(t, op=ReduceOp.MAX)
    return float(t.item())


def _comm_device():
    from ..env import runtime
    rt = runtime()
    return rt.device if rt is not None else torch.device("cpu")


class Engine:
    def __init__(self, model: torch.nn.Module, loss=None, optimizer=None,
                 metrics=None, strategy: Optional[Strategy] = None):
        self._model = model
        self._loss = loss
        self._optimizer = getattr(optimizer, "_inner_opt", optimizer)
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics is not None else [])
        self._strategy = strategy or Strategy()
        self._train_step = None
        self._cost = None
        self._counted = 0
        self.history = None
        self.data_seconds = []
        self.step_seconds = []

    def _ensure_step(self):
        if self._train_step is None:
            from ...jit.train_step import TrainStep
            self._train_step = TrainStep(self._model, None, self._optimizer,
                                         mesh=api._step_mesh(),
                                         step_fn=self._step_fn())
        return self._train_step

    def _drop_step(self) -> None:
        if self._train_step is not None:
            self._train_step.release()
            self._train_step = None

    # -- reference API ----------------------------------------------------
    def prepare(self, inputs_spec=None, labels_spec=None, mode="train"):
        self._ensure_step()

    def _param_bytes(self) -> int:
        return max(1, sum(int(np.prod(api.global_shape(p))) * 4
                          for p in self._model.parameters()))

    def _rank_candidates(self, candidates, batch_tokens):
        """The analytic roofline pre-rank (``tuning.cost_model.
        rank_plans``): for ordering only, measurement decides."""
        from ...tuning.cost_model import rank_plans
        return rank_plans(candidates, batch_tokens, self._param_bytes())

    def _install(self, dp, sh, mp) -> None:
        """The winner's rank grid as the global one; the step is built
        anew on it."""
        from ..mesh import set_mesh
        set_mesh(self._plan_mesh(dp, sh, mp))
        self._drop_step()

    @staticmethod
    def _plan_mesh(dp, sh, mp):
        from ..mesh import build_mesh
        return build_mesh({"dp": dp, "pp": 1, "sharding": sh, "sep": 1,
                           "cp": 1, "ep": 1, "mp": mp})

    def _store(self, tcache, plan_key, value) -> None:
        if _world()[0] == 0:
            tcache.store("engine_plan", plan_key, value)

    def _tune_from_perf_model(self, tcache, plan_key, candidates,
                              sample_inputs):
        """Zero-trial plan selection from the learned perf model's
        ``plan`` head (``tuning.learned``): the tune() result, or None to
        measure (flag off, no model file, no plan head)."""
        from ...flags import get_flag
        if not get_flag("learned_perf_model"):
            return None
        from ...tuning import learned
        model = learned.load_model(tcache.directory)
        if model is None or not model.has("plan"):
            return None
        batch_tokens = int(_numpy(sample_inputs).size)
        p_bytes = self._param_bytes()
        scored = []
        for c in candidates:
            pred = model.plan_seconds(c, batch_tokens, p_bytes)
            if pred is None:
                return None
            scored.append((pred, tuple(int(x) for x in c)))
        scored.sort()
        dp, sh, mp = scored[0][1]
        self._install(dp, sh, mp)
        report = [{"dp": d_, "sharding": s_, "mp": m_,
                   "predicted_s": round(p, 6), "source": "learned"}
                  for p, (d_, s_, m_) in scored]
        from ...tuning.cost_model import plan_layout
        self._store(tcache, plan_key, {
            "best": {"dp": dp, "sharding": sh, "mp": mp},
            "layout": plan_layout(dp, sh, mp), "report": report,
            "source": "learned", "model_version": model.version,
            "batch_tokens": batch_tokens, "param_bytes": p_bytes})
        self.tuning_report = report
        return {"dp": dp, "sharding": sh, "mp": mp, "report": report,
                "predicted": True}

    def _plan_signature(self, candidates, batch, n_devices, backend):
        """The plan cache's key: the model's parameter shapes and dtypes,
        the batch's, the candidates, the rank count and the backend
        (what bounds how many candidates are timed is left out)."""
        import hashlib
        import json
        params = [[api.global_shape(p), str(p.dtype).replace("torch.", "")]
                  for p in self._model.parameters()]
        model_sig = hashlib.sha256(json.dumps(
            [type(self._model).__name__, params],
            sort_keys=True).encode()).hexdigest()[:16]
        return {"model": model_sig,
                "batch": [[list(a.shape), str(a.dtype)] for a in batch],
                "candidates": sorted(list(map(int, c))
                                     for c in candidates),
                "n_devices": int(n_devices), "backend": str(backend)}

    def _snapshot(self):
        params = [p.detach().clone() for p in self._model.parameters()]
        bufs = [b.detach().clone() for b in self._model.buffers()]
        rng = (torch.get_rng_state(), torch.cuda.get_rng_state_all()
               if torch.cuda.is_available() else None)
        opt = None
        if self._optimizer is not None:
            o = self._optimizer
            opt = ({p: {k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in st.items()} for p, st in o.state.items()},
                   getattr(o, "_global_step", 0))
        return params, bufs, rng, opt

    def _restore(self, snap) -> None:
        params, bufs, rng, opt = snap
        with torch.no_grad():
            for p, v in zip(self._model.parameters(), params):
                p.copy_(v)
                p.grad = None
            # trial steps move buffers and the generators too
            for b, v in zip(self._model.buffers(), bufs):
                b.copy_(v)
        torch.set_rng_state(rng[0])
        if rng[1] is not None:
            torch.cuda.set_rng_state_all(rng[1])
        if opt is not None:
            o = self._optimizer
            o.state.clear()
            for p, st in opt[0].items():
                o.state[p] = {k: v.clone() if isinstance(v, torch.Tensor)
                              else v for k, v in st.items()}
            o._global_step = opt[1]

    def tune(self, sample_inputs, sample_labels=None, candidates=None,
             profile: Optional[bool] = None, top_k: Optional[int] = None,
             budget_s: Optional[float] = None):
        """Search (dp, sharding, mp) factorizations of the rank count for
        the fastest step (ref: ``auto_parallel/static/tuner/``), the JAX
        package's policy: every measured candidate scored by the wall
        time of a step after its first (``profile``: the median of 3),
        the slowest rank's; ``top_k`` measures the best k of the
        roofline pre-rank, ``budget_s`` starts no candidate once spent
        (the first always runs).  On the card an unset ``budget_s`` is
        600 s and an unset ``top_k`` 3 for the auto-enumerated space only
        (an explicit list is never truncated).  Each trial starts from
        the same parameters, optimizer state and generators, and leaves
        no reducer behind; the winner's grid is installed and the report
        lands in ``self.tuning_report``."""
        import time
        from ..mesh import get_mesh as _get_rank_mesh, set_mesh
        from ...jit.train_step import TrainStep

        if profile is None:
            profile = bool(getattr(self._strategy.tuning, "profile", False))
        rank, n = _world()
        if candidates is None:
            candidates = self._strategy.tuning.candidates
        explicit = candidates is not None
        if candidates is None:
            candidates = []
            for mp in (d for d in range(1, n + 1) if n % d == 0):
                rest = n // mp
                for sh in (d for d in range(1, rest + 1) if rest % d == 0):
                    candidates.append((rest // sh, sh, mp))
        if _card_backend():
            if top_k is None and not explicit:
                top_k = 3
            budget_s = 600.0 if budget_s is None else budget_s
        batch = [_numpy(sample_inputs)]
        if sample_labels is not None:
            if isinstance(sample_labels, (list, tuple)):
                batch.extend(_numpy(x) for x in sample_labels)
            else:
                batch.append(_numpy(sample_labels))
        backend = "cuda" if next(self._model.parameters()).is_cuda \
            else "cpu"

        from ...tuning.cache import get_cache
        tcache = get_cache()
        plan_key = None
        if tcache is not None:
            plan_key = self._plan_signature(candidates, batch, n, backend)
            cached = tcache.lookup("engine_plan", plan_key)
            if cached is not None:
                dp, sh, mp = (int(cached["best"][k])
                              for k in ("dp", "sharding", "mp"))
                self._install(dp, sh, mp)
                report = list(cached.get("report", []))
                report.append({"dp": dp, "sharding": sh, "mp": mp,
                               "cache": "hit"})
                self.tuning_report = report
                return {"dp": dp, "sharding": sh, "mp": mp,
                        "report": report, "cached": True}
            predicted = self._tune_from_perf_model(
                tcache, plan_key, candidates, sample_inputs)
            if predicted is not None:
                return predicted

        ranked = self._rank_candidates(candidates,
                                       int(_numpy(sample_inputs).size))
        skipped_rank = []
        if top_k is not None and top_k < len(ranked):
            skipped_rank = ranked[top_k:]
            ranked = ranked[:top_k]
        dev = _comm_device()
        t_tune0 = time.monotonic()
        prev_mesh = _get_rank_mesh()
        self._drop_step()
        snap = self._snapshot()
        report = []
        best = None
        attempted = 0
        for dp, sh, mp in ranked:
            entry = {"dp": dp, "sharding": sh, "mp": mp}
            # the budget fires even when every attempt fails; the first
            # candidate always runs; the ranks agree on the clock
            if budget_s is not None and attempted > 0 and _agree(
                    time.monotonic() - t_tune0, dev) > budget_s:
                entry["skipped"] = "tuning budget exhausted"
                report.append(entry)
                continue
            attempted += 1
            step, err = None, None
            try:
                mesh = self._plan_mesh(dp, sh, mp)
                step = TrainStep(self._model, None, self._optimizer,
                                 mesh=mesh, step_fn=self._step_fn(),
                                 donate=False)
                t0 = time.perf_counter()
                float(step(*batch))
                first = time.perf_counter() - t0
                reps = 3 if profile else 1
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    float(step(*batch))
                    times.append(time.perf_counter() - t0)
                secs = sorted(times)[reps // 2]
            except Exception as e:  # noqa: BLE001 — a candidate the
                err = str(e)[-200:]               # port cannot lay out
            finally:
                if step is not None:
                    step.release()
                self._restore(snap)
            if _agree(1.0 if err is not None else 0.0, dev) > 0:
                entry["error"] = err if err is not None else \
                    "failed on another rank"
            else:
                entry["compile_plus_step_s"] = round(_agree(first, dev), 3)
                entry["step_s"] = _agree(secs, dev)
                entry["score"] = entry["step_s"]
                if best is None or entry["score"] < best[0]:
                    best = (entry["score"], (dp, sh, mp))
            report.append(entry)
        for dp, sh, mp in skipped_rank:
            report.append({"dp": dp, "sharding": sh, "mp": mp,
                           "skipped": "below top_k in roofline pre-rank"})
        self.tuning_report = report
        if best is None:
            if prev_mesh is not None:
                set_mesh(prev_mesh)
            raise RuntimeError(
                f"Engine.tune: no candidate ran; report: {report}")
        _, (dp, sh, mp) = best
        self._install(dp, sh, mp)
        if tcache is not None and plan_key is not None:
            from ...tuning.cost_model import plan_layout
            self._store(tcache, plan_key, {
                "best": {"dp": dp, "sharding": sh, "mp": mp},
                "layout": plan_layout(dp, sh, mp),
                "report": report,
                "batch_tokens": int(_numpy(sample_inputs).size),
                "param_bytes": self._param_bytes()})
        return {"dp": dp, "sharding": sh, "mp": mp, "report": report}

    def _step_fn(self):
        def step_fn(model, *batch):
            inputs, labels = batch[0], batch[1:]
            out = model(inputs)
            if callable(self._loss):
                return self._loss(out, *labels)
            raise ValueError("Engine needs a callable loss")
        return step_fn

    def _loader(self, data, batch_size, shuffle=False):
        from ...io import DataLoader
        if hasattr(data, "__iter__") and not hasattr(data, "__getitem__"):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle)

    def _counted_step(self, step, batch):
        """``step(*batch)`` with what :meth:`cost` reports: the FLOPs of
        the first step, the memory of the first two (module
        docstring)."""
        import contextlib
        from torch.utils.flop_counter import FlopCounterMode
        from ...ops import flops
        dev = next(self._model.parameters()).device
        first = self._cost is None
        held = self._opt_state_bytes()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with (FlopCounterMode(display=False) if first
              else contextlib.nullcontext()) as fc, \
                (flops.counting() if first
                 else contextlib.nullcontext()) as kf:
            loss = step(*batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            # state made during the step was not held through it
            mem = torch.cuda.max_memory_allocated(dev) + \
                self._opt_state_bytes() - held
        else:
            mem = self._state_bytes()
        n = int(fc.get_total_flops()) + kf[0] if first else self._cost[0]
        self._cost = (n, int(mem))
        self._counted += 1
        return loss

    def _opt_state_bytes(self) -> int:
        state = getattr(self._optimizer, "state", None) or {}
        return sum(v.numel() * v.element_size() for st in state.values()
                   for v in st.values() if isinstance(v, torch.Tensor))

    def _state_bytes(self) -> int:
        params = list(self._model.parameters())
        n = sum(p.numel() * p.element_size() for p in params)
        n += sum(p.numel() * p.element_size() for p in params
                 if p.requires_grad)
        return n + self._opt_state_bytes()

    def fit(self, train_data, train_sample_split=None, batch_size=1,
            epochs=1, steps_per_epoch=None, log_freq=10, valid_data=None,
            **kwargs):
        """Train on ``train_data`` (a dataset read through
        ``io.DataLoader(batch_size=batch_size)``, or an iterable of
        batches); the first two steps are counted for :meth:`cost`.  Returns
        ``{"loss": [...]}`` (the global means)."""
        import time
        if getattr(self._strategy.tuning, "enable", False) and \
                self._train_step is None:
            import warnings
            if not hasattr(train_data, "__getitem__"):
                warnings.warn(
                    "strategy.tuning.enable is set but fit() received an "
                    "iterable dataset (no __getitem__) — skipping the "
                    "mesh search; call engine.tune(sample) explicitly",
                    RuntimeWarning)
            else:
                # samples are unbatched items: stack batch_size of them
                sample = train_data[0]
                sample = sample if isinstance(sample, (list, tuple)) \
                    else [sample]
                xs = [_numpy(s) for s in sample]
                batched = [np.stack([x] * max(int(batch_size or 1), 1))
                           for x in xs]
                try:
                    self.tune(batched[0], batched[1:] or None)
                except Exception as e:  # noqa: BLE001
                    warnings.warn(
                        f"mesh tuning failed ({e}); training continues "
                        "under the current mesh", RuntimeWarning)
        step = self._ensure_step()
        loader = self._loader(train_data, batch_size)
        history = {"loss": []}
        self.data_seconds, self.step_seconds = [], []
        for _ in range(epochs):
            it = iter(loader)
            i = 0
            while steps_per_epoch is None or i < steps_per_epoch:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                batch = batch if isinstance(batch, (list, tuple)) \
                    else [batch]
                loss = self._counted_step(step, batch) \
                    if self._counted < 2 else step(*batch)
                history["loss"].append(float(loss))
                self.data_seconds.append(t1 - t0)
                self.step_seconds.append(time.perf_counter() - t1)
                i += 1
            lr = getattr(self._optimizer, "_learning_rate", None)
            if hasattr(lr, "step"):
                lr.step()
        self.history = history
        return history

    def evaluate(self, valid_data, batch_size=1, steps=None, **kwargs):
        """The mean of the batches' losses (each the global mean over
        this rank's rows, without gradients)."""
        step = self._ensure_step()
        self._model.eval()
        losses = []
        try:
            for i, batch in enumerate(self._loader(valid_data,
                                                   batch_size)):
                if steps is not None and i >= steps:
                    break
                batch = batch if isinstance(batch, (list, tuple)) \
                    else [batch]
                _, val = api._eval_batch(step, self._model, self._loss,
                                         batch)
                if val is not None:
                    losses.append(float(val))
        finally:
            self._model.train()
        return {"eval_loss": float(np.mean(losses)) if losses else None}

    def predict(self, test_data, batch_size=1, steps=None, **kwargs):
        """Each batch's outputs (the global batch's rows, gathered over
        the data ranks)."""
        from ..communication import all_gather
        step = self._ensure_step()
        self._model.eval()
        outs = []
        try:
            for i, batch in enumerate(self._loader(test_data, batch_size)):
                if steps is not None and i >= steps:
                    break
                batch = batch if isinstance(batch, (list, tuple)) \
                    else [batch]
                out, _ = api._eval_batch(step, self._model, None, batch[:1])
                data = step._data
                if data is not None and data.n > 1:
                    out = all_gather(None, out.contiguous(), group=data.group)
                outs.append(out)
        finally:
            self._model.train()
        return outs

    # -- save / load -------------------------------------------------------
    def _check_savable(self) -> None:
        from ..fleet.base.topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if hcg is not None and hcg.get_expert_parallel_world_size() > 1:
            raise NotImplementedError(
                "Engine.save / load under an expert degree above 1 (each "
                "rank holds its experts): save with distributed.checkpoint")

    def _opt_params(self):
        return [p for g in self._optimizer.param_groups for p in g["params"]]

    @staticmethod
    def _global(value, p):
        da = api.get_dist_attr(p)
        if da is None:
            return value.detach()
        return api._global(value.detach(), da.process_mesh, da.placements)

    @staticmethod
    def _piece(value, p):
        da = api.get_dist_attr(p)
        if da is None:
            return value
        return api._local(value, da.process_mesh, da.placements)

    def _model_state(self) -> dict:
        named = dict(self._model.named_parameters())
        return {k: self._global(named.get(k, v), named.get(k, v))
                for k, v in self._model.state_dict().items()}

    def _optimizer_state(self) -> dict:
        """The optimizer's state in the JAX package's format, global
        values."""
        sd, masters = {}, {}
        rows = []
        for i, p in enumerate(self._opt_params()):
            st = self._optimizer.state.get(p)
            if st:
                rows.append((f"param_{i}", p, st))
        for acc in ("beta1_pow", "beta2_pow"):
            for key, _, st in rows:
                if "beta_pows" in st:
                    j = 0 if acc == "beta1_pow" else 1
                    sd[f"{key}_{acc}"] = st["beta_pows"][j].detach().clone()
        for acc in ("moment1", "moment2"):
            for key, p, st in rows:
                if acc in st:
                    sd[f"{key}_{acc}"] = self._global(st[acc], p)
        for key, p, st in rows:
            if "master" in st:
                masters[key] = self._global(st["master"], p)
        if masters:
            sd["master_weights"] = masters
        sd["global_step"] = int(getattr(self._optimizer, "_global_step", 0))
        return sd

    def save(self, path: str, training: bool = True):
        """``path.pdparams`` (the model's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's state): global
        values, written by rank 0 (a collective call when parameters are
        split)."""
        from ...framework.io import save as psave
        from ..communication import barrier
        self._check_savable()
        rank, world = _world()
        model = self._model_state()
        opt = self._optimizer_state() \
            if training and self._optimizer is not None else None
        if rank == 0:
            psave(model, path + ".pdparams")
            if opt is not None:
                psave(opt, path + ".pdopt")
        if world > 1:
            barrier()

    def load(self, path: str, strict: bool = True,
             load_optimizer: bool = True):
        """Load ``path.pdparams`` (and ``path.pdopt`` if it exists)
        written by either package's ``Engine.save``; each rank keeps its
        pieces of split parameters."""
        from ...framework.io import load as pload
        self._check_savable()
        named = dict(self._model.named_parameters())
        sd = {}
        for k, v in pload(path + ".pdparams").items():
            v = torch.as_tensor(v)
            sd[k] = self._piece(v, named[k]) if k in named else v
        self._model.load_state_dict(sd, strict=strict)
        if load_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._load_optimizer(pload(path + ".pdopt"))

    def _load_optimizer(self, osd: dict) -> None:
        o = self._optimizer
        masters = osd.get("master_weights") or {}
        with torch.no_grad():
            for i, p in enumerate(self._opt_params()):
                key = f"param_{i}"
                if not any(k.startswith(key + "_") for k in osd) and \
                        key not in masters:
                    continue
                st = o._checkpoint_state(p)
                for acc in ("moment1", "moment2"):
                    if f"{key}_{acc}" in osd and acc in st:
                        st[acc].copy_(self._piece(
                            torch.as_tensor(osd[f"{key}_{acc}"]), p))
                if "beta_pows" in st:
                    for j, acc in enumerate(("beta1_pow", "beta2_pow")):
                        if f"{key}_{acc}" in osd:
                            st["beta_pows"][j] = torch.as_tensor(
                                osd[f"{key}_{acc}"]).reshape(())
                if key in masters and "master" in st:
                    st["master"].copy_(self._piece(
                        torch.as_tensor(masters[key]), p))
        o._global_step = int(osd.get("global_step", 0))

    def cost(self, mode="train"):
        """ref: Engine.cost: ``(time_ms, max_memory_bytes)`` of one
        training step (module docstring), ``None`` before the first.
        The FLOPs counted stay in ``_cost[0]``."""
        if self._cost is None:
            return None
        flops, mem = self._cost
        return (flops / (0.5 * PEAK_BF16) * 1e3, mem)
