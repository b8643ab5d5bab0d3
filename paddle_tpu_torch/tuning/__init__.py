"""paddle_tpu_torch.tuning — the learned performance model and the
persistent tuning cache, from ``paddle_tpu/tuning/``.

* :mod:`cost_model` — the analytic cost terms the model's ``flash`` and
  ``plan`` feature dicts carry as a prior;
* :mod:`learned` — the telemetry-fed learned performance model: ridge
  heads per sample family trained on the event log (``batch_step``
  records of the serving engine, with their measured ``step_s``),
  persisted as a versioned ``perf_model.json`` under
  ``FLAGS_tuning_cache_dir``.  The serving scheduler admits prefills
  against its predicted batch-step cost, and ``python -m
  paddle_tpu_torch.observability watchdog --perf-model`` checks a run's
  step times against it;
* :mod:`cache` — the persistent tuning cache: a versioned JSONL store
  under ``FLAGS_tuning_cache_dir`` with atomic-rename writes, corruption
  fallback and hit/miss counters (no XLA compilation cache under it);
* CLI — ``python -m paddle_tpu_torch.tuning {stats,dump,prune,fit,merge}``
  (``fit --from-events <obs-dir>`` trains the learned model, ``merge``
  folds replicas' ``perf_model.json`` files into one for the fleet
  router).  ``warm`` raises ``NotImplementedError``: it writes the TPU
  flash kernel's block picks, and the port's flash tiles are fixed in
  ``ops/csrc/flash_attention.cu``.
"""
from .cache import SCHEMA_VERSION, TuningCache, canonical_key, get_cache
from .cost_model import Coefficients, dtype_bytes, flash_features
from .learned import (LearnedPerfModel, fit_from_telemetry, load_model,
                      save_model)

__all__ = ["SCHEMA_VERSION", "TuningCache", "canonical_key", "get_cache",
           "Coefficients", "dtype_bytes", "flash_features", "LearnedPerfModel", "fit_from_telemetry", "load_model",
           "save_model"]
