"""paddle_tpu_torch.tuning — the learned performance model, from
``paddle_tpu/tuning/``.

* :mod:`cost_model` — the analytic cost terms the model's ``flash`` and
  ``plan`` feature dicts carry as a prior;
* :mod:`learned` — the telemetry-fed learned performance model: ridge
  heads per sample family trained on the event log (``batch_step``
  records of the serving engine, with their measured ``step_s``),
  persisted as a versioned ``perf_model.json`` under
  ``FLAGS_tuning_cache_dir``.  The serving scheduler admits prefills
  against its predicted batch-step cost, and ``python -m
  paddle_tpu_torch.observability watchdog --perf-model`` checks a run's
  step times against it.

Not ported: the persistent tuning cache (``cache.py``) and ``python -m
paddle_tpu.tuning``; the port has no autotuner or mesh tuner to feed.
"""
from .cost_model import Coefficients, dtype_bytes, flash_features
from .learned import (LearnedPerfModel, fit_from_telemetry, load_model,
                      save_model)

__all__ = ["Coefficients", "dtype_bytes", "flash_features",
           "LearnedPerfModel", "fit_from_telemetry", "load_model",
           "save_model"]
