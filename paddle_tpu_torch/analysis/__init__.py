"""Analysis of the port: ``pass_check``, the replay-equivalence verifier
of the program passes, and ``perf_features``, the event-log featurizer
of the learned perf model (``tuning.learned``)."""
from . import pass_check, perf_features

__all__ = ["pass_check", "perf_features"]
