"""fleet.elastic.manager — alias module mirroring the reference's
import path (ref: python/paddle/distributed/fleet/elastic/manager.py);
a copy of ``paddle_tpu/distributed/fleet/elastic/manager.py``.
The implementation lives in the package __init__."""
from . import (ElasticManager, ElasticStatus, LauncherInterface,
               worker_heartbeat)

__all__ = ["ElasticManager", "ElasticStatus", "LauncherInterface",
           "worker_heartbeat"]
