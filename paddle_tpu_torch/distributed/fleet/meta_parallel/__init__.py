"""Fleet's parallel wrappers: so far the group-sharded stages 1 to 3
(``sharding``); model and pipeline parallel wait for later slices."""
from . import sharding
