"""Execution over a mesh of shards, in one process or across several.

Port of ``dampr_tpu/parallel``.  A mesh (:mod:`.mesh`) is an ordered
tuple of torch devices (``settings.mesh_devices``; one device may be
named more than once); across processes (:func:`.mesh.init_distributed`,
a gloo process group) each rank holds its local shards of the global
mesh.  The collectives between shards are :mod:`.mesh`'s
``all_to_all``, ``psum``, ``all_gather`` and ``ppermute``.

- :func:`.shuffle.mesh_keyed_fold`: the keyed shuffle (B7), per shard a
  local fold, an ``all_to_all`` routed by ``h1 % D`` with capacity
  buffers and an overflow retry, then a final fold.
- :func:`.shuffle.mesh_global_sum`: a degenerate-key aggregate.
- :mod:`.exchange`: the general byte exchange (B8), run as a
  :mod:`.replan` schedule under ``settings.exchange_hbm_budget``.
- :mod:`.ring`: ring all-reduce and all-gather (B9); :mod:`.sgd`: the
  data-parallel SGD step (B10).
- :mod:`.mitigate`: the straggler mitigation (``settings.mitigate``).
"""

from . import replan
from .exchange import mesh_blob_exchange, mesh_shuffle_blocks
from .mesh import (data_mesh, default_mesh, init_distributed,
                   maybe_init_distributed, process_info)
from .replan import plan_exchange, step_inflight_bytes
from .shuffle import mesh_global_sum, mesh_keyed_fold

__all__ = ["data_mesh", "default_mesh", "init_distributed",
           "maybe_init_distributed",
           "process_info", "mesh_keyed_fold", "mesh_global_sum",
           "mesh_blob_exchange", "mesh_shuffle_blocks",
           "replan", "plan_exchange", "step_inflight_bytes"]
