"""``dampr_tpu_torch.serve``: the multi-tenant pipeline service.

Port of ``dampr_tpu/serve``.  One long-running daemon
(``python -m dampr_tpu_torch.serve.daemon``) accepts composed plans from
many clients over HTTP and runs each in its own worker process on the
card; with the cross-run cache (:mod:`..plan.reuse`, on by default in
every worker) identical pipeline prefixes submitted by different tenants
run once and mount from the cache after.

- :mod:`.wire`: the validated, fingerprinted plan wire form (lambdas ship
  by code), the submission fingerprint, the input-byte cost estimate;
- :mod:`.scheduler`: per-tenant queues, deficit round-robin over byte
  budgets, reservations, in-flight coalescing;
- :mod:`.worker`: the per-job subprocess, one job = one process = one run
  scope (and one CUDA context);
- :mod:`.daemon`: the HTTP service, dispatch, timeouts, drain, coded
  events;
- :mod:`.client`: :class:`ServeClient`/:class:`RemoteJob`, behind
  ``PBase.submit(url, tenant=...)``.
"""

from .client import RemoteJob, ServeClient, SubmitError
from .daemon import ServeDaemon
from .wire import WireError

__all__ = ["RemoteJob", "ServeClient", "ServeDaemon", "SubmitError",
           "WireError"]
