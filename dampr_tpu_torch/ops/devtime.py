"""Which run a keyed batch op's device call is charged to.

The hash, sort and segment-fold helpers (:mod:`.hashing`,
:mod:`.segment`) run on ``settings.device`` for batches that pass
``settings.use_device_for``; each such call copies its lanes to the
device and its result back, then waits for it.  The helpers do not know
the run that calls them: the runner binds its
:class:`~dampr_tpu_torch.storage.RunStore` to each job's thread
(:func:`charging`), and :func:`add` charges the call to it
(``RunStore.count_keyed``): its host seconds (copies, launch and wait
included) per op, its bytes into the run's h2d/d2h counters.  A call made
outside a run's job is charged to no run.
"""

import contextlib
import threading

_local = threading.local()


@contextlib.contextmanager
def charging(store):
    """Charge the keyed device calls this thread makes to ``store``."""
    prev = getattr(_local, "store", None)
    _local.store = store
    try:
        yield
    finally:
        _local.store = prev


def add(name, seconds, h2d, d2h):
    """One device call of the keyed op ``name``."""
    store = getattr(_local, "store", None)
    if store is not None:
        store.count_keyed(name, seconds, h2d, d2h)
