"""A budget-bounded exchange: one large all_to_all planned as a schedule
of chunked steps (B8's schedule).

Port of ``dampr_tpu/parallel/replan.py``, whole: host-only planning,
after "Memory-efficient array redistribution" (arXiv 2112.01075).  The
naive byte exchange would size its ``[D*D, C]`` buffer by the largest
blob, so one fat (src, dst) pair amplifies to ``D*D`` rows of its pow2
bucket; instead the redistribution becomes a *schedule* of steps whose
in-flight bytes respect ``settings.exchange_hbm_budget``:

1. from the budget, the largest pow2 cell capacity ``C_max`` whose step
   fits (:func:`max_capacity_for`, over :func:`step_inflight_bytes`);
2. every blob sliced into pieces of at most ``C_max`` bytes;
3. the pieces round-robin: step ``i`` carries piece ``i`` of every
   (src, dst) pair, and a tail step shrinks to its own largest piece.

The executor (:func:`.exchange.mesh_blob_exchange`) walks the schedule
and reassembles the pieces in order.
"""

from .. import settings

#: Smallest cell capacity a step may use: below this the int32 length row
#: and dispatch overhead dominate the payload.  A budget too small for
#: even this floor is *clamped* (recorded on the schedule), never honored
#: by silently dropping data.
MIN_CAPACITY = 64

#: Length-row bytes per cell (int32 valid-length lane riding each step).
_LEN_BYTES = 4


def _pow2(n, floor=MIN_CAPACITY):
    return max(floor, 1 << max(0, (int(n) - 1).bit_length()))


def _pow2_floor(n, floor=MIN_CAPACITY):
    """Largest pow2 at or UNDER n (an upper bound must never round up:
    the explicit chunk knob exists for memory-pressured operators, so a
    piece may not exceed what they asked for)."""
    return max(floor, 1 << max(0, int(n).bit_length() - 1))


def step_inflight_bytes(n_dev, capacity, gather=False):
    """Deterministic peak-bytes model for one exchange step at cell
    capacity ``capacity``: the send buffer and the delivered buffer are
    both live across the collective (``2 *``), and the multi-process
    gather variant replicates the delivered buffer once more so every
    host can read the full result (``3 *``).  Each cell also carries an
    int32 length lane.  This is the number schedules are planned and
    reported against (``peak_inflight_bytes``)."""
    copies = 3 if gather else 2
    cells = n_dev * n_dev
    return copies * cells * (int(capacity) + _LEN_BYTES)


def max_capacity_for(n_dev, budget, gather=False):
    """The largest pow2 cell capacity whose step fits ``budget`` under
    :func:`step_inflight_bytes`.  Returns ``(capacity, clamped)`` —
    ``clamped`` is True when even :data:`MIN_CAPACITY` exceeds the budget
    (the schedule still runs at the floor; refusing would drop data)."""
    cap = MIN_CAPACITY
    if step_inflight_bytes(n_dev, cap, gather) > budget:
        return cap, True
    while step_inflight_bytes(n_dev, cap * 2, gather) <= budget:
        cap *= 2
    return cap, False


class ExchangeStep(object):
    """One collective step: ``cells`` is ``[(src, dst, start, stop)]`` —
    the byte slice of blob ``(src, dst)`` this step carries — and
    ``capacity`` the pow2 cell bucket the step's program compiles at."""

    __slots__ = ("cells", "capacity", "inflight_bytes")

    def __init__(self, cells, capacity, inflight_bytes):
        self.cells = cells
        self.capacity = capacity
        self.inflight_bytes = inflight_bytes

    def payload_bytes(self):
        return sum(stop - start for _s, _d, start, stop in self.cells)


class ExchangeSchedule(object):
    """The planned step sequence plus the invariants callers report:
    ``peak_inflight_bytes`` (max of the per-step model) and ``clamped``
    (budget below the capacity floor — the only case where
    ``peak_inflight_bytes > budget``).  ``coding`` carries the CAMR-style
    coded-aggregation record when the caller pre-folded sum-combinable
    partials before planning (``settings.exchange_coding``): mode,
    ``raw_bytes`` (what the uncoded schedule would have moved) and
    ``coded_bytes`` (what this schedule moves) — replicated map-side
    fold work traded for shuffle bytes, arXiv 1901.07418."""

    def __init__(self, n_dev, steps, budget, gather, clamped,
                 coding=None):
        self.n_dev = n_dev
        self.steps = steps
        self.budget = budget
        self.gather = gather
        self.clamped = clamped
        self.coding = coding
        self.total_bytes = sum(s.payload_bytes() for s in steps)
        self.peak_inflight_bytes = max(
            (s.inflight_bytes for s in steps), default=0)

    @property
    def n_steps(self):
        return len(self.steps)


def plan_exchange(n_dev, sizes, budget=None, gather=False,
                  chunk_bytes=None, coding=None):
    """Plan a budget-bounded exchange of ``sizes`` ({(src, dst): nbytes})
    across an ``n_dev`` mesh.

    ``budget`` defaults to ``settings.exchange_hbm_budget``;
    ``chunk_bytes`` (default ``settings.exchange_chunk_bytes``, 0 = off)
    additionally caps the per-piece size below what the budget allows —
    the explicit chunk-size knob the doctor playbook points at when a
    device is memory-pressured beyond what the budget models.
    ``coding`` (optional dict) records a coded-aggregation pre-fold on
    the returned schedule — the *sizes already reflect* the coded
    payload; the record keeps the raw-vs-coded byte evidence with the
    schedule it shaped.
    """
    if budget is None:
        budget = settings.exchange_hbm_budget
    if chunk_bytes is None:
        chunk_bytes = settings.exchange_chunk_bytes
    cap, clamped = max_capacity_for(n_dev, budget, gather)
    if chunk_bytes:
        cap = min(cap, _pow2_floor(chunk_bytes))

    # Round-robin piece assignment: piece i of every blob rides step i.
    pairs = sorted(sizes.items())
    n_steps = max((-(-n // cap) if n else 1 for _sd, n in pairs),
                  default=0)
    steps = []
    for i in range(n_steps):
        cells = []
        largest = 0
        for (s, d), n in pairs:
            start = i * cap
            if start > 0 and start >= n:
                continue  # this blob finished in an earlier step
            stop = min(n, start + cap)
            cells.append((s, d, start, stop))
            largest = max(largest, stop - start)
        capacity = min(cap, _pow2(max(1, largest)))
        steps.append(ExchangeStep(
            cells, capacity,
            step_inflight_bytes(n_dev, capacity, gather)))
    return ExchangeSchedule(n_dev, steps, budget, gather, clamped,
                            coding=coding)
