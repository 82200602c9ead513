"""Straggler mitigation: the live skew signal turned into action.

Port of ``dampr_tpu/parallel/mitigate.py``, whole.  :mod:`..obs.fleet`
names the straggler rank after a run; this module acts on the same
signal while the run is live.  A per-run :class:`MitigationController`
reads the ranks' exchange-step entry times (shared over a small
all_gather after each window, :func:`.exchange._share_skew`) and acts at
three levels:

1. **Work stealing and speculative execution** (host path):
   :func:`pool_dispatch` replaces the runner's thread pool with per-worker
   job queues.  An idle worker steals unstarted jobs from the most
   backlogged queue; once every queue is empty it re-executes the
   longest-running job whose elapsed time exceeds
   ``settings.speculate_threshold`` times the median completed job.  The
   first result wins: every attempt runs inside ``store.attempt()``, the
   winner claims the commit under one lock, and a loser, one that
   finishes after the winner included, raises out of its frame so its
   registrations roll back.  Exactly once, and no budget leaks.

2. **Degrade in place** (collective path): once a rank's step-entry
   lateness stays at or above ``speculate_threshold`` times the other
   ranks' mean (plus a 20 ms jitter floor) for
   ``settings.speculate_after_steps`` consecutive windows, the controller
   skips the following exchange windows.  Every rank holds every blob
   (the ``gather`` variant), so a skipped window delivers its input as it
   is: exact by construction.  Every ``settings.mitigate_probe_windows``
   skipped windows one runs through the mesh as a probe; after
   ``speculate_after_steps`` healthy probes the mitigation disengages.

3. **Sticky down-weight**: a rank pathological for twice the engage
   count (or whose shared transient-fault rate stays high) gets its
   partition share down-weighted for the rest of the run
   (:meth:`MitigationController.route_table`), recorded as a
   ``mitigation`` event in the faults sidecar and the plan report.

Every rank runs the controller over the same shared observations, so the
skip and route decisions agree fleet-wide: a collective that one rank
skips and another enters would hang.  Local counters (steals,
speculation) never feed routing.  Off (the default), every site is one
None-check.
"""

import collections
import contextlib
import logging
import threading
import time

from .. import faults as _faults
from .. import settings
from ..obs import log as _obslog
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs.fleet import straggler_of

log = logging.getLogger("dampr_tpu_torch.parallel.mitigate")

#: Entry spreads under this many seconds never count as pathological:
#: scheduler jitter on a healthy fleet routinely spreads entries by a
#: few milliseconds, and acting on noise would flap the collective path.
MIN_SPREAD_S = 0.02

#: Floor on the elapsed time before a job becomes a speculation
#: candidate — sub-50ms jobs re-execute for less than the dispatch cost.
SPEC_FLOOR_S = 0.05

#: Slots per device in the weighted routing table (weight resolution:
#: a 0.25 down-weight maps to 2 of 8 slots).
_ROUTE_SLOTS = 8

#: Per-window fault bar: a rank that absorbed at least this many NEW
#: transient retries since the previous observation (the shared counts
#: are cumulative; the controller differences them) counts as
#: pathological even when its entries are not late yet.  A rank whose
#: retries STOP goes healthy again — an old burst must never pin a
#: recovered rank bad forever.
_FAULT_FACTOR = 2


class MitigationController(object):
    """One run's mitigation state machine + counters.

    Split-brain discipline: everything that can influence a COLLECTIVE
    decision (``engaged``, the probe counter, ``downweights``) is driven
    only by :meth:`observe_window`, whose inputs are identical on every
    rank (they crossed the mesh).  Steal/speculation counters are
    local-only and never feed back into routing.
    """

    def __init__(self, run_name=None, threshold=None, after=None,
                 probe_every=None, skip_safe=None):
        self.run = run_name
        self.threshold = (settings.speculate_threshold
                          if threshold is None else float(threshold))
        self.after = max(1, int(settings.speculate_after_steps
                                if after is None else after))
        self.probe_every = (settings.mitigate_probe_windows
                            if probe_every is None else int(probe_every))
        # Skipping collective windows is only safe under a BOUNDED
        # collective regime: should controller state ever diverge
        # across ranks (a one-sided share failure), a skipped-vs-entered
        # window must end in the exchange watchdog's bounded abort, not
        # an unbounded gloo hang.  So the degrade-in-place action is
        # gated on settings.exchange_timeout_ms being armed; stealing,
        # speculation, and down-weight routing (whose divergence fails
        # loudly at the unpack assert, never silently) stay available
        # either way.
        self.skip_safe = (settings.exchange_timeout_ms > 0
                          if skip_safe is None else bool(skip_safe))
        self._warned_unsafe_skip = False
        self._lock = threading.RLock()
        # -- shared-observation state (identical on every rank) --------
        self.observations = 0
        self.engaged = False
        self.straggler = None
        self.last_late_ratio = 1.0
        self._consec_late = {}
        self._consec_healthy = 0
        self._skip_counter = 0
        self.windows_skipped = 0
        self.engagements = 0
        self.disengagements = 0
        self.downweights = {}  # rank -> weight in (0, 1), sticky
        self._route_cache = None
        self._last_fault_counts = {}  # rank -> cumulative count seen
        # -- local-only counters (never routing inputs) ----------------
        self.stolen_partitions = 0
        self.speculative_attempts = 0
        self.speculative_wins = 0
        self.speculation_declined = []  # [{stage, evidence}] from analyze
        self.local_retries = 0
        self.events = []  # compact engage/disengage/downweight trail

    # -- live skew ingestion -------------------------------------------------
    def observe_window(self, lateness_by_rank, fault_counts=None):
        """Fold one collective window's shared observation into the
        state machine.  ``lateness_by_rank``: {rank: seconds after the
        first arriver's step entry} (the per-window form of what
        ``fleet.step_skew`` averages post-hoc).  ``fault_counts``:
        {rank: CUMULATIVE transient retries} shared on the same
        collective — differenced here, so only a rank still absorbing
        retries counts as pathological (a burst that ended must not pin
        a recovered rank bad forever).
        """
        with self._lock:
            self.observations += 1
            lateness = dict(lateness_by_rank or {})
            straggler, ratio = straggler_of(lateness)
            spread = (max(lateness.values()) - min(lateness.values())
                      if len(lateness) > 1 else 0.0)
            self.last_late_ratio = round(ratio, 3)
            # Pathological test: the straggler's lateness against the
            # OTHER ranks' mean plus the jitter floor.  Deliberately NOT
            # ``ratio >= threshold``: late_ratio (lateness over the
            # fleet mean INCLUDING the straggler) saturates at the rank
            # count — on a 2-rank fleet it is 2.0 for ANY nonzero
            # spread, so thresholding it would make the knob
            # non-functional there (threshold > 2 could never engage,
            # threshold <= 2 would engage on any 20 ms of jitter).
            # Against the others-mean + floor, the threshold scales a
            # real bar at every fleet size: default 1.5 ~= "more than
            # 1.5x the fleet's typical entry spread late, repeatedly".
            pathological = False
            if straggler is not None and spread >= MIN_SPREAD_S:
                others = [v for r, v in lateness.items()
                          if r != straggler]
                baseline = ((sum(others) / len(others) if others else 0.0)
                            + MIN_SPREAD_S)
                pathological = (lateness[straggler]
                                >= self.threshold * baseline)
            deltas = {}
            for r, c in (fault_counts or {}).items():
                last = self._last_fault_counts.get(r, 0)
                deltas[r] = max(0, c - last)
                self._last_fault_counts[r] = max(last, c)
            fault_ranks = sorted(r for r, d in deltas.items()
                                 if d >= _FAULT_FACTOR)
            bad = set(fault_ranks)
            if pathological:
                bad.add(straggler)
                self.straggler = straggler
            ranks_seen = set(lateness) | set(fault_counts or {})
            for r in ranks_seen:
                if r in bad:
                    self._consec_late[r] = self._consec_late.get(r, 0) + 1
                else:
                    self._consec_late[r] = 0
            if _metrics.enabled():
                _metrics.counter_add("mitigation.windows_observed", 1)
                _metrics.gauge_set("mitigation.late_ratio",
                                   round(ratio, 3))
            if bad:
                self._consec_healthy = 0
                worst = (straggler if pathological
                         else (fault_ranks[0] if fault_ranks else None))
                for r in sorted(bad):
                    n = self._consec_late.get(r, 0)
                    if not self.engaged and n >= self.after:
                        self._engage_locked(r, ratio)
                    if (n >= self.after * 2
                            and r not in self.downweights):
                        self._downweight_locked(r, ratio)
                if worst is not None:
                    self.straggler = worst
            elif self.engaged:
                self._consec_healthy += 1
                if self._consec_healthy >= self.after:
                    self._disengage_locked()

    def _event_locked(self, action, rank=None, **fields):
        ev = {"action": action, "observation": self.observations}
        if rank is not None:
            ev["rank"] = rank
        ev.update(fields)
        self.events.append(ev)
        _trace.instant("mitigation", action,
                       rank=rank if rank is not None else -1, **fields)
        if _metrics.enabled():
            _metrics.counter_add("mitigation.{}".format(action), 1)
        if self.run:
            # The faults sidecar is the cross-run memory: the doctor and
            # the next run's operator see WHAT the engine did about the
            # skew, not just that skew existed.
            _faults.record_event(self.run, "mitigation", action=action,
                                 rank=rank, **fields)

    def _engage_locked(self, rank, ratio):
        self.engaged = True
        self.engagements += 1
        self._consec_healthy = 0
        self._event_locked("engage", rank=rank,
                           late_ratio=round(ratio, 2))
        _obslog.warn(
            "mitigation-engaged",
            "mitigation ENGAGED: rank %s enters collective steps %.2fx "
            "later than the fleet average for %d consecutive windows — "
            "degrading collective exchanges in place (probe every %s "
            "skipped windows)", rank, ratio, self.after,
            self.probe_every or "-", logger=log, straggler=rank,
            late_ratio=round(ratio, 2))

    def _disengage_locked(self):
        self.engaged = False
        self.disengagements += 1
        self._skip_counter = 0
        self._consec_healthy = 0
        self._event_locked("disengage")
        _obslog.warn(
            "mitigation-disengaged",
            "mitigation DISENGAGED: %d consecutive healthy probe "
            "window(s) — collective exchanges resume", self.after,
            logger=log)

    def _downweight_locked(self, rank, ratio):
        w = max(0.25, min(0.75, 1.0 / ratio if ratio > 1.0 else 0.5))
        self.downweights[rank] = round(w, 2)
        self._route_cache = None
        self._event_locked("downweight", rank=rank, weight=round(w, 2),
                           late_ratio=round(ratio, 2))
        _obslog.warn(
            "mitigation-downweight",
            "mitigation: rank %s stays pathological — partition share "
            "down-weighted to %.2f for the remainder of the run",
            rank, w, logger=log, straggler=rank, weight=round(w, 2))

    def note_local_retry(self):
        """One transient retry absorbed on THIS rank (shared with the
        fleet on the next window's piggyback collective)."""
        with self._lock:
            self.local_retries += 1

    def local_fault_count(self):
        with self._lock:
            return self.local_retries

    # -- collective-path actions ---------------------------------------------
    def use_collective(self):
        """Should the next exchange window actually cross the mesh?
        True while disengaged (and on probe windows); False = skip (the
        degrade-in-place action).  Deterministic from shared state, so
        every rank answers identically — the invariant that keeps a
        skipped collective from hanging the ranks that would enter it."""
        with self._lock:
            if not self.engaged:
                return True
            if not self.skip_safe:
                if not self._warned_unsafe_skip:
                    self._warned_unsafe_skip = True
                    _obslog.warn(
                        "mitigation-unsafe-skip",
                        "mitigation engaged but degrade-in-place is "
                        "DISABLED: settings.exchange_timeout_ms is 0, "
                        "so a skipped collective could hang unboundedly "
                        "if rank state ever diverged — arm the exchange "
                        "watchdog to enable window skipping (stealing/"
                        "speculation/down-weighting stay active)",
                        logger=log)
                return True
            self._skip_counter += 1
            if (self.probe_every > 0
                    and self._skip_counter % self.probe_every == 0):
                return True  # probe: re-measure skew through the mesh
            self.windows_skipped += 1
            if _metrics.enabled():
                _metrics.counter_add("mitigation.windows_skipped", 1)
            return False

    def collective_fold_ok(self):
        """Gate for the keyed-fold collective fast path: while the
        mitigation is engaged the fold runs host-side (the collective
        would re-serialize the fleet on the straggler).  Same
        bounded-collective gate as :meth:`use_collective` — declining a
        collective one-sidedly must be watchdog-recoverable."""
        with self._lock:
            return not (self.engaged and self.skip_safe)

    def route_table(self, n_dev, num_processes):
        """Weighted pid -> device routing table, or None when no rank is
        down-weighted (callers keep the ``pid % D`` default).  A rank
        with weight w contributes ``round(w * 8)`` of its 8 per-device
        slots; slots interleave across devices so consecutive pids still
        spread.  Deterministic from (sticky) shared state."""
        with self._lock:
            if not self.downweights:
                return None
            key = (n_dev, num_processes,
                   tuple(sorted(self.downweights.items())))
            if self._route_cache and self._route_cache[0] == key:
                return self._route_cache[1]
            from ..obs.fleet import _rank_of_device

            slots = []
            for d in range(n_dev):
                w = self.downweights.get(
                    _rank_of_device(d, num_processes, n_dev), 1.0)
                slots.append(max(1, int(round(w * _ROUTE_SLOTS)))
                             if w > 0 else 0)
            table = [d for s in range(_ROUTE_SLOTS)
                     for d in range(n_dev) if slots[d] > s]
            if not table:
                table = list(range(n_dev))
            self._route_cache = (key, table)
            return table

    # -- host-path counters --------------------------------------------------
    def note_steal(self):
        with self._lock:
            self.stolen_partitions += 1
        _metrics.counter_add("mitigation.stolen_partitions", 1)

    def note_speculation(self, win):
        with self._lock:
            self.speculative_attempts += 1
            if win:
                self.speculative_wins += 1
        _metrics.counter_add("mitigation.speculative_wins" if win
                             else "mitigation.speculative_losses", 1)

    def note_speculation_declined(self, stage, evidence):
        """The static analyzer (:mod:`..analyze`) refused speculative
        re-execution for a stage: its UDFs are evidence-nondeterministic
        and first-result-wins would silently commit whichever answer
        happened to finish first.  Recorded so the doctor/fleet report
        can say WHY a straggler stage saw no speculation."""
        with self._lock:
            rec = {"stage": stage, "evidence": list(evidence)[:3]}
            if rec not in self.speculation_declined:
                self.speculation_declined.append(rec)
        _metrics.counter_add("mitigation.speculation_declined", 1)

    # -- reporting -----------------------------------------------------------
    def summary(self):
        """The ``stats()["mitigation"]`` section (rank 0's copy also
        lands in ``stats()["fleet"]["mitigation"]`` on merged runs)."""
        with self._lock:
            return {
                "enabled": True,
                "engaged": self.engaged,
                "observations": self.observations,
                "engagements": self.engagements,
                "disengagements": self.disengagements,
                "windows_skipped": self.windows_skipped,
                "speculative_attempts": self.speculative_attempts,
                "speculative_wins": self.speculative_wins,
                "speculation_declined": [dict(r) for r in
                                         self.speculation_declined],
                "stolen_partitions": self.stolen_partitions,
                "straggler_rank": self.straggler,
                "last_late_ratio": self.last_late_ratio,
                "downweighted_ranks": {str(r): w for r, w in
                                       sorted(self.downweights.items())},
                "events": list(self.events[-8:]),
            }


# -- module-level lifecycle (mirrors obs.trace) ------------------------------

_active = None


def start(controller):
    global _active
    _active = controller


def stop(controller):
    global _active
    if _active is controller:
        _active = None


def active():
    return _active


def enabled():
    return _active is not None


# -- speculative / work-stealing job dispatch --------------------------------

class _SpeculationLost(Exception):
    """Raised INSIDE a losing attempt's ``store.attempt()`` frame so the
    frame's registrations roll back (the failed attempt's rollback,
    reused for successful but late duplicates)."""


def pool_dispatch(ctl, fn, jobs, n_workers, store=None, speculative=True,
                  spec_fn=None):
    """Run ``jobs`` through ``fn`` on ``n_workers`` threads with
    rank-owned queues, work stealing, and (optionally) speculative
    re-execution of stragglers.  Returns results in job order; the first
    job failure fails the dispatch (pool.map semantics — a failure only
    counts if no other attempt of that job already committed).

    Exactly-once: every attempt executes inside ``store.attempt()``;
    the committed-flag claim happens inside that frame under one lock,
    so of N racing attempts exactly one exits its frame committed and
    every other — even one completing long after the winner — raises
    :class:`_SpeculationLost` and rolls its registrations back.

    ``spec_fn`` (default ``fn``) runs the speculative duplicates — the
    runner passes its pre-metering wrapper here so a duplicate attempt
    never double-counts the one-call-per-job accounting."""
    if spec_fn is None:
        spec_fn = fn
    n = len(jobs)
    results = [None] * n
    committed = [False] * n
    lock = threading.Lock()
    cond = threading.Condition(lock)
    queues = [collections.deque() for _ in range(n_workers)]
    for i in range(n):
        queues[i % n_workers].append(i)
    inflight = {}   # (job index, is_speculative) -> perf_counter start
    spec_done = set()
    durations = []  # completed-attempt wall times (the speculation bar)
    failure = []
    pending_failures = {}  # job -> exception held while a duplicate
    #                        attempt of that job is still in flight

    def _spec_candidate():
        # Under ``lock``.  The longest-running primary attempt whose
        # elapsed time says "straggler": past the threshold multiple of
        # the median completed duration (and the absolute floor).
        if not speculative or not durations:
            return None
        med = sorted(durations)[len(durations) // 2]
        bar = max(SPEC_FLOOR_S, ctl.threshold * med)
        now = time.perf_counter()
        best, best_elapsed = None, bar
        for (i, spec), t0 in inflight.items():
            if spec or committed[i] or i in spec_done:
                continue
            elapsed = now - t0
            if elapsed >= best_elapsed:
                best, best_elapsed = i, elapsed
        return best

    def execute(i, spec):
        t0 = time.perf_counter()
        won = False
        try:
            cm = (store.attempt() if store is not None
                  else contextlib.nullcontext())
            with cm:
                r = (spec_fn if spec else fn)(jobs[i])
                with lock:
                    if committed[i]:
                        raise _SpeculationLost()
                    committed[i] = True
                    results[i] = r
                    won = True
        except _SpeculationLost:
            pass
        except BaseException as e:  # noqa: BLE001 - pool.map semantics
            with lock:
                if not committed[i]:
                    # Held, not yet fatal: a duplicate attempt of this
                    # job may still be running and may commit — a
                    # failure only counts once no attempt of the job
                    # can land a result (checked below, after this
                    # attempt leaves the inflight set).
                    pending_failures.setdefault(i, e)
        finally:
            with lock:
                inflight.pop((i, spec), None)
                if won:
                    durations.append(time.perf_counter() - t0)
                    pending_failures.pop(i, None)
                elif (i in pending_failures and not committed[i]
                        and not any(k[0] == i for k in inflight)):
                    if not failure:
                        failure.append(pending_failures.pop(i))
                cond.notify_all()
        if spec:
            ctl.note_speculation(win=won)

    def worker(wid):
        while True:
            task, spec = None, False
            with lock:
                if failure:
                    return
                if queues[wid]:
                    task = queues[wid].popleft()
                else:
                    victim = max(range(n_workers),
                                 key=lambda w: len(queues[w]))
                    if queues[victim]:
                        # Steal an unstarted partition from the most
                        # backlogged rank-owned queue (tail end: the
                        # owner keeps its cache-warm head).
                        task = queues[victim].pop()
                        ctl.note_steal()
                if task is None:
                    cand = _spec_candidate()
                    if cand is not None:
                        spec_done.add(cand)
                        task, spec = cand, True
                        inflight[(task, True)] = time.perf_counter()
                    else:
                        if not inflight:
                            return
                        cond.wait(timeout=0.05)
                        continue
                else:
                    inflight[(task, False)] = time.perf_counter()
            execute(task, spec)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_workers,
                            thread_name_prefix="dampr-mitigate") as pool:
        list(pool.map(worker, range(n_workers)))
    if failure:
        raise failure[0]
    return results
