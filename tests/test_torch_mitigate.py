"""The straggler mitigation of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_mitigate.py``.  The controller state
machine is driven as a twin: the JAX package's ``MitigationController``
and the port's take the same observation sequences (lateness by rank,
cumulative fault counts) and must give the same decisions
(``use_collective``, ``collective_fold_ok``, ``route_table``), events and
summaries.  ``pool_dispatch`` keeps first-result-wins exactly once over
the port's ``RunStore`` (a loser that finishes after the winner rolls
back), steals from backlogged queues, and the runner's mitigated runs
read back the JAX package's records on the same seeded pipelines.
"""

import json
import operator
import os
import threading
import time

import numpy as np
import pytest

from dampr_tpu import faults as ref_faults
from dampr_tpu import settings as ref_settings
from dampr_tpu.parallel import mitigate as ref_mitigate
from dampr_tpu.obs import fleet as ref_fleet
import dampr_tpu
import dampr_tpu_torch
from dampr_tpu_torch import faults, runner, settings
from dampr_tpu_torch.parallel import mitigate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    names = ("mitigate", "speculate_threshold", "speculate_after_steps",
             "mitigate_probe_windows", "exchange_coding", "mesh_fold",
             "mesh_exchange", "max_processes", "faults", "job_retries",
             "scratch_root", "device", "exchange_timeout_ms")
    saved = {n: getattr(settings, n) for n in names}
    ref_saved = {n: getattr(ref_settings, n) for n in names
                 if n != "device"}
    settings.device = "cpu"
    settings.scratch_root = ref_settings.scratch_root = str(tmp_path)
    yield
    for n, v in saved.items():
        setattr(settings, n, v)
    for n, v in ref_saved.items():
        setattr(ref_settings, n, v)
    faults.clear()
    ref_faults.clear()
    mitigate._active = None
    ref_mitigate._active = None


class Twin(object):
    """The two packages' controllers side by side: every call goes to
    both and must return the same."""

    def __init__(self, **kw):
        kw.setdefault("skip_safe", True)
        self.ref = ref_mitigate.MitigationController(**kw)
        self.port = mitigate.MitigationController(**kw)

    def __getattr__(self, name):
        a, b = getattr(self.ref, name), getattr(self.port, name)
        if not callable(a):
            assert a == b, (name, a, b)
            return b

        def both(*args, **kw):
            ra, rb = a(*args, **kw), b(*args, **kw)
            assert ra == rb, (name, args, ra, rb)
            return rb
        return both

    def check(self):
        assert self.ref.summary() == self.port.summary()
        assert self.ref.events == self.port.events
        assert self.ref.downweights == self.port.downweights


def _twin(threshold=1.5, after=2, probe=3, run=None, skip_safe=True):
    return Twin(run_name=run, threshold=threshold, after=after,
                probe_every=probe, skip_safe=skip_safe)


def _late(rank, seconds, healthy_rank=0):
    return {healthy_rank: 0.0, rank: seconds}


HEALTHY = {0: 0.0, 1: 0.0}


class TestControllerStateMachine:
    def test_engages_after_consecutive_pathological_windows(self):
        t = _twin(after=3)
        for _ in range(2):
            t.observe_window(_late(1, 0.4))
            assert not t.engaged
        t.observe_window(_late(1, 0.4))
        assert t.engaged and t.engagements == 1 and t.straggler == 1
        assert t.last_late_ratio == pytest.approx(2.0)
        t.check()

    def test_jitter_below_spread_floor_never_engages(self):
        t = _twin(after=1)
        for _ in range(10):
            t.observe_window(_late(1, mitigate.MIN_SPREAD_S / 4))
        assert not t.engaged and t.engagements == 0
        t.check()

    def test_interrupted_streak_resets(self):
        t = _twin(after=3)
        for obs in (_late(1, 0.4), _late(1, 0.4), HEALTHY, _late(1, 0.4),
                    _late(1, 0.4)):
            t.observe_window(obs)
        assert not t.engaged
        t.check()

    def test_probe_cadence_and_clean_disengage(self):
        t = _twin(after=2, probe=3)
        for _ in range(2):
            t.observe_window(_late(1, 0.4))
        assert [t.use_collective() for _ in range(6)] == [
            False, False, True, False, False, True]
        assert t.windows_skipped == 4
        t.observe_window(HEALTHY)
        assert t.engaged
        t.observe_window(HEALTHY)
        assert not t.engaged and t.disengagements == 1
        assert all(t.use_collective() for _ in range(4))
        t.check()

    def test_pathological_probe_keeps_it_engaged(self):
        t = _twin(after=2, probe=2)
        for obs in (_late(1, 0.4), _late(1, 0.4), HEALTHY, _late(1, 0.4),
                    HEALTHY):
            t.observe_window(obs)
        assert t.engaged
        t.observe_window(HEALTHY)
        assert not t.engaged
        t.check()

    def test_sticky_downweight_after_double_streak(self):
        t = _twin(after=2)
        for _ in range(4):
            t.observe_window(_late(1, 0.4))
        w = t.port.downweights[1]
        assert 0.25 <= w <= 0.75
        for _ in range(4):
            t.observe_window(HEALTHY)
        assert not t.engaged and t.port.downweights[1] == w
        actions = [e["action"] for e in t.port.events]
        assert (actions.count("engage"), actions.count("downweight"),
                actions.count("disengage")) == (1, 1, 1)
        t.check()

    def test_fault_rate_triggers_downweight_without_lateness(self):
        t = _twin(after=2)
        bar = mitigate._FAULT_FACTOR
        assert bar == ref_mitigate._FAULT_FACTOR
        for w in range(1, 5):
            t.observe_window(HEALTHY, fault_counts={0: 0, 1: bar * w})
        assert 1 in t.port.downweights
        t.check()

    def test_fault_burst_that_ends_goes_healthy_again(self):
        t = _twin(after=2)
        bar = mitigate._FAULT_FACTOR
        for c in (bar, 2 * bar):
            t.observe_window(HEALTHY, fault_counts={1: c})
        assert t.engaged
        for _ in range(2):
            t.observe_window(HEALTHY, fault_counts={1: 2 * bar})
        assert not t.engaged and t.disengagements == 1
        t.check()

    @pytest.mark.parametrize("n_dev,nproc", [(8, 2), (4, 2), (8, 4)])
    def test_route_table_weighted_and_deterministic(self, n_dev, nproc):
        t = _twin(after=1)
        assert t.route_table(n_dev, nproc) is None
        for _ in range(2):
            t.observe_window(_late(1, 0.4))
        table = t.route_table(n_dev, nproc)
        assert table == t.route_table(n_dev, nproc)
        counts = {d: table.count(d) for d in set(table)}
        per = n_dev // nproc
        slow = range(per, 2 * per)  # rank 1's shards
        assert max(counts.get(d, 0) for d in slow) < counts[0]
        assert set(table) == set(range(n_dev))

    def test_skip_requires_armed_watchdog(self):
        settings.exchange_timeout_ms = ref_settings.exchange_timeout_ms = 0
        t = Twin(threshold=1.5, after=1, skip_safe=None)
        assert t.skip_safe is False
        for _ in range(4):
            t.observe_window(_late(1, 0.4))
        assert t.engaged
        assert all(t.use_collective() for _ in range(6))
        assert t.windows_skipped == 0 and t.collective_fold_ok()
        assert 1 in t.port.downweights
        settings.exchange_timeout_ms = ref_settings.exchange_timeout_ms = \
            5000
        armed = Twin(threshold=1.5, after=1, skip_safe=None)
        assert armed.skip_safe is True
        t.check()

    def test_collective_fold_declines_while_engaged(self):
        t = _twin(after=1)
        assert t.collective_fold_ok()
        t.observe_window(_late(1, 0.4))
        assert t.engaged and not t.collective_fold_ok()
        t.check()

    def test_summary_shape(self):
        t = _twin(after=1)
        t.observe_window(_late(1, 0.4))
        t.note_steal()
        t.note_speculation(win=True)
        t.note_speculation(win=False)
        t.note_speculation_declined("s1", ["random.random"])
        s = t.port.summary()
        assert s["enabled"] and s["engaged"]
        assert (s["stolen_partitions"], s["speculative_attempts"],
                s["speculative_wins"], s["straggler_rank"]) == (1, 2, 1, 1)
        assert json.dumps(s)
        t.check()

    def test_random_sequences_equal(self):
        """Seeded random lateness and fault sequences over 2-4 ranks walk
        both state machines through the same decisions."""
        rng = np.random.RandomState(5)
        for trial in range(20):
            nproc = int(rng.choice([2, 3, 4]))
            t = _twin(threshold=float(rng.choice([1.2, 1.5, 2.0])),
                      after=int(rng.randint(1, 4)),
                      probe=int(rng.randint(0, 4)))
            faults_c = {r: 0 for r in range(nproc)}
            for _w in range(30):
                late = {r: float(rng.choice([0.0, 0.005, 0.05, 0.4]))
                        for r in range(nproc)}
                for r in faults_c:
                    faults_c[r] += int(rng.choice([0, 0, 1, 3]))
                t.observe_window(late, fault_counts=dict(faults_c))
                t.use_collective()
                t.collective_fold_ok()
                t.route_table(2 * nproc, nproc)
            t.check()

    def test_events_land_in_faults_sidecar(self):
        t = _twin(after=1, run="mitrun")
        for _ in range(2):
            t.observe_window(_late(1, 0.5))
        evs = faults.load_events("mitrun")
        ref_evs = ref_faults.load_events("mitrun")
        kinds = [(e["kind"], e.get("action")) for e in evs]
        assert ("mitigation", "engage") in kinds
        assert ("mitigation", "downweight") in kinds
        # each package appended its own events to the one sidecar
        assert len(ref_evs) == len(evs)


class TestFirstResultWinsExactlyOnce:
    def _store(self, name):
        from dampr_tpu_torch import storage

        return storage.RunStore(name)

    def test_loser_completing_after_winner_rolls_back(self):
        from dampr_tpu_torch.blocks import Block

        store = self._store("frw")
        release = threading.Event()
        lock = threading.Lock()
        committed = [False]
        winner_refs, loser_rolled = [], []

        def attempt(slow):
            try:
                with store.attempt() as refs:
                    if slow:
                        release.wait(timeout=30)
                    store.register(Block.from_lists(list(range(64)),
                                                    [1] * 64))
                    with lock:
                        if committed[0]:
                            raise mitigate._SpeculationLost()
                        committed[0] = True
                        winner_refs.extend(refs)
            except mitigate._SpeculationLost:
                loser_rolled.append(True)

        t_slow = threading.Thread(target=attempt, args=(True,))
        t_fast = threading.Thread(target=attempt, args=(False,))
        t_slow.start()
        t_fast.start()
        t_fast.join(timeout=30)
        assert committed[0]
        release.set()
        t_slow.join(timeout=30)
        assert loser_rolled == [True] and len(winner_refs) == 1
        assert len(store._resident) == 1
        assert store._resident_bytes == winner_refs[0].nbytes

    def test_speculative_dispatch_exactly_once_end_to_end(self):
        from dampr_tpu_torch.blocks import Block

        store = self._store("frw2")
        ctl = mitigate.MitigationController(threshold=1.5)
        seen = {"n": 0}
        lock = threading.Lock()

        def fn(job):
            with lock:
                seen["n"] += 1
                first = seen["n"] <= 8
            if job == 7 and first:
                time.sleep(1.0)
            store.register(Block.from_lists([job] * 32, [1] * 32))
            return job * 10

        out = mitigate.pool_dispatch(ctl, fn, list(range(8)), 4,
                                     store=store, speculative=True)
        assert out == [j * 10 for j in range(8)]
        assert len(store._resident) == 8

    def test_randomized_exactly_once_property(self):
        from dampr_tpu_torch.blocks import Block

        rng = np.random.RandomState(7)
        for round_i in range(5):
            store = self._store("frwp{}".format(round_i))
            ctl = mitigate.MitigationController(threshold=1.2)
            delays = rng.uniform(0.0, 0.08, size=10)
            delays[rng.randint(0, 10)] = 0.4

            def fn(job, _d=delays, _s=store):
                time.sleep(float(_d[job]))
                _s.register(Block.from_lists([job] * 16, [1] * 16))
                return job

            out = mitigate.pool_dispatch(ctl, fn, list(range(10)), 4,
                                         store=store, speculative=True)
            assert out == list(range(10)), round_i
            assert len(store._resident) == 10, (round_i, ctl.summary())

    def test_primary_failure_with_winning_duplicate_succeeds(self):
        store = self._store("frwpf")
        ctl = mitigate.MitigationController(threshold=1.2)
        attempts = {0: 0}
        lock = threading.Lock()

        def fn(job):
            if job != 0:
                time.sleep(0.02)
                return job
            with lock:
                attempts[0] += 1
                first = attempts[0] == 1
            if first:
                time.sleep(0.4)
                raise OSError("primary died late")
            time.sleep(0.5)
            return 0

        out = mitigate.pool_dispatch(ctl, fn, list(range(6)), 3,
                                     store=store, speculative=True)
        assert out == list(range(6))
        assert ctl.speculative_wins >= 1, ctl.summary()

    def test_job_failure_still_fails_dispatch(self):
        store = self._store("frwf")
        ctl = mitigate.MitigationController()

        def fn(job):
            if job == 3:
                raise ValueError("boom")
            return job

        with pytest.raises(ValueError):
            mitigate.pool_dispatch(ctl, fn, list(range(6)), 3,
                                   store=store, speculative=True)


class TestWorkStealing:
    def test_idle_workers_steal_from_backlogged_queue(self):
        ctl = mitigate.MitigationController()

        def fn(job):
            if job in (0, 2, 4, 6):  # dealt to worker 0 of 2
                time.sleep(0.15)
            return job

        t0 = time.perf_counter()
        out = mitigate.pool_dispatch(ctl, fn, list(range(8)), 2,
                                     store=None, speculative=False)
        assert out == list(range(8))
        assert ctl.stolen_partitions >= 1
        assert time.perf_counter() - t0 < 0.6


def _records(em):
    return sorted(map(repr, em.read()))


class TestEngineEndToEnd:
    def test_disabled_path_pin(self):
        assert not settings.mitigate_enabled()
        em = (dampr_tpu_torch.Dampr.memory(
            [(i % 5, i) for i in range(500)], partitions=4)
              .group_by(lambda x: x[0])
              .reduce(lambda k, vs: len(list(vs))).run(name="mit-off"))
        assert mitigate.active() is None
        assert "mitigation" not in em.stats()
        em.delete()

    def test_mitigated_run_equals_jax(self):
        settings.max_processes = ref_settings.max_processes = 4
        data = [((i * 7919) % 101, i) for i in range(4000)]

        def pipe(D):
            return (D.memory(data, partitions=8)
                    .map(lambda x: (x[0], x[1] * 3))
                    .group_by(lambda x: x[0])
                    .reduce(lambda k, vs: sorted(v[1] for v in vs)[:3]))

        ref_settings.mitigate = settings.mitigate = "on"
        ref_em = pipe(dampr_tpu.Dampr).run(name="mit-ref")
        em = pipe(dampr_tpu_torch.Dampr).run(name="mit-on")
        assert _records(em) == _records(ref_em)
        s, rs = em.stats(), ref_em.stats()
        assert s["mitigation"]["enabled"]
        # the shared state agrees; steals are local and timing-dependent
        shared = ("engagements", "disengagements", "windows_skipped",
                  "downweighted_ranks")
        assert ({k: s["plan"]["mitigation"][k] for k in shared}
                == {k: rs["plan"]["mitigation"][k] for k in shared})
        assert set(s["plan"]["mitigation"]) == set(rs["plan"]["mitigation"])
        assert set(s["mitigation"]) == set(rs["mitigation"])
        em.delete()
        ref_em.delete()

    def test_speculative_win_on_injected_straggler_job(self):
        """One map job stalls 1.2 s (the fault grammar's ``udf`` site);
        an idle worker re-executes it and wins, and the records equal
        the JAX package's uninjected run."""
        settings.max_processes = 4
        data = [(i % 16, i) for i in range(8000)]

        def pipe(D):
            return (D.memory(data, partitions=4)
                    .map(lambda x: (x[0], x[1] + 1))
                    .group_by(lambda x: x[0])
                    .reduce(lambda k, vs: sum(v[1] for v in vs)))

        base = sorted(pipe(dampr_tpu.Dampr).run(name="spec-ref").read())
        settings.mitigate = "on"
        settings.speculate_threshold = 1.5
        settings.faults = "udf:nth=1,sleep_ms=1200"
        em = pipe(dampr_tpu_torch.Dampr).run(name="spec-on")
        assert sorted(em.read()) == base
        mit = em.stats()["mitigation"]
        assert mit["speculative_attempts"] >= 1, mit
        assert mit["speculative_wins"] >= 1, mit
        em.delete()

    def test_speculation_declines_on_nondet_udf(self):
        """The analyzer's runner hook: a stage with a nondeterministic
        UDF is never speculated, and the controller records why."""
        import random

        settings.mitigate = "on"
        settings.max_processes = 4
        em = (dampr_tpu_torch.Dampr.memory(list(range(2000)), partitions=4)
              .map(lambda x: (x % 7, x + random.random() * 0))
              .group_by(lambda x: x[0])
              .reduce(lambda k, vs: len(list(vs)))
              .run(name="spec-nondet"))
        assert sorted(em.read()) == sorted(
            (k, len([x for x in range(2000) if x % 7 == k]))
            for k in range(7))
        declined = em.stats()["mitigation"]["speculation_declined"]
        assert declined and declined[0]["evidence"], declined
        em.delete()

    def test_mitigated_mesh_exchange_equals_jax(self, mesh_rig):
        """An armed controller on the 8-shard rig: the byte exchange and
        the mesh fold keep the JAX package's records."""
        settings.mitigate = ref_settings.mitigate = "on"
        settings.mesh_exchange = ref_settings.mesh_exchange = "on"
        data = [(i % 13, i) for i in range(3000)]

        def pipe(D):
            return (D.memory(data, partitions=8).group_by(lambda x: x[0])
                    .reduce(lambda k, vs: sorted(v[1] for v in vs)[:4]))

        ref_em = pipe(dampr_tpu.Dampr).run(name="mx-ref")
        em = pipe(dampr_tpu_torch.Dampr).run(name="mx-on")
        assert _records(em) == _records(ref_em)
        assert em.stats()["mesh"]["exchanges"] >= 1
        em.delete()
        ref_em.delete()

    def test_coded_exchange_byte_exact_and_fewer_bytes(self, mesh_rig):
        settings.mesh_fold = ref_settings.mesh_fold = "off"
        settings.mesh_exchange = ref_settings.mesh_exchange = "on"
        settings.exchange_coding = "camr"
        data = [(i % 50, 1) for i in range(20000)]
        base = sorted(dampr_tpu.Dampr.memory(data, partitions=8).fold_by(
            lambda x: x[0], operator.add, value=lambda x: x[1])
            .run(name="coded-ref").read())
        old = runner.SMALL_STAGE_BYTES
        runner.SMALL_STAGE_BYTES = 1024  # past the tiny fold
        try:
            em = (dampr_tpu_torch.Dampr.memory(data, partitions=8)
                  .fold_by(lambda x: x[0], operator.add,
                           value=lambda x: x[1]).run(name="coded-on"))
        finally:
            runner.SMALL_STAGE_BYTES = old
        assert sorted(em.read()) == base
        cod = em.stats()["mesh"]["exchange"].get("coding")
        assert cod and cod["windows"] >= 1
        assert cod["coded_bytes"] < cod["raw_bytes"]
        em.delete()


@pytest.fixture
def mesh_rig():
    old = settings.mesh_devices
    settings.mesh_devices = "cpu*8"
    yield
    settings.mesh_devices = old


class TestFaultsDurationWindow:
    def test_duration_window_expires(self):
        rule = faults.SiteRule("exchange_step", sleep_ms=1,
                               duration_ms=150, times=None)
        assert rule.should_fire() and rule.should_fire()
        time.sleep(0.2)
        assert not rule.should_fire() and not rule.should_fire()

    def test_duration_parses_and_describes(self):
        spec = "exchange_step:rank=1,sleep_ms=400,every=2,duration_ms=5000"
        r = faults.FaultPlan(spec).rules["exchange_step"]
        assert r.duration_ms == 5000 and r.sleep_ms == 400
        assert r.describe() == ref_faults.FaultPlan(spec).rules[
            "exchange_step"].describe()


class TestSurfaces:
    def test_new_knobs_exist_and_snapshot(self):
        from dampr_tpu_torch.obs import history

        for knob in ("mitigate", "speculate_threshold",
                     "speculate_after_steps", "mitigate_probe_windows",
                     "exchange_coding", "fleet_wait_ms"):
            assert getattr(settings, knob) == getattr(ref_settings, knob)
        snap = history._settings_snapshot()
        assert snap["speculate_threshold"] == settings.speculate_threshold
        assert snap["mitigate"] == "off"

    def test_skew_playbook_names_mitigation_knobs(self):
        from dampr_tpu_torch.obs import doctor

        knobs = [k for k, _e, _p, _w in doctor._PLAYBOOK["skew"]]
        for knob in ("mitigate", "speculate_threshold",
                     "speculate_after_steps", "exchange_coding"):
            assert knob in knobs
        assert not set(knobs) & set(doctor.MESH_KNOBS)

    def test_fleet_section_carries_mitigation(self):
        from dampr_tpu_torch.obs import fleet

        mit = {"enabled": True, "engagements": 1, "windows_skipped": 4,
               "speculative_attempts": 2, "speculative_wins": 1,
               "stolen_partitions": 3}
        ranks = {
            0: {"dir": "/x", "trace": None,
                "stats": {"process": {"num_processes": 2},
                          "wall_seconds": 1.0, "mitigation": mit}},
            1: {"dir": "/y", "trace": None,
                "stats": {"process": {"num_processes": 2},
                          "wall_seconds": 2.0, "mitigation": dict(
                              mit, stolen_partitions=2)}},
        }
        kw = dict(shifts={0: 0.0, 1: 0.0}, alignment="clock")
        section = fleet.fleet_section(ranks, **kw)
        assert section == ref_fleet.fleet_section(ranks, **kw)
        assert section["mitigation"]["stolen_partitions"] == 5

    def test_straggler_of_matches_reference(self):
        from dampr_tpu_torch.obs import fleet

        for lat in ({0: 0.0, 1: 0.4}, {}, {0: 0.0, 1: 0.0},
                    {0: 0.1, 1: 0.3, 2: 0.0}):
            assert fleet.straggler_of(lat) == ref_fleet.straggler_of(lat)

    def test_event_codes_are_the_reference_codes(self):
        from dampr_tpu.obs import log as ref_log
        from dampr_tpu_torch.obs import log

        for code in ("mitigation-engaged", "mitigation-disengaged",
                     "mitigation-downweight", "mitigation-unsafe-skip"):
            assert log.EVENT_CODES[code] == ref_log.EVENT_CODES[code]
